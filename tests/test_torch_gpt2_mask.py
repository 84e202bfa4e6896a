"""CPU twins of the port's GPT-2 forward with `position_ids` and
`attn_mask` (`paddle_tpu_torch.models.gpt2`: `GPT2.forward`, `logits`,
`hidden_states`), held to the reference's `GPT2.forward(input_ids,
position_ids, attn_mask)` on `GPT2Config.tiny()` with bridged weights:
a padded batch with an additive [B, 1, 1, S] mask (0 for real tokens,
-1e30 for pads) and position ids; the logits, and the loss and every
gradient of a cross-entropy over the real tokens (pad labels -100),
through the fused backward and through the two-pass one. Row 1 is
padded on the right (its position ids shifted by 7) or on the left (its
position ids 0 from its first real token). Only the left padding makes
the mask matter to the loss: a causal row never sees the pads after
it. The logits are compared on the real tokens: a left pad row sees
only pads, and the reference's XLA order (causal fill, then the mask)
lets it weigh the hidden real keys too, which the port does not
(ROADMAP.md §C, fully masked rows).

The reference runs its XLA attention on the CPU (causal fill, then the
mask); the port runs its per-key-bias flash plain versions. Tolerances:
logits rtol/atol 1e-4 (the reference's own forward twin), loss rtol
1e-5, each gradient within 1e-4 of its largest magnitude (the BERT
twins' rule)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops as rops
from paddle_tpu.core.autograd import functional_trace
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch.ops import attention as pa
from paddle_tpu_torch.ops import flash_attention as pf
from paddle_tpu_torch.models import gpt2 as tg
from paddle_tpu_torch.ops.loss import cross_entropy

from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)

B, S = 2, 128
PADS = 48  # row 1's pads; row 0 has none


def _padded_batch(cfg, seed, side="right"):
    """ids, position ids [B, S], the additive mask [B, 1, 1, S], labels
    with -100 at the pads, and the [B, S] real-token flags."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ar = np.arange(S)
    pad = np.zeros((B, S), bool)
    pos = np.broadcast_to(ar, (B, S)).astype(np.int32).copy()
    if side == "right":
        pad[1, S - PADS:] = True
        pos[1] += 7
    else:
        pad[1, :PADS] = True
        pos[1] = np.maximum(ar - PADS, 0)
    mask = np.where(pad, -1e30, 0.0).astype(np.float32)[:, None, None, :]
    labels = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[pad] = -100
    return ids, pos, mask, labels, ~pad


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_loss_fn(model, vocab):
    """A jitted value_and_grad of the reference's masked loss over its
    params: GPT2.forward with position ids and the mask, then
    cross_entropy over the flattened logits."""
    def loss(params, ids, pos, mask, labels):
        saved = model.functional_state()
        model.load_functional_state(params, None)
        try:
            with functional_trace():
                lg = model(Tensor(ids), Tensor(pos), Tensor(mask))
                out = rops.cross_entropy(rops.reshape(lg, [-1, vocab]),
                                         rops.reshape(Tensor(labels), [-1]))
            return out._value
        finally:
            model.load_functional_state(*saved)

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("side", ["right", "left"])
def test_padded_logits_match_reference(side):
    model, cfg, port, _tcfg = reference_tiny_model(4)
    ids, pos, mask, _labels, real = _padded_batch(cfg, 0, side)
    with functional_trace():
        ref = model(Tensor(ids), Tensor(pos), Tensor(mask))._value
    port.eval()
    with torch.no_grad():
        out = port(_t(ids), position_ids=_t(pos), attn_mask=_t(mask))
    assert out.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("two_pass", [False, True], ids=["fused", "two-pass"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_masked_loss_and_every_gradient_match_reference(monkeypatch, side,
                                                        two_pass):
    """The port's logits(..., position_ids=, attn_mask=) with
    cross_entropy, through the fused backward or (the switch forced) the
    two-pass one, against the reference's on the same weights."""
    monkeypatch.setattr(pf, "uses_two_pass", lambda sq, d: two_pass)
    model, cfg, port, tcfg = reference_tiny_model(5)
    ids, pos, mask, labels, _real = _padded_batch(cfg, 1, side)
    params_np = {n: p.detach().numpy() for n, p in port.named_parameters()}
    loss_r, grads_r = _ref_loss_fn(model, cfg.vocab_size)(
        {k: jnp.asarray(v) for k, v in params_np.items()}, ids, pos, mask,
        labels)
    params = {n: _t(v).requires_grad_(True) for n, v in params_np.items()}
    lg = tg.logits(params, tcfg, _t(ids), position_ids=_t(pos),
                   attn_mask=_t(mask))
    loss = cross_entropy(lg.reshape(-1, tcfg.vocab_size),
                         _t(labels).reshape(-1))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        r = np.asarray(grads_r[name])
        tol = max(1e-4 * np.abs(r).max(), 1e-7)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def test_the_mask_reaches_the_bias_flash(monkeypatch):
    """Each layer's attention gets the mask unchanged and sends it to
    `flash_attention_bias`; without a mask, `flash_attention`."""
    calls = []

    def spy(name):
        orig = getattr(pa, name)

        @functools.wraps(orig)
        def fn(*a, **kw):
            calls.append(name)
            return orig(*a, **kw)
        return fn

    for name in ("flash_attention", "flash_attention_bias",
                 "dense_attention"):
        monkeypatch.setattr(pa, name, spy(name))
    _model, cfg, port, tcfg = reference_tiny_model(6)
    ids, pos, mask = _padded_batch(cfg, 2)[:3]
    port.eval()
    with torch.no_grad():
        port(_t(ids), attn_mask=_t(mask))
        assert calls == ["flash_attention_bias"] * tcfg.num_layers
        calls.clear()
        port(_t(ids), position_ids=_t(pos))
        assert calls == ["flash_attention"] * tcfg.num_layers


def test_default_position_ids_are_the_range():
    """No position ids is 0..S-1, given as [S] or as [B, S]."""
    _model, cfg, port, _tcfg = reference_tiny_model(7)
    ids = _padded_batch(cfg, 3)[0]
    port.eval()
    with torch.no_grad():
        a = port(_t(ids))
        b = port(_t(ids), position_ids=torch.arange(S))
        c = port(_t(ids), position_ids=torch.arange(S).repeat(B, 1))
    assert torch.equal(a, b) and torch.equal(a, c)


def test_forward_keeps_generator_as_a_keyword():
    """GPT2.forward(ids, generator=g) draws its dropout from g, as before
    the mask arguments were added."""
    cfg = tg.GPT2Config.tiny()  # dropout 0.1
    model = tg.GPT2(cfg, device="cpu")
    model.train()
    ids = _t(_padded_batch(cfg, 4)[0])
    a = model(ids, generator=torch.Generator().manual_seed(1))
    b = model(ids, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
