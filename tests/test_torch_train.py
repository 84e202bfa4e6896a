"""CPU twins of the port's training slice: GPT-2's functional loss
(`paddle_tpu_torch.models.gpt2.build_train_step`), its gradients, the
AdamW rule (`paddle_tpu_torch.optimizer`) and `cross_entropy`, held to
the JAX package's `build_train_step`, `AdamW.functional_update` and
`ops.cross_entropy` on the same weights and batches.

The reference runs its flash path as tests/test_flash_engagement.py
forces it: `_on_tpu` patched to True and the Pallas kernels in interpret
mode, so both sides go through flash attention (the port's plain K4/K6/K9
on the CPU). Tolerances: loss rtol 1e-5; gradients rtol 2e-3 / atol 2e-4
(the reference flash tests' own); parameters after n AdamW steps atol
2 * lr * n (a near-zero gradient moves a weight by about +-lr whatever
its rounding, so two correct implementations can differ by ~lr a step).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

B, S = 2, 128


def _force_flash(monkeypatch):
    import paddle_tpu.ops.attention as A
    from paddle_tpu.ops.pallas import flash_attention as FA

    orig = FA.flash_attention
    calls = []
    monkeypatch.setattr(A, "_on_tpu", lambda: True)

    @functools.wraps(orig)
    def interpreted(q, k, v, *a, **kw):
        calls.append(1)
        return orig(q, k, v, *a, **kw, interpret=True)

    monkeypatch.setattr(FA, "flash_attention", interpreted)
    return calls


def _batch(seed, vocab):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, S)).astype(np.int32)
    labels = rs.randint(0, vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -100  # ignored rows take part in neither side's mean
    return ids, labels


def _reference_step(monkeypatch):
    """(reference jitted value_and_grad, its numpy params, the port's
    loss_fn, the port's config)."""
    from paddle_tpu.models.gpt2 import GPT2Config, build_train_step

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import \
        build_train_step as port_build_train_step

    calls = _force_flash(monkeypatch)
    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    loss_fn, init_params, _model = build_train_step(cfg)
    params = {k: np.asarray(v) for k, v in init_params().items()}
    tcfg = TConfig.tiny()
    tcfg.dropout = 0.0
    port_loss, _init = port_build_train_step(tcfg, device="cpu")
    vg = jax.jit(jax.value_and_grad(loss_fn))
    return vg, params, port_loss, tcfg, calls


def _port_params(params_np):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in params_np.items()}


def _port_value_and_grad(port_loss, params, ids, labels):
    batch = {"input_ids": torch.from_numpy(ids),
             "labels": torch.from_numpy(labels)}
    loss = port_loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


def test_loss_and_grads_match_reference_flash_train_step(monkeypatch):
    vg, params_np, port_loss, _tcfg, calls = _reference_step(monkeypatch)
    ids, labels = _batch(0, 1024)
    loss_r, grads_r = vg(params_np, {"input_ids": jnp.asarray(ids),
                                     "labels": jnp.asarray(labels)},
                         jax.random.key(0))
    assert calls, "the reference did not take its flash path"
    params = _port_params(params_np)
    loss, grads = _port_value_and_grad(port_loss, params, ids, labels)
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_r[name]),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_three_adamw_steps_match_reference(monkeypatch):
    from paddle_tpu.optimizer import AdamW as RefAdamW

    from paddle_tpu_torch.optimizer import AdamW

    lr, steps = 1e-3, 3
    vg, params_np, port_loss, _tcfg, _calls = _reference_step(monkeypatch)
    ropt = RefAdamW(learning_rate=lr, weight_decay=0.01)
    rparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    rstate = ropt.functional_init(rparams)
    opt = AdamW(lr, weight_decay=0.01, device="cpu")
    params = _port_params(params_np)
    state = opt.functional_init(params)
    for step in range(steps):
        ids, labels = _batch(10 + step, 1024)
        loss_r, grads_r = vg(rparams, {"input_ids": jnp.asarray(ids),
                                       "labels": jnp.asarray(labels)},
                             jax.random.key(0))
        rparams, rstate = ropt.functional_update(rparams, grads_r, rstate)
        loss, grads = _port_value_and_grad(port_loss, params, ids, labels)
        opt.functional_update(params, grads, state)
        np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-4)
    assert state["t"] == steps
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(rparams[name]), rtol=0,
                                   atol=2 * lr * steps, err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "wd_mask"])
def test_adamw_rule_matches_reference(masked):
    """The rule alone on random leaves: bias correction from t = 1,
    decoupled decay of the pre-update p on every leaf unless masked."""
    from paddle_tpu.optimizer import AdamW as RefAdamW

    from paddle_tpu_torch.optimizer import AdamW

    rs = np.random.RandomState(0)
    shapes = {"w": (8, 5), "b": (5,), "ln.weight": (5,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    mask = {"w": True, "b": False, "ln.weight": False} if masked else None
    ropt = RefAdamW(learning_rate=1e-2, weight_decay=0.1)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs_ = ropt.functional_init(rp)
    opt = AdamW(1e-2, weight_decay=0.1, device="cpu")
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = opt.functional_init(tp)
    for _ in range(3):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        rp, rs_ = ropt.functional_update(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rs_,
            wd_mask=mask)
        opt.functional_update(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, st, wd_mask=mask)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_logits_match_reference_forward():
    """The port's GPT2.forward (eval) on the bridged weights against the
    reference model's logits."""
    from torch_twin_util import reference_tiny_model

    import paddle_tpu as paddle

    model, cfg, port, _tcfg = reference_tiny_model(3)
    ids, _labels = _batch(1, cfg.vocab_size)
    ref = np.asarray(model(paddle.to_tensor(ids))._value)
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ignored", [[], [1, 5], list(range(12))],
                         ids=["none", "some", "all"])
def test_cross_entropy_matches_reference(ignored):
    """Mean over the valid rows; an all-ignored batch gives 0."""
    import paddle_tpu.ops as rops

    from paddle_tpu_torch.ops.loss import cross_entropy

    rs = np.random.RandomState(2)
    x = rs.randn(12, 7).astype(np.float32)
    lbl = rs.randint(0, 7, (12,)).astype(np.int32)
    lbl[ignored] = -100
    ref = rops.cross_entropy(jnp.asarray(x), jnp.asarray(lbl))
    ref = np.asarray(getattr(ref, "_value", ref))
    out = cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    if len(ignored) == 12:
        assert out.item() == 0.0


def test_dropout_train_step_runs_through_the_dense_path():
    """GPT-2 at its default dropout 0.1 trains: attention dropout takes
    the dense path (as the reference's, whose kernels take no dropout),
    drawing from the step's generator — one seed gives one loss and
    gradients, another seed another loss."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, build_train_step

    cfg = GPT2Config.tiny()  # dropout 0.1
    loss_fn, init_params = build_train_step(cfg, device="cpu")
    ids = torch.from_numpy(_batch(4, cfg.vocab_size)[0])
    params = init_params()

    def step(seed):
        loss = loss_fn(params, {"input_ids": ids, "labels": ids},
                       torch.Generator().manual_seed(seed))
        return loss, torch.autograd.grad(loss, list(params.values()))

    (a, ga), (b, gb) = step(1), step(1)
    assert torch.isfinite(a) and a.item() == b.item()
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert all(torch.isfinite(g).all() for g in ga)
    assert step(2)[0].item() != a.item()


def test_dropout_draws_from_its_generator():
    from paddle_tpu_torch.models.gpt2 import _dropout

    x = torch.ones(64, 64)
    assert _dropout(x, 0.0, None) is x
    a = _dropout(x, 0.25, torch.Generator().manual_seed(5))
    b = _dropout(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.6 < kept.float().mean().item() < 0.9


def test_module_loss_equals_functional_loss():
    from paddle_tpu_torch.models.gpt2 import (GPT2, GPT2Config,
                                              build_train_step)

    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    loss_fn, init_params = build_train_step(cfg, device="cpu")
    model = GPT2(cfg, device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(2, cfg.vocab_size))
    a = loss_fn(init_params(), {"input_ids": ids, "labels": labels})
    b = model.loss(ids, labels)
    assert torch.equal(a, b)
    b.backward()
    assert all(p.grad is not None for p in model.parameters())
