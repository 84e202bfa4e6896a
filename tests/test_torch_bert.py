"""CPU twins of the port's BERT slice: the layer twins
(`paddle_tpu_torch.nn`: Linear, LayerNorm, Embedding, MultiHeadAttention,
TransformerEncoderLayer, TransformerEncoder) and `models.bert` (Bert,
its pretraining loss on padded batches, `build_train_step`, AdamW steps,
`create_mlm_batch`, ErnieConfig), each held to the JAX package's
counterpart on the same weights (carried over by name: the port's
`named_parameters()` spell the reference's `functional_state()` keys) and
the same numpy inputs.

The reference runs on the CPU, so its attention takes the XLA path
(`_xla_attention`; with a padding mask the port takes the per-key-bias
flash path, its plain versions here). Tolerances: layer outputs atol
1e-5; BERT's seq and pooled atol 1e-4; losses rtol 1e-5; gradients
within 1e-4 of each one's largest magnitude, with an absolute floor of
1e-7 (the k_proj biases' exact gradient is zero — softmax is
shift-invariant — so both sides report rounding noise ~1e-9 there);
parameters after n AdamW steps atol 2 * lr * n (see test_torch_train.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.autograd import functional_trace
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import bert as tb

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port's layers build on the default device, the card; these
    twins build them on the CPU."""
    from paddle_tpu_torch.device import device_guard
    with device_guard("cpu"):
        yield

B, S = 3, 40
LENS = [40, 23, 9]


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(port, ref_layer):
    """Copy the reference layer's parameters into the port module by name
    (strict: the names must match exactly)."""
    params, _ = ref_layer.functional_state()
    port.load_state_dict({k: _t(v) for k, v in params.items()})
    return port


def _ref(fn, *args):
    """A reference layer call on numpy inputs -> numpy."""
    out = fn(*[paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
               for a in args])
    if isinstance(out, tuple):
        return tuple(np.asarray(o._value) if hasattr(o, "_value") else o
                     for o in out)
    return np.asarray(out._value)


def _close(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pad_mask(lens, s):
    return (np.arange(s)[None, :] < np.asarray(lens)[:, None])


# ---- layer twins ------------------------------------------------------------

def test_linear_matches_reference():
    from paddle_tpu.nn import Linear

    paddle.seed(1)
    ref = Linear(8, 5)
    port = _load(tnn.Linear(8, 5), ref)
    x = _x(3, 4, 8)
    _close(port(_t(x)), _ref(ref, x))


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_matches_reference(eps):
    from paddle_tpu.nn import LayerNorm

    ref = LayerNorm(16, epsilon=eps)
    port = _load(tnn.LayerNorm(16, epsilon=eps), ref)
    with torch.no_grad():
        port.weight.uniform_(0.5, 1.5)
        port.bias.uniform_(-0.5, 0.5)
    ref.load_functional_state({k: jnp.asarray(v.detach().numpy())
                               for k, v in port.named_parameters()}, None)
    x = _x(2, 5, 16)
    _close(port(_t(x)), _ref(ref, x))


@pytest.mark.parametrize("padding_idx", [None, 2, -1])
def test_embedding_matches_reference(padding_idx):
    from paddle_tpu.nn import Embedding

    paddle.seed(2)
    ref = Embedding(10, 6, padding_idx=padding_idx)
    port = _load(tnn.Embedding(10, 6, padding_idx=padding_idx), ref)
    ids = np.array([[0, 2, 9], [9, 1, 2]], np.int32)
    _close(port(_t(ids)), _ref(ref, ids))
    if padding_idx is not None:
        fresh = tnn.Embedding(10, 6, padding_idx=padding_idx)
        assert (fresh.weight[padding_idx] == 0).all()


@pytest.mark.parametrize("variant", ["bool_mask", "weights", "cache",
                                     "static_cache"])
def test_multi_head_attention_matches_reference(variant):
    from paddle_tpu.nn import MultiHeadAttention

    paddle.seed(3)
    E, H = 32, 4
    ref = MultiHeadAttention(E, H, need_weights=variant == "weights")
    port = _load(tnn.MultiHeadAttention(
        E, H, need_weights=variant == "weights"), ref)
    ref.eval()
    port.eval()
    x, mem = _x(2, 7, E), _x(2, 5, E, seed=1)
    if variant == "bool_mask":
        m = _pad_mask([7, 4], 7)[:, None, None, :]
        _close(port(_t(x), attn_mask=_t(m)), _ref(ref, x, None, None, m))
    elif variant == "weights":
        out, w = port(_t(x))
        out_r, w_r = _ref(ref, x)
        _close(out, out_r)
        _close(w, w_r)
    elif variant == "cache":
        cache = port.gen_cache(_t(x))
        ref_cache = ref.gen_cache(paddle.to_tensor(x))
        for step in range(3):  # one token at a time against a growing cache
            xs = x[:, step:step + 1]
            out, cache = port(_t(xs), cache=cache)
            out_r, ref_cache = ref(paddle.to_tensor(xs), None, None, None,
                                   ref_cache)
            _close(out, np.asarray(out_r._value))
        assert cache.k.shape == (2, H, 3, E // H)
    else:
        sc = port.gen_cache(_t(mem), type=tnn.MultiHeadAttention.StaticCache)
        rsc = ref.gen_cache(paddle.to_tensor(mem),
                            type=MultiHeadAttention.StaticCache)
        out, _ = port(_t(x), cache=sc)
        out_r, _ = ref(paddle.to_tensor(x), None, None, None, rsc)
        _close(out, np.asarray(out_r._value))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_layer_matches_reference(normalize_before):
    from paddle_tpu.nn import TransformerEncoderLayer

    paddle.seed(4)
    ref = TransformerEncoderLayer(32, 4, 64, dropout=0.0, activation="gelu",
                                  normalize_before=normalize_before)
    port = _load(tnn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu",
        normalize_before=normalize_before), ref)
    x = _x(2, 9, 32)
    mask = ((1.0 - _pad_mask([9, 5], 9)) * -1e30).astype(
        np.float32)[:, None, None, :]
    _close(port(_t(x), _t(mask)), _ref(ref, x, mask))


def test_encoder_matches_reference_and_clones_its_first_layer():
    from paddle_tpu.nn import (LayerNorm, TransformerEncoder,
                               TransformerEncoderLayer)

    paddle.seed(5)
    ref = TransformerEncoder(TransformerEncoderLayer(32, 4, 64, dropout=0.0),
                             3, LayerNorm(32))
    port = _load(tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0), 3,
        tnn.LayerNorm(32)), ref)
    x = _x(2, 6, 32)
    _close(port(_t(x)), _ref(ref, x))
    fresh = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(32, 4, 64), 3)
    a, b = fresh.layers[0], fresh.layers[2]
    assert all(torch.equal(p, q) and p is not q
               for p, q in zip(a.parameters(), b.parameters()))


def test_convert_attention_mask():
    from paddle_tpu_torch.nn.layer.transformer import _convert_attention_mask

    m = torch.tensor([[True, False]])
    out = _convert_attention_mask(m, torch.float32)
    assert torch.equal(out, torch.tensor([[0.0, -1e30]]))
    f = torch.zeros(1, 2)
    assert _convert_attention_mask(f, torch.float32) is f


def test_dropout_layer_draws_from_its_generator():
    x = torch.ones(4, 64)
    d = tnn.Dropout(0.25, generator=torch.Generator().manual_seed(0))
    a = d(x)
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(a, d(x))
    assert torch.isin(a, torch.tensor([0.0, 1 / 0.75])).all()
    row = tnn.Dropout(0.5, axis=0)(x)  # one draw per row
    assert all(len(r.unique()) == 1 for r in row)
    d.eval()
    assert d(x) is x
    assert torch.equal(tnn.Dropout(0.25, mode="downscale_in_infer")
                       .eval()(x), x * 0.75)


# ---- BERT --------------------------------------------------------------------

def _reference_bert(seed=0):
    """(reference Bert tiny in eval mode, numpy params, the port's Bert
    with the same weights, its config)."""
    from paddle_tpu.models.bert import Bert, BertConfig

    paddle.seed(seed)
    cfg = BertConfig.tiny()
    cfg.dropout = 0.0
    ref = Bert(cfg)
    ref.eval()
    params, _ = ref.functional_state()
    params = {k: np.asarray(v) for k, v in params.items()}
    tcfg = tb.BertConfig.tiny()
    tcfg.dropout = 0.0
    port = tb.from_reference_params(tcfg, params, device="cpu")
    port.eval()
    return ref, params, port, tcfg


def _padded_batch(cfg, seed=0):
    """Padded ids (pad 0) with token types 0 then 1, the attention mask,
    MLM-masked ids and labels, NSP labels."""
    rs = np.random.RandomState(seed)
    am = _pad_mask(LENS, S).astype(np.int32)
    ids = rs.randint(1, cfg.vocab_size, (B, S)).astype(np.int32) * am
    tt = np.broadcast_to((np.arange(S) >= S // 2).astype(np.int32),
                         (B, S)).copy()
    masked, labels = tb.create_mlm_batch(ids, cfg.vocab_size, 3, seed=seed)
    nsp = rs.randint(0, 2, (B,)).astype(np.int32)
    return masked.astype(np.int32), labels.astype(np.int32), nsp, tt, am


def _ref_loss_fn(ref):
    """A jitted value_and_grad of the reference's pretraining_loss over
    its params, passing the padding mask (its build_train_step does not)."""
    def loss(params, ids, labels, nsp, tt, am):
        saved = ref.functional_state()
        ref.load_functional_state(params, None)
        try:
            with functional_trace():
                out = ref.pretraining_loss(Tensor(ids), Tensor(labels),
                                           Tensor(nsp), Tensor(tt),
                                           Tensor(am))
            return out._value
        finally:
            ref.load_functional_state(*saved)

    return jax.jit(jax.value_and_grad(loss))


def _grads_close(grads, grads_r):
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        r = np.asarray(grads_r[name])
        tol = max(1e-4 * np.abs(r).max(), 1e-7)
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def test_parameter_names_are_the_references():
    ref, params, port, cfg = _reference_bert()
    names = dict(port.named_parameters())
    assert set(names) == set(params) == set(tb.param_shapes(cfg))
    assert len(names) == 46
    for n, p in names.items():
        assert tuple(p.shape) == params[n].shape, n
    fresh = tb.Bert(cfg, device="cpu")  # identical layers at init
    l0, l1 = fresh.encoder.layers
    assert all(torch.equal(a, b) for a, b in zip(l0.parameters(),
                                                 l1.parameters()))


def test_from_reference_params_rejects_mismatches():
    _ref_model, params, _port, cfg = _reference_bert()
    bad = dict(params)
    bad.pop("nsp.bias")
    with pytest.raises(ValueError, match="missing"):
        tb.from_reference_params(cfg, bad, device="cpu")
    bad = dict(params, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        tb.from_reference_params(cfg, bad, device="cpu")
    bad = dict(params, **{"nsp.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tb.from_reference_params(cfg, bad, device="cpu")


def test_seq_and_pooled_match_reference_with_padding_mask():
    ref, _params, port, cfg = _reference_bert(1)
    ids, _labels, _nsp, tt, am = _padded_batch(cfg, 1)
    with functional_trace():
        seq_r, pooled_r = ref(Tensor(ids), Tensor(tt), Tensor(am))
    seq, pooled = port(_t(ids), _t(tt), _t(am))
    _close(seq, seq_r._value, 1e-4)
    _close(pooled, pooled_r._value, 1e-4)


def test_pretraining_loss_and_every_gradient_match_reference():
    ref, params, port, cfg = _reference_bert(2)
    batch = _padded_batch(cfg, 2)
    loss_r, grads_r = _ref_loss_fn(ref)(
        {k: jnp.asarray(v) for k, v in params.items()}, *batch)
    loss = port.pretraining_loss(*map(_t, batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
    _grads_close({n: p.grad for n, p in port.named_parameters()}, grads_r)


def test_mlm_only_loss_matches_reference():
    """No NSP labels: the MLM loss alone."""
    ref, _params, port, cfg = _reference_bert(3)
    ids, labels, _nsp, tt, am = _padded_batch(cfg, 3)
    with functional_trace():
        loss_r = ref.pretraining_loss(Tensor(ids), Tensor(labels), None,
                                      Tensor(tt), Tensor(am))
    loss = port.pretraining_loss(_t(ids), _t(labels), None, _t(tt), _t(am))
    np.testing.assert_allclose(loss.item(), float(loss_r._value), rtol=1e-5)


def test_build_train_step_matches_reference():
    """The reference's functional step (no mask, no NSP), on its own
    init_params(), against the port's loss_fn on the same weights."""
    from paddle_tpu.models.bert import BertConfig, build_train_step

    cfg = BertConfig.tiny()
    cfg.dropout = 0.0
    loss_fn_r, init_r, _model = build_train_step(cfg)
    params = {k: np.asarray(v) for k, v in init_r().items()}
    tcfg = tb.BertConfig.tiny()
    tcfg.dropout = 0.0
    loss_fn, init_params, model = tb.build_train_step(tcfg, device="cpu")
    assert set(init_params()) == set(params)
    ids, labels = _padded_batch(tcfg, 4)[:2]
    loss_r, grads_r = jax.jit(jax.value_and_grad(loss_fn_r))(
        params, {"input_ids": jnp.asarray(ids),
                 "labels": jnp.asarray(labels)}, jax.random.key(0))
    tparams = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(tparams, {"input_ids": _t(ids), "labels": _t(labels)})
    # pooler and nsp take no part in the MLM-only loss: zero gradients,
    # as jax.grad reports them
    grads = torch.autograd.grad(loss, list(tparams.values()),
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
    _grads_close(dict(zip(tparams, grads)), grads_r)


def test_two_adamw_steps_match_reference():
    from paddle_tpu.optimizer import AdamW as RefAdamW

    from paddle_tpu_torch.optimizer import AdamW

    lr, steps = 1e-3, 2
    ref, params, port, cfg = _reference_bert(5)
    vg = _ref_loss_fn(ref)
    ropt = RefAdamW(learning_rate=lr, weight_decay=0.01)
    rparams = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = ropt.functional_init(rparams)
    opt = AdamW(lr, weight_decay=0.01, device="cpu")
    tparams = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    state = opt.functional_init(tparams)
    for step in range(steps):
        batch = _padded_batch(cfg, 10 + step)
        loss_r, grads_r = vg(rparams, *batch)
        rparams, rstate = ropt.functional_update(rparams, grads_r, rstate)
        loss = tb.pretraining_loss_with(port, tparams, *map(_t, batch))
        grads = torch.autograd.grad(loss, list(tparams.values()))
        opt.functional_update(tparams, dict(zip(tparams, grads)), state)
        np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-4)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(rparams[name]), rtol=0,
                                   atol=2 * lr * steps, err_msg=name)


def test_train_step_with_dropout_is_reproducible():
    """cfg.dropout 0.1 in training: embedding, residual and attention
    dropout (the dense path) all draw from the step's generator."""
    cfg = tb.BertConfig.tiny()
    loss_fn, init_params, _model = tb.build_train_step(cfg, device="cpu")
    params = init_params()
    ids, labels = (_t(a) for a in _padded_batch(cfg, 6)[:2])

    def loss(seed):
        return loss_fn(params, {"input_ids": ids, "labels": labels},
                       torch.Generator().manual_seed(seed)).item()

    assert loss(0) == loss(0) != loss(1)


@pytest.mark.parametrize("mode", ["token", "span"])
def test_create_mlm_batch_is_bit_identical(mode):
    from paddle_tpu.models.bert import create_mlm_batch

    ids = np.random.RandomState(0).randint(5, 100, (4, 32)).astype(np.int64)
    ids[1, 20:] = 0  # pads are never masked
    ref = create_mlm_batch(ids, 100, 3, mask_prob=0.15, mode=mode, seed=7)
    out = tb.create_mlm_batch(ids, 100, 3, mask_prob=0.15, mode=mode, seed=7)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (out[1][1, 20:] == -100).all()


def test_ernie_large_config():
    from paddle_tpu.models.bert import ErnieConfig

    cfg, ref = tb.ErnieConfig.large(), ErnieConfig.large()
    assert vars(cfg) == vars(ref)
    assert cfg.hidden_size == 1024 and cfg.num_layers == 24
    assert cfg.vocab_size == 18000
    model = tb.Ernie(tb.ErnieConfig.tiny(), device="cpu")
    assert isinstance(model, tb.Bert) and len(model.encoder.layers) == 2
