"""CPU twins of the port's seq2seq slice: the decoder half of
`paddle_tpu_torch.nn` (TransformerDecoderLayer, TransformerDecoder,
Transformer, MultiHeadAttention's caches) and
`paddle_tpu_torch.models.transformer` (TransformerModel: forward, loss
with label smoothing and every gradient, greedy decoding with and without
the cache, beam search), each held to the JAX package's counterpart on
the same weights (carried over by `from_reference_params` or by name)
and the same numpy inputs.

Two model configs: `TransformerConfig.tiny()` (head dim 16: the port
takes the dense attention path, as the reference's XLA path) and the
same with 2 heads (head dim 32: the port's CPU path runs the flash
route's plain versions of K4/K6/K9, the reference still XLA).
Tolerances: layer outputs atol 1e-5; logits and loss within 1e-4 (the
largest differences measured were 1.7e-6 in the logits and 4.8e-7 in the
loss); every gradient within 1e-3 of its largest magnitude, with an
absolute floor of 1e-7 (the k_proj biases' exact gradient is zero, as
softmax is shift-invariant, and both sides report rounding noise of
~1e-8 there; every other gradient agreed within 1e-4 of its magnitude);
greedy and beam tokens identical.

The reference decodes compile each new shape, so its decodes share one
batch (2 x 6 sources), max_len 8 and the beam widths 1 and 4, and each
config's results are computed once (module fixtures).
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
from paddle_tpu_torch.models import transformer as tt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port's layers build on the default device, the card; these
    twins build them on the CPU."""
    from paddle_tpu_torch.device import device_guard
    with device_guard("cpu"):
        yield

MAX_LEN = 8
EOS_BIAS = 2.0  # added to the eos logit's bias: beams finish mid-way


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(port, ref_layer):
    """The reference layer's parameters into the port module, by name
    (strict)."""
    params, _ = ref_layer.functional_state()
    port.load_state_dict({k: _t(v) for k, v in params.items()})
    return port


def _close(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _np(out):
    return np.asarray(out._value if hasattr(out, "_value") else out)


# ---- layers -----------------------------------------------------------------

def _pad_bias(lens, s):
    keep = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    return np.where(keep, 0.0, -1e30).astype(np.float32)[:, None, None, :]


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("d_model,nhead", [(32, 4), (64, 2)],
                         ids=["dh8", "dh32"])
def test_decoder_layer_matches_reference(normalize_before, d_model, nhead):
    """The causal tgt_mask (dense path) and a padding memory_mask (a
    per-key bias: the flash route at Dh 32) through one decoder layer."""
    from paddle_tpu.nn import Transformer, TransformerDecoderLayer

    paddle.seed(6)
    ref = TransformerDecoderLayer(d_model, nhead, 64, dropout=0.0,
                                  activation="gelu",
                                  normalize_before=normalize_before)
    port = _load(tnn.TransformerDecoderLayer(
        d_model, nhead, 64, dropout=0.0, activation="gelu",
        normalize_before=normalize_before), ref)
    tgt, mem = _x(2, 7, d_model), _x(2, 9, d_model, seed=1)
    tmask = _np(Transformer.generate_square_subsequent_mask(None, 7))
    mmask = _pad_bias([9, 5], 9)
    with functional_trace():
        out_r = ref(Tensor(tgt), Tensor(mem), Tensor(tmask), Tensor(mmask))
    _close(port(_t(tgt), _t(mem), _t(tmask), _t(mmask)), _np(out_r))
    with functional_trace():
        out_r = ref(Tensor(tgt), Tensor(mem))
    _close(port(_t(tgt), _t(mem)), _np(out_r))


@pytest.mark.parametrize("d_model,nhead", [(32, 4), (64, 2)],
                         ids=["dh8", "dh32"])
def test_decoder_layer_cache_steps_match_reference(d_model, nhead):
    """gen_cache, then one token a step against the incremental Cache and
    the StaticCache of the memory (the cached decode's Sq = 1 attentions),
    on both sides."""
    from paddle_tpu.nn import TransformerDecoderLayer

    paddle.seed(7)
    ref = TransformerDecoderLayer(d_model, nhead, 64, dropout=0.0)
    port = _load(tnn.TransformerDecoderLayer(d_model, nhead, 64,
                                             dropout=0.0), ref)
    tgt, mem = _x(2, 4, d_model), _x(2, 5, d_model, seed=1)
    cache = port.gen_cache(_t(mem))
    with functional_trace():
        ref_cache = ref.gen_cache(Tensor(mem))
        for step in range(4):
            xs = tgt[:, step:step + 1]
            out, cache = port(_t(xs), _t(mem), None, None, cache)
            out_r, ref_cache = ref(Tensor(xs), Tensor(mem), None, None,
                                   ref_cache)
            _close(out, _np(out_r))
    assert cache[0].k.shape == (2, nhead, 4, d_model // nhead)
    assert cache[1].k.shape == (2, nhead, 5, d_model // nhead)


def test_decoder_matches_reference_and_clones_its_first_layer():
    from paddle_tpu.nn import (LayerNorm, TransformerDecoder,
                               TransformerDecoderLayer)

    paddle.seed(8)
    ref = TransformerDecoder(TransformerDecoderLayer(32, 4, 64, dropout=0.0,
                                                     normalize_before=True),
                             3, LayerNorm(32))
    port = _load(tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(32, 4, 64, dropout=0.0,
                                    normalize_before=True), 3,
        tnn.LayerNorm(32)), ref)
    tgt, mem = _x(2, 6, 32), _x(2, 5, 32, seed=1)
    with functional_trace():
        out_r = ref(Tensor(tgt), Tensor(mem))
        ref_caches = ref.gen_cache(Tensor(mem))
        step_r, _ = ref(Tensor(tgt[:, :1]), Tensor(mem), None, None,
                        ref_caches)
    _close(port(_t(tgt), _t(mem)), _np(out_r))
    step, caches = port(_t(tgt[:, :1]), _t(mem), None, None,
                        port.gen_cache(_t(mem)))
    _close(step, _np(step_r))
    assert len(caches) == 3
    fresh = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(32, 4, 64), 3)
    a, b = fresh.layers[0], fresh.layers[2]
    assert all(torch.equal(p, q) and p is not q
               for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_transformer_full_matches_reference(normalize_before):
    """The twin of test_layers.py's test_transformer_full (d_model 16,
    4 heads, one layer each side), with the reference's parameter names
    (and the final norms of the pre-LN stacks)."""
    from paddle_tpu.nn import Transformer

    paddle.seed(9)
    ref = Transformer(d_model=16, nhead=4, num_encoder_layers=1,
                      num_decoder_layers=1, dim_feedforward=32, dropout=0.0,
                      normalize_before=normalize_before)
    port = _load(tnn.Transformer(d_model=16, nhead=4, num_encoder_layers=1,
                                 num_decoder_layers=1, dim_feedforward=32,
                                 dropout=0.0,
                                 normalize_before=normalize_before), ref)
    src, tgt = np.random.RandomState(0).rand(2, 5, 16).astype(np.float32), \
        np.random.RandomState(1).rand(2, 3, 16).astype(np.float32)
    tmask = port.generate_square_subsequent_mask(3)
    with functional_trace():
        out_r = ref(Tensor(src), Tensor(tgt), None, Tensor(tmask.numpy()))
    out = port(_t(src), _t(tgt), tgt_mask=tmask)
    assert out.shape == (2, 3, 16)
    _close(out, _np(out_r))


def test_transformer_takes_a_custom_encoder_and_decoder():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(16, 4, 32), 2)
    dec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(16, 4, 32), 1)
    model = tnn.Transformer(d_model=16, nhead=4, custom_encoder=enc,
                            custom_decoder=dec)
    assert model.encoder is enc and model.decoder is dec
    assert len(model.encoder.layers) == 2 and len(model.decoder.layers) == 1


def test_generate_square_subsequent_mask_is_the_references():
    from paddle_tpu.nn import Transformer

    mask = tnn.Transformer.generate_square_subsequent_mask(5)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(
        mask.numpy(), _np(Transformer.generate_square_subsequent_mask(
            None, 5)))


def test_gen_cache_dtype_and_static_cache_layout():
    """The empty incremental Cache comes in the projections' dtype
    (float32 in a float32 layer, as the reference's), so a bf16 step's
    concatenation stays bf16; a StaticCache is stored contiguous, with the
    values of the projections."""
    for dtype in (torch.float32, torch.bfloat16):
        mha = tnn.MultiHeadAttention(32, 4).to(dtype)
        mem = torch.randn(2, 5, 32, dtype=dtype)
        cache = mha.gen_cache(mem)
        assert cache.k.dtype == cache.v.dtype == dtype
        assert cache.k.shape == (2, 4, 0, 8)
        _out, grown = mha(mem[:, :1], cache=cache)
        assert grown.k.dtype == dtype and grown.k.shape == (2, 4, 1, 8)
        static = mha.gen_cache(mem, type=tnn.MultiHeadAttention.StaticCache)
        assert static.k.is_contiguous() and static.v.is_contiguous()
        assert torch.equal(static.k, mha._split_heads(mha.k_proj(mem)))
        assert torch.equal(static.v, mha._split_heads(mha.v_proj(mem)))


# ---- the model --------------------------------------------------------------

CONFIGS = {"tiny": {}, "dh32": {"nhead": 2}}


def _configs(name):
    """(the reference's config, the port's), dropout 0."""
    from paddle_tpu.models.transformer import TransformerConfig

    rc = TransformerConfig.tiny()
    rc.dropout = 0.0
    for k, v in CONFIGS[name].items():
        setattr(rc, k, v)
    return rc, tt.TransformerConfig(**rc.__dict__)


def _src(seed, b=2, s=6, vocab=512):
    return np.random.RandomState(seed).randint(2, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """The reference model (seed 5, eval) and the port's on its weights,
    with the reference's decodes of one 2 x 6 batch: greedy, beam 1 and
    beam 4 (length penalty 0), and beam 4 (0.6) with the eos bias."""
    from paddle_tpu.models.transformer import TransformerModel

    rc, cfg = _configs(request.param)
    paddle.seed(5)
    ref = TransformerModel(rc)
    ref.eval()
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    port = tt.from_reference_params(cfg, params, device="cpu")
    port.eval()
    src = _src(3)
    out = {"greedy": ref.greedy_decode(src, max_len=MAX_LEN).numpy(),
           "beam1": ref.beam_search_decode(src, beam_size=1, max_len=MAX_LEN,
                                           length_penalty=0.0).numpy(),
           "beam4": ref.beam_search_decode(src, beam_size=4, max_len=MAX_LEN,
                                           length_penalty=0.0).numpy()}
    biased = dict(params)
    biased["generator.bias"] = params["generator.bias"].copy()
    biased["generator.bias"][cfg.eos_id] += EOS_BIAS
    saved = ref.functional_state()
    ref.load_functional_state({k: jnp.asarray(v)
                               for k, v in biased.items()}, None)
    out["beam4_eos"] = ref.beam_search_decode(src, beam_size=4,
                                              max_len=MAX_LEN).numpy()
    ref.load_functional_state(*saved)
    return {"ref": ref, "params": params, "port": port, "cfg": cfg,
            "src": src, "out": out, "biased": biased}


def test_parameter_names_are_the_references(pair):
    port, params, cfg = pair["port"], pair["params"], pair["cfg"]
    names = dict(port.named_parameters())
    assert set(names) == set(params) == set(tt.param_shapes(cfg))
    for n, p in names.items():
        assert tuple(p.shape) == params[n].shape, n
    assert "pos_enc" not in names and "pos_enc" not in port.state_dict()
    fresh = tt.TransformerModel(cfg, device="cpu")  # cloned layers
    l0, l1 = fresh.transformer.decoder.layers
    assert all(torch.equal(a, b) for a, b in zip(l0.parameters(),
                                                 l1.parameters()))


def test_from_reference_params_rejects_mismatches(pair):
    params, cfg = pair["params"], pair["cfg"]
    bad = dict(params)
    bad.pop("generator.bias")
    with pytest.raises(ValueError, match="missing"):
        tt.from_reference_params(cfg, bad, device="cpu")
    bad = dict(params, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        tt.from_reference_params(cfg, bad, device="cpu")
    bad = dict(params, **{"generator.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        tt.from_reference_params(cfg, bad, device="cpu")


def test_sinusoid_position_encoding_is_the_references():
    from paddle_tpu.models.transformer import sinusoid_position_encoding

    np.testing.assert_array_equal(tt.sinusoid_position_encoding(64, 48),
                                  sinusoid_position_encoding(64, 48))


def _ref_loss_grad(ref, src, tin, tout):
    def loss(p):
        saved = ref.functional_state()
        ref.load_functional_state(p, None)
        try:
            with functional_trace():
                return ref.loss(Tensor(src), Tensor(tin), Tensor(tout))._value
        finally:
            ref.load_functional_state(*saved)

    return jax.value_and_grad(loss)


def test_forward_and_loss_match_reference(pair):
    """The twin of TestTransformerModel.test_forward_and_loss: logits
    without and with a source padding mask, the label-smoothed loss and
    every gradient."""
    ref, port, cfg = pair["ref"], pair["port"], pair["cfg"]
    rs = np.random.RandomState(1)
    src = rs.randint(2, 512, (2, 10)).astype(np.int32)
    tin = rs.randint(2, 512, (2, 8)).astype(np.int32)
    pad = (np.arange(10)[None] < np.array([10, 6])[:, None]).astype(np.int32)
    with functional_trace():
        lr = _np(ref(Tensor(src), Tensor(tin)))
        lr_pad = _np(ref(Tensor(src), Tensor(tin), Tensor(pad)))
    logits = port(src, tin)
    assert logits.shape == (2, 8, cfg.tgt_vocab_size)
    _close(logits, lr, 1e-4)
    _close(port(src, tin, pad), lr_pad, 1e-4)
    loss_r, grads_r = _ref_loss_grad(ref, src, tin, tin)(
        {k: jnp.asarray(v) for k, v in pair["params"].items()})
    port.zero_grad()
    loss = port.loss(src, tin, tin)
    loss.backward()
    assert abs(loss.item() - float(loss_r)) <= 1e-4
    for name, p in port.named_parameters():
        r = np.asarray(grads_r[name])
        tol = max(1e-3 * np.abs(r).max(), 1e-7)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)
    port.zero_grad()


def test_label_smoothing_is_the_loss_default(pair):
    port, cfg = pair["port"], pair["cfg"]
    src, tin = _src(4, s=10), _src(5, s=8)
    with torch.no_grad():
        logits = port(src, tin).reshape(-1, cfg.tgt_vocab_size)
        logp = torch.log_softmax(logits, -1)
        lbl = torch.from_numpy(tin).long().reshape(-1)
        nll = -logp.gather(1, lbl[:, None])[:, 0]
        want = (0.9 * nll - 0.1 / cfg.tgt_vocab_size * logp.sum(-1)).mean()
        assert torch.allclose(port.loss(src, tin, tin), want, atol=1e-6)
        assert torch.allclose(port.loss(src, tin, tin, label_smoothing=0.0),
                              nll.mean(), atol=1e-6)


def test_greedy_decode_matches_reference(pair):
    """The twin of TestTransformerModel.test_greedy_decode: [B, max_len]
    tokens from bos, equal to the reference's."""
    out = pair["port"].greedy_decode(pair["src"], max_len=MAX_LEN)
    assert out.shape == (2, MAX_LEN) and out.dtype == torch.int32
    assert (out[:, 0] == pair["cfg"].bos_id).all()
    np.testing.assert_array_equal(out.numpy(), pair["out"]["greedy"])


def test_cached_greedy_decode_matches_full_reforward(pair):
    """The twin of test_transformer_model.py's test: the cached decode
    (Sq = 1 steps against the layer caches) and the full re-forward give
    the same tokens, the reference's."""
    port, src = pair["port"], pair["src"]
    full = port.greedy_decode(src, max_len=MAX_LEN, use_cache=False)
    cached = port.greedy_decode(src, max_len=MAX_LEN, use_cache=True)
    np.testing.assert_array_equal(full.numpy(), cached.numpy())
    np.testing.assert_array_equal(cached.numpy(), pair["out"]["greedy"])


def test_beam1_equals_greedy(pair):
    """The twin of test_beam_search.py's test: beam 1 is greedy up to its
    first eos, and equals the reference's beam 1."""
    port, cfg = pair["port"], pair["cfg"]
    greedy = port.greedy_decode(pair["src"], max_len=MAX_LEN).numpy()
    beam1 = port.beam_search_decode(pair["src"], beam_size=1,
                                    max_len=MAX_LEN,
                                    length_penalty=0.0).numpy()
    np.testing.assert_array_equal(beam1, pair["out"]["beam1"])
    for b in range(greedy.shape[0]):
        g = greedy[b]
        stop = np.where(g == cfg.eos_id)[0]
        n = (stop[0] + 1) if len(stop) else len(g)
        np.testing.assert_array_equal(beam1[b, :n], g[:n])


def _seq_logprob(model, src, tgt, eos):
    """The port model's log-likelihood of tgt (teacher-forced), summed up
    to and including the first eos."""
    with torch.no_grad():
        logp = torch.log_softmax(model(src, tgt[:, :-1]).float(), -1)
    tok = torch.from_numpy(tgt[:, 1:]).long()
    picked = logp.gather(-1, tok[..., None])[..., 0]
    before_eos = torch.cumsum((tok == eos).int(), 1) <= 1
    return (picked * before_eos).sum(1).numpy()


def test_wider_beam_no_worse_than_greedy(pair):
    """The twin of test_beam_search.py's test: beam 4 equals the
    reference's and scores no worse than greedy under the model."""
    port, cfg, src = pair["port"], pair["cfg"], pair["src"]
    greedy = port.greedy_decode(src, max_len=MAX_LEN).numpy()
    beam = port.beam_search_decode(src, beam_size=4, max_len=MAX_LEN,
                                   length_penalty=0.0).numpy()
    np.testing.assert_array_equal(beam, pair["out"]["beam4"])
    T = max(greedy.shape[1], beam.shape[1])

    def pad(x):
        return np.pad(x, ((0, 0), (0, T - x.shape[1])),
                      constant_values=cfg.eos_id)

    lp_beam = _seq_logprob(port, src, pad(beam), cfg.eos_id)
    lp_greedy = _seq_logprob(port, src, pad(greedy), cfg.eos_id)
    assert (lp_beam >= lp_greedy - 1e-3).all(), (lp_beam, lp_greedy)


def test_eos_padding_and_shapes(pair):
    """The twin of test_beam_search.py's test, with the eos logit raised
    by EOS_BIAS on both sides so that beams finish at different steps
    (frozen finished beams, the length penalty 0.6, the early stop):
    tokens equal to the reference's, bos first, eos after the first."""
    cfg = pair["cfg"]
    port = tt.from_reference_params(cfg, pair["biased"], device="cpu")
    port.eval()
    out = port.beam_search_decode(pair["src"], beam_size=4,
                                  max_len=MAX_LEN).numpy()
    np.testing.assert_array_equal(out, pair["out"]["beam4_eos"])
    assert out.shape[0] == 2 and out.shape[1] <= MAX_LEN
    assert (out[:, 0] == cfg.bos_id).all()
    assert (out == cfg.eos_id).any()
    for rowv in out:
        hits = np.where(rowv == cfg.eos_id)[0]
        if len(hits):
            assert (rowv[hits[0]:] == cfg.eos_id).all()


def test_the_reference_tests_own_config_decodes_alike():
    """test_cached_greedy_decode_matches_full_reforward's own config
    (vocab 120 / 130, d_model 32, 4 heads: head dim 8) at its shapes:
    cached == full re-forward == the reference's cached tokens."""
    from paddle_tpu.models.transformer import (TransformerConfig,
                                               TransformerModel)

    kw = dict(src_vocab_size=120, tgt_vocab_size=130, d_model=32, nhead=4,
              num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=64, dropout=0.0)
    paddle.seed(0)
    ref = TransformerModel(TransformerConfig(**kw))
    ref.eval()
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    port = tt.from_reference_params(tt.TransformerConfig(**kw), params,
                                    device="cpu")
    port.eval()
    src = np.random.RandomState(0).randint(4, 100, (3, 9)).astype(np.int32)
    want = ref.greedy_decode(src, max_len=12, use_cache=True).numpy()
    full = port.greedy_decode(src, max_len=12, use_cache=False)
    cached = port.greedy_decode(src, max_len=12, use_cache=True)
    np.testing.assert_array_equal(full.numpy(), cached.numpy())
    np.testing.assert_array_equal(cached.numpy(), want)


# ---- dtypes -----------------------------------------------------------------

def test_bf16_forward_loss_and_decodes_run_in_bf16():
    """A bf16 model on the CPU: forward, loss and backward, cached greedy
    and beam decoding run without a dtype error, the logits in bf16 (the
    pos_enc slice and the masks join in the embeddings' dtype)."""
    cfg = tt.TransformerConfig.tiny()
    cfg.dropout = 0.0
    model = tt.TransformerModel(cfg, dtype=torch.bfloat16, device="cpu")
    assert model.pos_enc.dtype == torch.bfloat16
    src, tin = _src(6, s=10), _src(7, s=8)
    pad = (np.arange(10)[None] < np.array([10, 6])[:, None]).astype(np.int32)
    logits = model(src, tin, pad)
    assert logits.dtype == torch.bfloat16
    loss = model.loss(src, tin, tin)
    loss.backward()
    assert torch.isfinite(loss.float()) and \
        model.generator.weight.grad.dtype == torch.bfloat16
    model.eval()
    assert model.greedy_decode(src, max_len=6).shape == (2, 6)
    assert model.beam_search_decode(src, beam_size=2, max_len=6).shape[0] == 2


def test_bf16_params_on_float32_buffers_keep_the_trunk_in_bf16():
    """bf16 parameters bound through `loss_with` (mixed precision: the
    module's pos_enc buffer stays float32) train in bf16, the loss equals
    model.loss on a bf16 copy of the model, and the same float32 params
    give the float32 model's loss."""
    cfg = tt.TransformerConfig.tiny()
    cfg.dropout = 0.0
    model = tt.TransformerModel(cfg, device="cpu")
    src, tin = _src(8, s=10), _src(9, s=8)
    masters = {n: p.detach().clone().requires_grad_(True)
               for n, p in model.named_parameters()}
    low = {n: p.to(torch.bfloat16) for n, p in masters.items()}
    loss = tt.loss_with(model, low, src, tin, tin)
    assert loss.dtype == torch.bfloat16
    grads = torch.autograd.grad(loss.float(), list(masters.values()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    model16 = tt.TransformerModel(cfg, device="cpu")
    model16.load_state_dict({n: p.detach() for n, p in low.items()},
                            strict=False)
    model16.to(torch.bfloat16)
    assert torch.equal(loss, model16.loss(src, tin, tin))
    assert torch.equal(tt.loss_with(model, masters, src, tin, tin),
                       model.loss(src, tin, tin))


def test_model_runs_on_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    from paddle_tpu_torch import device
    monkeypatch.setattr(device, "_current", None)  # no set_device default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.TransformerModel(tt.TransformerConfig.tiny())
