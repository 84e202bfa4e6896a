"""The port's PagedDecoder (paddle_tpu_torch/nn/decode.py) held to the JAX
reference `PagedDecoder` with the same weights (through the weight
bridge), float32 on the CPU: a packed prefill of a 3-segment stream that
includes a chunk resuming mid-prompt, then `step`, then `multistep(4)`.

Tolerances: logits atol=1e-4 (float32; the frameworks sum in different
orders through two layers and the head); greedy tokens identical; the
K/V each program wrote into the pool atol=1e-5 (float32, one layer of
projections). The port writes its pool in place, so only the reference
side swaps in returned arrays."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import reference_tiny_model, t

torch.set_num_threads(1)

BS = 4
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return reference_tiny_model(31)


def _pool_pair(cfg, tcfg, kv_dtype, num_blocks=24):
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TCache

    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    jc = JCache(cfg.num_layers, H, Dh, block_size=BS, num_blocks=num_blocks,
                kv_dtype=kv_dtype)
    tc = TCache(tcfg.num_layers, H, Dh, block_size=BS,
                num_blocks=num_blocks, kv_dtype=kv_dtype, device="cpu")
    return jc, tc


def _leaves(kv):
    return (kv.codes, kv.scales) if hasattr(kv, "codes") else (kv,)


def _assert_pools_close(jc, tc, kv_dtype):
    """Every block but the trash block 0 (pad rows may race there)."""
    for ja, ta in zip(_leaves(jc.k_blocks) + _leaves(jc.v_blocks),
                      _leaves(tc.k_blocks) + _leaves(tc.v_blocks)):
        ja = np.asarray(ja)[:, 1:].astype(np.float32)
        ta = ta.numpy()[:, 1:].astype(np.float32)
        if kv_dtype == "int8" and ja.ndim == 5:
            # codes: a K/V value on a rounding edge may land one code
            # apart when the two frameworks' projections differ in the
            # last float32 bit
            assert np.abs(ja - ta).max() <= 1
            assert (ja == ta).mean() > 0.999
        else:
            np.testing.assert_allclose(ta, ja, atol=KV_ATOL, rtol=1e-5)


def _run_both(models, kv_dtype):
    """The same program sequence through both decoders; returns the
    per-phase outputs of each side and the two caches."""
    from paddle_tpu.nn.decode import PagedDecoder as JDec
    from paddle_tpu.sampling import greedy_args as jgreedy

    from paddle_tpu_torch.nn.decode import PagedDecoder as TDec
    from paddle_tpu_torch.sampling import greedy_args as tgreedy

    model, cfg, port, tcfg = models
    jparams, _ = model.functional_state()
    tparams = port.flat_params()
    jc, tc = _pool_pair(cfg, tcfg, kv_dtype)
    jdec = JDec.for_config(cfg, BS, return_logits=True, kv_dtype=kv_dtype)
    tdec = TDec.for_config(tcfg, BS, return_logits=True, kv_dtype=kv_dtype)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (11, 5, 9)]
    out = {"j": {}, "t": {}}

    def packed(seqs, chunks, width):
        """chunks: (row, start, n) in packed order, 8-aligned regions."""
        T = sum(-(-n // 8) * 8 for _r, _s, n in chunks)
        toks = np.zeros(T, np.int32)
        seg = np.zeros(T, np.int32)
        pos = np.full(T, -1, np.int32)
        sidx = np.zeros(len(seqs), np.int32)
        o = 0
        for r, s0, n in chunks:
            toks[o:o + n] = prompts[r][s0:s0 + n]
            seg[o:o + n] = r
            pos[o:o + n] = np.arange(s0, s0 + n)
            sidx[r] = o + n - 1
            o += -(-n // 8) * 8
        for c in (jc, tc):
            c.ensure_many([(r, s0 + n) for r, s0, n in chunks])
        tab = jc.table_array(seqs, width)
        np.testing.assert_array_equal(tab, tc.table_array(seqs, width))
        return toks, seg, pos, tab, sidx

    # dispatch 1: the first 6 tokens of prompt 0 alone
    toks, seg, pos, tab, sidx = packed([0], [(0, 0, 6)], 3)
    jr = jdec.packed_prefill(jparams, jnp.asarray(toks), jnp.asarray(seg),
                             jnp.asarray(pos), jnp.asarray(tab),
                             jnp.asarray(sidx), jc.k_blocks, jc.v_blocks,
                             jgreedy(1))
    jc.swap_arrays(jr[2], jr[3])
    tr = tdec.packed_prefill(tparams, t(toks), t(seg), t(pos), t(tab),
                             t(sidx), tc.k_blocks, tc.v_blocks,
                             tgreedy(1, "cpu"))
    # dispatch 2: prompt 0 resumes mid-prompt (6..10), prompts 1 and 2
    # fresh — three segments, the last ending in packing pads
    toks, seg, pos, tab, sidx = packed(
        [0, 1, 2], [(0, 6, 5), (1, 0, 5), (2, 0, 9)], 3)
    jr = jdec.packed_prefill(jparams, jnp.asarray(toks), jnp.asarray(seg),
                             jnp.asarray(pos), jnp.asarray(tab),
                             jnp.asarray(sidx), jc.k_blocks, jc.v_blocks,
                             jgreedy(3))
    jc.swap_arrays(jr[2], jr[3])
    tr = tdec.packed_prefill(tparams, t(toks), t(seg), t(pos), t(tab),
                             t(sidx), tc.k_blocks, tc.v_blocks,
                             tgreedy(3, "cpu"))
    out["j"]["prefill"] = (np.asarray(jr[0]), np.asarray(jr[5]))
    out["t"]["prefill"] = (tr[0].numpy(), tr[5].numpy())
    # one decode step: each row's token 0 at its prompt length
    tok0 = out["j"]["prefill"][0]
    lens = np.array([p.size for p in prompts], np.int32)
    for c in (jc, tc):
        c.ensure_many([(r, int(lens[r]) + 5) for r in range(3)])
    width = 5
    tab = jc.table_array([0, 1, 2], width)
    act = np.ones(3, bool)
    jr = jdec.step(jparams, jnp.asarray(tok0), jnp.asarray(lens),
                   jnp.asarray(act), jnp.asarray(tab), jc.k_blocks,
                   jc.v_blocks, jgreedy(3))
    jc.swap_arrays(jr[2], jr[3])
    tr = tdec.step(tparams, t(tok0), t(lens), t(act), t(tab), tc.k_blocks,
                   tc.v_blocks, tgreedy(3, "cpu"))
    out["j"]["step"] = (np.asarray(jr[0]), np.asarray(jr[5]))
    out["t"]["step"] = (tr[0].numpy(), tr[5].numpy())
    # multistep(4) from the step's tokens, one row idle (trash writes)
    tok1 = out["j"]["step"][0]
    act = np.array([True, False, True])
    jm = jdec.multistep(4)(jparams, jnp.asarray(tok1),
                           jnp.asarray(lens + 1), jnp.asarray(act),
                           jnp.asarray(tab), jc.k_blocks, jc.v_blocks,
                           jgreedy(3))
    jc.swap_arrays(jm[2], jm[3])
    tm = tdec.multistep(4)(tparams, t(tok1), t(lens + 1), t(act), t(tab),
                           tc.k_blocks, tc.v_blocks, tgreedy(3, "cpu"))
    out["j"]["multistep"] = np.asarray(jm[0])
    out["t"]["multistep"] = tm[0].numpy()
    return out, jc, tc


@pytest.fixture(scope="module")
def dense_run(models):
    return _run_both(models, None)


@pytest.mark.parametrize("phase", ["prefill", "step"])
def test_logits_and_greedy_tokens_match_reference(dense_run, phase):
    out, _jc, _tc = dense_run
    (jtok, jlog), (ttok, tlog) = out["j"][phase], out["t"][phase]
    np.testing.assert_allclose(tlog, jlog, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(ttok, jtok)


def test_multistep_tokens_match_reference(dense_run):
    out, _jc, _tc = dense_run
    np.testing.assert_array_equal(out["t"]["multistep"],
                                  out["j"]["multistep"])
    assert (out["t"]["multistep"][:, 1] == 0).all()  # idle row emits 0


def test_pool_writes_match_reference(dense_run):
    _out, jc, tc = dense_run
    _assert_pools_close(jc, tc, None)


def test_int8_pool_program_matches_reference(models):
    """The same sequence over int8 pools on both sides (quantize on
    append, dequantize in the attention op). Logits atol=1e-3: a K/V
    value on a rounding edge may quantize one code apart on the two
    sides (see _assert_pools_close), which moves a logit by ~1e-4."""
    out, jc, tc = _run_both(models, "int8")
    for phase in ("prefill", "step"):
        (jtok, jlog), (ttok, tlog) = out["j"][phase], out["t"][phase]
        np.testing.assert_allclose(tlog, jlog, atol=LOGIT_ATOL * 10)
        np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(out["t"]["multistep"],
                                  out["j"]["multistep"])
    _assert_pools_close(jc, tc, "int8")


def test_int8_kv_write_matches_reference_encode():
    """`_kv_io(True)` writes exactly the reference codec's codes and
    scales for the same K values."""
    from paddle_tpu.inference.kv_quant import kv_encode as jencode

    from paddle_tpu_torch.inference.kv_quant import QuantizedKV
    from paddle_tpu_torch.nn.decode import _kv_io

    rs = np.random.RandomState(9)
    L, N, H, Dh = 2, 5, 4, 8
    k = (rs.randn(6, H, Dh) * rs.uniform(0.01, 3, (6, H, 1))) \
        .astype(np.float32)
    k[2, 1] = 0.0  # a zero vector: scale floor, codes 0
    blk = np.array([1, 1, 2, 3, 4, 4])
    off = np.array([0, 3, 1, 2, 0, 1])
    cache = QuantizedKV(torch.zeros(L, N, BS, H, Dh, dtype=torch.int8),
                        torch.zeros(L, N, BS, H))
    write, layer = _kv_io(True)
    cache = write(cache, 1, t(blk).long(), t(off).long(), t(k))
    codes, scales = (np.asarray(a) for a in jencode(jnp.asarray(k)))
    np.testing.assert_array_equal(cache.codes[1, blk, off].numpy(), codes)
    np.testing.assert_array_equal(cache.scales[1, blk, off].numpy(),
                                  scales)
    assert cache.codes[0].abs().sum() == 0  # other layers untouched
    got = layer(cache, 1)
    assert got.codes.shape == (N, BS, H, Dh)


def test_kv_dtype_mismatch_names_argument(models):
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    _model, _cfg, port, tcfg = models
    c = PagedKVCache(tcfg.num_layers, tcfg.num_heads,
                     tcfg.hidden_size // tcfg.num_heads, block_size=BS,
                     num_blocks=4, device="cpu")
    dec = PagedDecoder.for_config(tcfg, BS, kv_dtype="int8")
    with pytest.raises(ValueError, match="'kc'"):
        dec.step(port.flat_params(), torch.zeros(1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool),
                 torch.zeros(1, 1, dtype=torch.int32), c.k_blocks,
                 c.v_blocks, greedy_args(1, "cpu"))


def test_bridge_rejects_w8a16_params(models):
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    _model, _cfg, port, tcfg = models
    params = {k: v.numpy() for k, v in port.flat_params().items()}
    params["h.0.fc1.weight::w8c"] = params.pop("h.0.fc1.weight")
    with pytest.raises(ValueError, match="W8A16"):
        from_reference_params(tcfg, params, device="cpu")
    params = {k: v.numpy() for k, v in port.flat_params().items()}
    del params["ln_f.bias"]
    with pytest.raises(ValueError, match="missing"):
        from_reference_params(tcfg, params, device="cpu")
