"""W8A16 weight serving on the port, held to the JAX reference's W8A16
(`tests/test_quantized_serving.py`'s suite) in float32 on the CPU, with
the same weights through the weight bridge (`GPT2Config.tiny()`,
`block_size=4`):

  * `GPT2.quantize_weights` against the reference's: codes bit for bit,
    scales equal, float32 and bfloat16, tied and untied heads;
  * `quantized_params_from_reference` (the reference's packed dict,
    names, shapes and dtypes carried across; bad entries refused);
  * the decoder programs on W8A16 params: packed prefill and step logits
    within `LOGIT_ATOL` (1e-4, `tests/test_torch_decoder.py`'s), x10 with
    int8 KV, and the same greedy tokens, multistep(3) too;
  * the server with `quantization="w8a16"`, alone and with
    `kv_dtype="int8"`, on `TestServedParity`'s pinned workloads (the
    decode with chunked prefill; prefix cache on, off, and on a warm
    index), at k = 1 and k = 2: the REFERENCE W8A16 server's tokens with
    the same options. Not bf16's tokens: the reference's own W8A16 run
    flips an argmax against bf16 on this config (two of prompt 0's
    tokens), so `TestServedParity`'s w8a16 cases are red there;
  * `TestLogitTolerance`'s twin: W8A16 + int8 KV against the unquantized
    program within `LOGIT_TOL` of the logit scale, same greedy tokens;
  * `TestQuantStatsSchema`'s twin (the reference server's block equals
    the port's), the byte accounting, the `weight_quant` alias and the
    validation errors."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import reference_tiny_model, t

torch.set_num_threads(1)

BS = 4
LOGIT_ATOL = 1e-4     # tests/test_torch_decoder.py's float32 limit
LOGIT_TOL = 0.05      # tests/test_quantized_serving.py's documented limit
QUANT_MODES = [("w8a16", dict(quantization="w8a16")),
               ("w8a16_kv8", dict(quantization="w8a16", kv_dtype="int8"))]


@pytest.fixture(scope="module")
def tiny():
    # TestServedParity's weights: paddle.seed(13)
    model, cfg, port, tcfg = reference_tiny_model(13)
    return model, cfg, port, tcfg


def _untied(seed):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(seed)
    cfg = GPT2Config.tiny()
    cfg.dropout, cfg.tie_embeddings = 0.0, False
    model = GPT2(cfg)
    params, _ = model.functional_state()
    tcfg = TConfig.tiny()
    tcfg.dropout, tcfg.tie_embeddings = 0.0, False
    port = from_reference_params(
        tcfg, {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return model, cfg, port, tcfg


def _np(a):
    """A tensor or array as numpy, bfloat16 widened to float32 (exact)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---- quantize_weights -------------------------------------------------------

@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_codes_match_reference(tiny, tied, dtype):
    """Codes bit for bit, scales equal and in the weight's dtype, every
    other entry passed through, the same key set as the reference."""
    model, _cfg, port, _tcfg = tiny if tied else _untied(5)
    jparams, _ = model.functional_state()
    tparams = port.flat_params()
    if dtype == "bfloat16":
        jparams = {k: v.astype(jnp.bfloat16) for k, v in jparams.items()}
        tparams = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
    jq = model.quantize_weights(jparams)
    tq = port.quantize_weights(tparams)
    assert set(tq) == set(jq)
    assert ("lm_head.weight::w8c" in tq) == (not tied)
    for name, want in jq.items():
        got = tq[name]
        if name.endswith("::w8c"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert np.abs(np.asarray(want)).max() == 127
        else:
            assert str(got.dtype) == f"torch.{dtype}", name
            np.testing.assert_array_equal(_np(got), _np(want))
    # the model's own params are the default input
    again = port.quantize_weights() if dtype == "float32" else None
    if again is not None:
        for name in tq:
            assert torch.equal(again[name], tq[name])


def test_quantize_keeps_zero_weights_finite():
    """An all-zero column takes the 1e-12 floor: codes 0, a finite
    scale, as the reference's `jnp.maximum(amax, 1e-12)`."""
    from paddle_tpu_torch.models.gpt2 import (GPT2, GPT2Config,
                                              quantize_decode_weights_int8)

    cfg = GPT2Config(vocab_size=16, hidden_size=8, num_layers=1,
                     num_heads=2, max_position=8)
    params = GPT2(cfg, device="cpu").flat_params()
    params["h.0.fc1.weight"] = params["h.0.fc1.weight"].clone()
    params["h.0.fc1.weight"][:, 3] = 0.0
    q = quantize_decode_weights_int8(params, cfg)
    assert (q["h.0.fc1.weight::w8c"][:, 3] == 0).all()
    assert torch.isfinite(q["h.0.fc1.weight::w8s"]).all()
    assert "h.0.fc1.weight" not in q and "h.0.fc1.bias" in q


# ---- the bridge -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_reference_w8a16_params(tiny, dtype):
    from paddle_tpu_torch.models.gpt2 import quantized_params_from_reference

    model, _cfg, _port, tcfg = tiny
    jparams, _ = model.functional_state()
    if dtype == "bfloat16":
        jparams = {k: v.astype(jnp.bfloat16) for k, v in jparams.items()}
    jq = {k: np.asarray(v) for k, v in model.quantize_weights(
        jparams).items()}
    got = quantized_params_from_reference(tcfg, jq, device="cpu")
    assert set(got) == set(jq)
    for name, a in jq.items():
        want = torch.int8 if name.endswith("::w8c") else getattr(torch,
                                                                 dtype)
        assert got[name].dtype == want, name
        assert tuple(got[name].shape) == a.shape
        np.testing.assert_array_equal(_np(got[name]), _np(a))


def test_bridge_refuses_bad_entries(tiny):
    from paddle_tpu_torch.models.gpt2 import (from_reference_params,
                                              quantized_params_from_reference)

    model, _cfg, _port, tcfg = tiny
    jq = {k: np.asarray(v) for k, v in model.quantize_weights().items()}
    with pytest.raises(ValueError, match="quantized_params_from_reference"):
        from_reference_params(tcfg, jq, device="cpu")
    bad = dict(jq)
    del bad["h.1.fc2.weight::w8s"]
    with pytest.raises(ValueError, match="missing"):
        quantized_params_from_reference(tcfg, bad, device="cpu")
    bad = dict(jq, **{"h.0.fc1.weight": np.zeros((128, 512), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        quantized_params_from_reference(tcfg, bad, device="cpu")
    bad = dict(jq, **{"h.0.fc1.weight::w8c":
                      jq["h.0.fc1.weight::w8c"].astype(np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        quantized_params_from_reference(tcfg, bad, device="cpu")
    bad = dict(jq, **{"wte.weight::w8s": jq["wte.weight::w8s"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        quantized_params_from_reference(tcfg, bad, device="cpu")


# ---- the decoder programs ---------------------------------------------------

def _decoder_run(tiny, kv_dtype):
    """Packed prefill (two chunks, a mid-prompt resume), one step and
    multistep(3) on W8A16 params through both decoders."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
    from paddle_tpu.nn.decode import PagedDecoder as JDec
    from paddle_tpu.sampling import greedy_args as jgreedy

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TCache
    from paddle_tpu_torch.nn.decode import PagedDecoder as TDec
    from paddle_tpu_torch.sampling import greedy_args as tgreedy

    model, cfg, port, tcfg = tiny
    jp = model.quantize_weights()
    tp = port.quantize_weights()
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    jc = JCache(cfg.num_layers, H, Dh, block_size=BS, num_blocks=24,
                kv_dtype=kv_dtype)
    tc = TCache(tcfg.num_layers, H, Dh, block_size=BS, num_blocks=24,
                kv_dtype=kv_dtype, device="cpu")
    jd = JDec.for_config(cfg, BS, return_logits=True, kv_dtype=kv_dtype)
    td = TDec.for_config(tcfg, BS, return_logits=True, kv_dtype=kv_dtype)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (10, 6, 9)]
    out = {}

    def packed(chunks, rows):
        T = sum(-(-n // 8) * 8 for _r, _s, n in chunks)
        toks, seg = np.zeros(T, np.int32), np.zeros(T, np.int32)
        pos, sidx = np.full(T, -1, np.int32), np.zeros(rows, np.int32)
        o = 0
        for r, s0, n in chunks:
            toks[o:o + n] = prompts[r][s0:s0 + n]
            seg[o:o + n] = r
            pos[o:o + n] = np.arange(s0, s0 + n)
            sidx[r] = o + n - 1
            o += -(-n // 8) * 8
        for c in (jc, tc):
            c.ensure_many([(r, s0 + n) for r, s0, n in chunks])
        tab = jc.table_array(list(range(rows)), 4)
        jr = jd.packed_prefill(jp, *map(jnp.asarray, (toks, seg, pos, tab,
                                                      sidx)),
                               jc.k_blocks, jc.v_blocks, jgreedy(rows))
        jc.swap_arrays(jr[2], jr[3])
        tr = td.packed_prefill(tp, t(toks), t(seg), t(pos), t(tab), t(sidx),
                               tc.k_blocks, tc.v_blocks,
                               tgreedy(rows, "cpu"))
        return jr, tr

    packed([(0, 0, 4)], 1)
    jr, tr = packed([(0, 4, 6), (1, 0, 6), (2, 0, 9)], 3)
    out["prefill"] = ((np.asarray(jr[0]), np.asarray(jr[5])),
                      (tr[0].numpy(), tr[5].numpy()))
    lens = np.array([p.size for p in prompts], np.int32)
    for c in (jc, tc):
        c.ensure_many([(r, int(lens[r]) + 4) for r in range(3)])
    tab = jc.table_array([0, 1, 2], 4)
    tok0, act = out["prefill"][0][0], np.ones(3, bool)
    jr = jd.step(jp, *map(jnp.asarray, (tok0, lens, act, tab)), jc.k_blocks,
                 jc.v_blocks, jgreedy(3))
    jc.swap_arrays(jr[2], jr[3])
    tr = td.step(tp, t(tok0), t(lens), t(act), t(tab), tc.k_blocks,
                 tc.v_blocks, tgreedy(3, "cpu"))
    out["step"] = ((np.asarray(jr[0]), np.asarray(jr[5])),
                   (tr[0].numpy(), tr[5].numpy()))
    tok1 = out["step"][0][0]
    jm = jd.multistep(3)(jp, *map(jnp.asarray, (tok1, lens + 1, act, tab)),
                         jc.k_blocks, jc.v_blocks, jgreedy(3))
    tm = td.multistep(3)(tp, t(tok1), t(lens + 1), t(act), t(tab),
                         tc.k_blocks, tc.v_blocks, tgreedy(3, "cpu"))
    out["multistep"] = (np.asarray(jm[0]), tm[0].numpy())
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_w8a16_decoder_programs_match_reference(tiny, kv_dtype):
    out = _decoder_run(tiny, kv_dtype)
    atol = LOGIT_ATOL * (10 if kv_dtype else 1)
    for phase in ("prefill", "step"):
        (jtok, jlog), (ttok, tlog) = out[phase]
        np.testing.assert_allclose(tlog, jlog, atol=atol)
        np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(out["multistep"][1], out["multistep"][0])


# ---- the server -------------------------------------------------------------

def _serve(srv, prompts):
    """All prompts queued before the loop starts (a fixed schedule);
    returns the outputs and the stats, and stops the server."""
    try:
        futs = [srv.submit(p) for p in prompts]
        srv.start()
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


def _servers(tiny, **kw):
    from paddle_tpu.inference import PagedGenerationServer as JServer

    from paddle_tpu_torch.inference import PagedGenerationServer

    model, _cfg, port, _tcfg = tiny
    kw = dict(dict(max_slots=2, block_size=BS, max_prompt_len=48,
                   max_new_tokens=8, prefill_chunk_tokens=16), **kw)
    return (lambda **x: JServer(model, **kw, **x),
            lambda **x: PagedGenerationServer(port, **kw, device="cpu", **x))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name,qkw", QUANT_MODES)
def test_served_decode_and_chunked_prefill_match_reference(tiny, name, qkw,
                                                           k):
    """`test_decode_and_chunked_prefill_parity`'s workload: prompts of
    36, 30, 25 and 21 tokens through 16-token chunks, 2 slots."""
    ids = np.random.RandomState(0).randint(
        1, tiny[3].vocab_size, (4, 36)).astype(np.int32)
    prompts = [ids[i, :n] for i, n in enumerate((36, 30, 25, 21))]
    ref_srv, port_srv = _servers(tiny, steps_per_dispatch=k, **qkw)
    ref, _ = _serve(ref_srv(), prompts)
    out, st = _serve(port_srv(), prompts)
    _same(out, ref)
    q = st["quantization"]
    assert q["enabled"] is True and q["mode"] == "w8a16"
    assert st["decode_graph_replays"] == 0  # the CPU runs eager


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name,qkw", QUANT_MODES)
def test_served_prefix_cache_on_off_match_reference(tiny, name, qkw, k):
    """`test_prefix_cache_on_off_parity`'s workload: a 14-token prefix
    and tails of 2-7 tokens; caching on == off == the reference's W8A16
    server with caching on, and again on a warm index."""
    rs = np.random.RandomState(11)
    prefix = rs.randint(1, tiny[3].vocab_size, (14,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rs.randint(
        1, tiny[3].vocab_size, (int(rs.randint(2, 8)),)).astype(np.int32)])
        for _ in range(5)]
    ref_srv, port_srv = _servers(tiny, steps_per_dispatch=k, **qkw)
    ref, _ = _serve(ref_srv(enable_prefix_cache=True), prompts)
    off, _ = _serve(port_srv(), prompts)
    on, _ = _serve(port_srv(enable_prefix_cache=True), prompts)
    srv = port_srv(enable_prefix_cache=True).start()
    try:
        [f.result(timeout=600) for f in [srv.submit(p) for p in prompts]]
        warm = [np.asarray(f.result(timeout=600))
                for f in [srv.submit(p) for p in prompts]]
        assert srv.cache.stats()["prefix_cache"]["hit_tokens"] > 0
    finally:
        srv.stop()
    _same(on, ref)
    _same(off, ref)
    _same(warm, ref)


def test_logits_within_documented_tolerance(tiny):
    """`TestLogitTolerance`'s twin on the port: W8A16 + int8 KV against
    the unquantized float32 program (a packed prefill of three 12-token
    prompts, then 4 steps): the same greedy tokens, every logit within
    LOGIT_TOL of the logit scale."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache, blocks_for
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    _model, _cfg, port, tcfg = tiny
    params = port.flat_params()
    wq = port.quantize_weights(params)
    rs = np.random.RandomState(2)
    B, S, new = 3, 12, 5
    ids = rs.randint(1, tcfg.vocab_size, (B, S)).astype(np.int32)
    H, Dh = tcfg.num_heads, tcfg.hidden_size // tcfg.num_heads

    def run(p, kvd):
        cache = PagedKVCache(tcfg.num_layers, H, Dh, block_size=BS,
                             num_blocks=B * blocks_for(S + new, BS) + 1,
                             kv_dtype=kvd, device="cpu")
        for b in range(B):
            cache.allocate(b, S + new)
        tables = t(cache.table_array(range(B)))
        dec = PagedDecoder.for_config(tcfg, BS, return_logits=True,
                                      kv_dtype=kvd)
        seg = np.repeat(np.arange(B, dtype=np.int32), S)
        pos = np.tile(np.arange(S, dtype=np.int32), B)
        sidx = np.arange(B, dtype=np.int32) * S + S - 1
        tok, _, kc, vc, _, logits = dec.packed_prefill(
            p, t(ids.reshape(-1)), t(seg), t(pos), tables, t(sidx),
            cache.k_blocks, cache.v_blocks, greedy_args(B, "cpu"))
        toks, logs = [tok], [logits]
        p_ = torch.full((B,), S, dtype=torch.int32)
        for _ in range(1, new):
            tok, _, kc, vc, _, logits = dec.step(
                p, toks[-1], p_, torch.ones(B, dtype=torch.bool), tables,
                kc, vc, greedy_args(B, "cpu"))
            toks.append(tok)
            logs.append(logits)
            p_ = p_ + 1
        return torch.stack(toks).numpy(), torch.stack(logs).numpy()

    t_ref, l_ref = run(params, None)
    t_q, l_q = run(wq, "int8")
    np.testing.assert_array_equal(t_ref, t_q)
    delta = np.abs(l_q - l_ref)
    scale = np.abs(l_ref).max()
    assert 0 < delta.max() <= LOGIT_TOL * max(scale, 1.0), (delta.max(),
                                                            scale)


# ---- stats, options, byte accounting ----------------------------------------

KEYS = {"enabled", "mode", "kv_dtype", "kv_scale_bytes",
        "kv_pool_bytes_total"}


@pytest.mark.parametrize("qkw", [{}, dict(quantization="w8a16"),
                                 dict(kv_dtype="int8"),
                                 dict(quantization="w8a16", kv_dtype="int8"),
                                 dict(weight_quant="int8")],
                         ids=["off", "w8a16", "kv8", "w8a16_kv8", "alias"])
def test_quantization_stats_block_equals_reference(tiny, qkw):
    """`TestQuantStatsSchema`'s twin: the block's keys, zeroed when off,
    coherent across `reset_stats`, equal to the reference server's for
    the same options, and the pool's own accounting beside it."""
    ref_srv, port_srv = _servers(tiny, max_prompt_len=8, max_new_tokens=2,
                                 max_slots=1, **qkw)
    srv, jsrv = port_srv(), ref_srv()
    try:
        st = srv.stats()["quantization"]
        assert set(st) == KEYS
        assert st == jsrv.stats()["quantization"]
        srv.reset_stats()
        assert srv.stats()["quantization"] == st
        on = bool(qkw)
        assert st["enabled"] is on
        assert st["mode"] == ("none" if not qkw.keys() - {"kv_dtype"}
                              else "w8a16")
        assert (st["kv_scale_bytes"] > 0) == ("kv_dtype" in qkw)
        assert st["kv_pool_bytes_total"] > 0
        kv = srv.stats()["kv_cache"]
        assert kv["scale_bytes"] == st["kv_scale_bytes"]
        assert kv["kv_dtype"] == st["kv_dtype"]
        if "weight_quant" in qkw:
            assert srv.quantization == jsrv.quantization == "w8a16"
    finally:
        srv.stop()
        jsrv.stop()


def test_pool_byte_accounting_matches_reference():
    """`test_byte_accounting_halves_under_int8`'s twin: bf16 dense against
    int8 pools, every byte figure equal to the reference pool's."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache

    keys = ("kv_dtype", "pool_bytes_total", "pool_bytes_per_token",
            "scale_bytes")
    for kvd in (None, "int8"):
        j = JCache(2, 2, 32, block_size=4, num_blocks=8, dtype=jnp.bfloat16,
                   kv_dtype=kvd).stats()
        c = PagedKVCache(2, 2, 32, block_size=4, num_blocks=8,
                         dtype=torch.bfloat16, kv_dtype=kvd, device="cpu")
        st = c.stats()
        assert {k: st[k] for k in keys} == {k: j[k] for k in keys}
        assert c.stats_kv_dtype() == ("int8" if kvd else "bfloat16")
    dense = PagedKVCache(2, 2, 32, block_size=4, num_blocks=8,
                         dtype=torch.bfloat16, device="cpu")
    quant = PagedKVCache(2, 2, 32, block_size=4, num_blocks=8,
                         dtype=torch.bfloat16, kv_dtype="int8", device="cpu")
    assert dense.scale_bytes == 0 < quant.scale_bytes
    assert quant.pool_bytes_total < 0.6 * dense.pool_bytes_total


@pytest.mark.parametrize("kw,match", [
    (dict(quantization="w4a16"), "quantization"),
    (dict(weight_quant="int4"), "weight_quant"),
    (dict(kv_dtype="fp8"), "kv_dtype")])
def test_server_validates_quantization_options(tiny, kw, match):
    from paddle_tpu.inference import PagedGenerationServer as JServer

    from paddle_tpu_torch.inference import PagedGenerationServer

    model, _cfg, port, _tcfg = tiny
    with pytest.raises(ValueError, match=match) as got:
        PagedGenerationServer(port, device="cpu", **kw)
    with pytest.raises(ValueError, match=match) as want:
        JServer(model, **kw)
    assert str(got.value) == str(want.value)


def test_server_quantizes_once_at_construction(tiny, monkeypatch):
    """The packed params are made once; every dispatch reads them."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    _model, _cfg, port, tcfg = tiny
    calls = []
    orig = type(port).quantize_weights
    monkeypatch.setattr(type(port), "quantize_weights",
                        lambda self, p=None: calls.append(1) or orig(self, p))
    srv = PagedGenerationServer(port, max_slots=1, block_size=BS,
                                max_prompt_len=8, max_new_tokens=3,
                                quantization="w8a16", device="cpu")
    assert calls == [1]
    assert srv._params["h.0.qkv_proj.weight::w8c"].dtype == torch.int8
    assert "h.0.qkv_proj.weight" not in srv._params
    out, _ = _serve(srv, [np.arange(1, 6, dtype=np.int32)])
    assert out[0].shape == (8,) and calls == [1]
