"""The unified serving round on the port (`PagedDecoder.unified_round`,
`ops.attention.unified_stream_attention`, the server's `unified_round=`
and `async_rounds=`), held to the JAX reference
(`tests/test_unified_round.py`'s suite) in float32 on the CPU, with the
same weights through the weight bridge (`GPT2Config.tiny()`,
`block_size=4`):

  * `TestUnifiedKernel`'s twins: the port's stream attention on a mixed
    stream (a prefill chunk, a decode row, a verify region) against the
    reference's fallback (every row) and against
    `unified_ragged_attention_kernel(interpret=True)` (rows with
    pos >= 0), dense and int8;
  * `unified_round` against the reference decoder's in all 4 sampling
    modes, a mixed round (`window=False`: a completing chunk, a feeding
    chunk, a decode row, a verify row) and a window round, with host
    inputs and with the same inputs through the device carry: vtok,
    accepted, stopped, the counts and the new carry equal, the logits
    within `LOGIT_ATOL` of the reference's packed prefill of the same
    stream;
  * the servers: split == unified == async == the reference's unified
    and async servers, token for token (`TestUnifiedRoundParity`:
    greedy, speculation with mixed sampling, and the composed stack of
    the prefix cache, speculation, W8A16 and int8 KV; the reference's
    sharded and front-door cases wait for their slices), one attention
    dispatch a round with mixed rounds among them (`TestDispatchCount`),
    the split path's multi-dispatch rounds, the rounds schema (the
    reference server's keys) and the constructor's checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import reference_tiny_model, t

torch.set_num_threads(1)

BS = 4
LOGIT_ATOL = 1e-4     # tests/test_torch_decoder.py's float32 limit
MODES = [(False, False), (True, False), (False, True), (True, True)]


def _mode_id(m):
    return f"s{int(m[0])}p{int(m[1])}"


@pytest.fixture(scope="module")
def tiny():
    # tests/test_unified_round.py's weights: paddle.seed(21)
    return reference_tiny_model(21)


# ---- the stream attention ---------------------------------------------------

def _mixed_stream_case(seed=0):
    """The reference test's stream: a prefill chunk (8 tokens of row 0 at
    positions 5..12), a decode row (row 1 at 17) and a verify region
    (1 + 3 tokens of row 2 at 9..12), regions of 8."""
    rs = np.random.RandomState(seed)
    n, bs, h, dh = 10, 8, 8, 8
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 5], [6, 7, 0]], np.int32)
    seg = np.array([0] * 8 + [1] + [0] * 7 + [2] * 4 + [0] * 4, np.int32)
    pos = np.array(list(range(5, 13)) + [17] + [-1] * 7
                   + list(range(9, 13)) + [-1] * 4, np.int32)
    q = rs.randn(len(seg), h, dh).astype(np.float32)
    return q, kb, vb, tables, seg, pos


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_stream_attention_matches_reference_on_a_mixed_stream(quant):
    from paddle_tpu.inference.kv_quant import QuantizedKV, kv_encode
    from paddle_tpu.ops.attention import unified_stream_attention as jusa
    from paddle_tpu.ops.pallas.unified_attention import (
        unified_ragged_attention_kernel)

    from paddle_tpu_torch.inference.kv_quant import QuantizedKV as TQ
    from paddle_tpu_torch.ops.attention import unified_stream_attention

    q, kb, vb, tables, seg, pos = _mixed_stream_case(3 if quant else 0)
    if quant:
        jk = QuantizedKV(*kv_encode(jnp.asarray(kb)))
        jv = QuantizedKV(*kv_encode(jnp.asarray(vb)))
        tk = TQ(t(np.asarray(jk.codes)), t(np.asarray(jk.scales)))
        tv = TQ(t(np.asarray(jv.codes)), t(np.asarray(jv.scales)))
    else:
        jk, jv, tk, tv = jnp.asarray(kb), jnp.asarray(vb), t(kb), t(vb)
    ref = np.asarray(jusa(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                          jnp.asarray(seg), jnp.asarray(pos)))
    ker = np.asarray(unified_ragged_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(seg[::8]),
        jnp.asarray(pos[::8]), q_tile=8, interpret=True))
    out = unified_stream_attention(t(q), tk, tv, t(tables), t(seg),
                                   t(pos)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    valid = pos >= 0
    # the reference test's own limits, kernel against fallback
    np.testing.assert_allclose(out[valid], ker[valid],
                               atol=2e-4 if quant else 2e-5, rtol=0)


# ---- unified_round ----------------------------------------------------------

MODE_PARAMS = {
    (False, False): [dict(), dict(stop_token_ids=(3,)), dict(), dict()],
    (True, False): [dict(), dict(temperature=1.0, top_k=7, seed=5),
                    dict(temperature=0.8, top_p=0.9, min_p=0.05, seed=6),
                    dict(temperature=0.7, seed=9)],
    (False, True): [dict(presence_penalty=0.7),
                    dict(repetition_penalty=1.4, frequency_penalty=0.3),
                    dict(), dict(repetition_penalty=1.2)],
    (True, True): [dict(temperature=1.1, frequency_penalty=0.5, seed=7),
                   dict(),
                   dict(temperature=0.9, top_k=10, repetition_penalty=1.3,
                        presence_penalty=0.2, seed=8),
                   dict(presence_penalty=0.4)],
}
K = 3
K1 = K + 1


def _leaves(c):
    out = []
    for x in (c.k_blocks, c.v_blocks):
        out += [x.codes, x.scales] if hasattr(x, "codes") else [x]
    return out


def round_setup(tiny, mode, kv_dtype=None):
    """Both decoders, pools and stores: slots 0 and 1 hold prompts of 7
    and 5 tokens prefilled (by the reference's packed prefill, K/V copied
    into the port's pool) with their token 0 sampled; slot 2 has 4 of its
    9 prompt tokens prefilled; slot 3 (10 tokens) none."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
    from paddle_tpu.nn.decode import PagedDecoder as JDec
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TCache
    from paddle_tpu_torch.nn.decode import PagedDecoder as TDec
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    model, cfg, port, tcfg = tiny
    jp, _ = model.functional_state()
    H, Dh, V = cfg.num_heads, cfg.hidden_size // cfg.num_heads, \
        cfg.vocab_size
    jc = JCache(cfg.num_layers, H, Dh, block_size=BS, num_blocks=32,
                kv_dtype=kv_dtype)
    tc = TCache(tcfg.num_layers, H, Dh, block_size=BS, num_blocks=32,
                kv_dtype=kv_dtype, device="cpu")
    jd = JDec.for_config(cfg, BS, kv_dtype=kv_dtype)
    jdl = JDec.for_config(cfg, BS, return_logits=True, kv_dtype=kv_dtype)
    td = TDec.for_config(tcfg, BS, return_logits=True, kv_dtype=kv_dtype)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(1, V, (n,)).astype(np.int32)
               for n in (7, 5, 9, 10)]
    js, ts = JStore(4, V), SlotParamStore(4, V, "cpu")
    for i, kw in enumerate(MODE_PARAMS[mode]):
        js.set_slot(i, JParams(**kw), 2000 + i, prompt_ids=prompts[i])
        ts.set_slot(i, SamplingParams(**kw), 2000 + i,
                    prompt_ids=prompts[i])
    chunks = [(0, 0, 7), (1, 0, 5), (2, 0, 4)]
    T = sum(-(-n // 8) * 8 for _r, _s, n in chunks)
    toks, seg = np.zeros(T, np.int32), np.zeros(T, np.int32)
    pos, sidx = np.full(T, -1, np.int32), np.zeros(3, np.int32)
    o = 0
    for r, s0, n in chunks:
        toks[o:o + n], seg[o:o + n] = prompts[r][s0:s0 + n], r
        pos[o:o + n] = np.arange(s0, s0 + n)
        sidx[r] = o + n - 1
        o += -(-n // 8) * 8
    for c in (jc, tc):
        c.ensure_many([(0, 7 + K1 + 1), (1, 5 + K1 + 1), (2, 9), (3, 6)])
    tab = jc.table_array([0, 1, 2], 8)
    jsp, _m = js.packed_args([0, 1, 2], [True, True, False])
    jr = jd.packed_prefill(jp, jnp.asarray(toks), jnp.asarray(seg),
                           jnp.asarray(pos), jnp.asarray(tab),
                           jnp.asarray(sidx), jc.k_blocks, jc.v_blocks, jsp,
                           mode)
    jc.swap_arrays(jr[2], jr[3])
    js.swap_counts(jr[4])
    if mode[1]:
        ts.counts.copy_(torch.from_numpy(np.asarray(js.counts).copy()))
    for a, b in zip(_leaves(jc), _leaves(tc)):
        b.copy_(torch.from_numpy(np.asarray(a).copy()))
    tok0 = np.asarray(jr[0])[:2]
    return dict(jp=jp, tp=port.flat_params(), jc=jc, tc=tc, jd=jd, jdl=jdl,
                td=td, js=js, ts=ts, prompts=prompts, tok0=tok0, V=V,
                rs=rs)


def round_plan(s, window, carry):
    """One round's arrays, laid out as the server's `_plan_round` lays
    them: window=False — a chunk completing slot 2's prompt (5 tokens), a
    chunk of slot 3 still feeding (6 tokens), then slot 0's verify row
    (3 drafts) and slot 1's decode row; window=True — the two step rows
    alone. carry=True: the step rows' token, positions and base step
    come from the carry arrays (async), else from the host."""
    drafts = {0: s["rs"].randint(1, s["V"], (K,)).astype(np.int32),
              1: np.empty((0,), np.int32)}
    rows = [] if window else [("chunk", 2, 4, 5, True),
                              ("chunk", 3, 0, 6, False)]
    rows += [("step", 0), ("step", 1)]
    P = 1
    while P < len(rows):
        P *= 2
    widths = [-(-r[3] // 8) * 8 if r[0] == "chunk" else K1 for r in rows]
    T = P * K1 if window else sum(widths)
    a = dict(toks=np.zeros(T, np.int32), seg=np.zeros(T, np.int32),
             pos=np.full(T, -1, np.int32),
             carry_map=np.full(T, -1, np.int32),
             pos_map=np.full(T, -1, np.int32),
             sample_idx=np.zeros((P, K1), np.int32),
             dlen=np.full(P, -1, np.int32), row_slot=np.full(P, -1, np.int32),
             steps_map=np.full(P, -1, np.int32), steps=np.zeros(P, np.int32))
    emit, slot_rows, o = [False] * P, [None] * P, 0
    ct = np.zeros(4, np.int32)
    cp = np.zeros(4, np.int32)
    cs = np.zeros(4, np.int32)
    for r, (row, w) in enumerate(zip(rows, widths)):
        i = row[1]
        slot_rows[r] = i
        if row[0] == "chunk":
            _k, _i, start, n, done = row
            a["toks"][o:o + n] = s["prompts"][i][start:start + n]
            a["seg"][o:o + n] = r
            a["pos"][o:o + n] = np.arange(start, start + n)
            a["sample_idx"][r] = o + n - 1
            if done:
                a["dlen"][r], a["row_slot"][r] = 0, i
                emit[r] = True
        else:
            d = drafts[i]
            k = d.size
            wpos = s["prompts"][i].size       # token 0 writes here
            a["seg"][o:o + 1 + k] = r
            a["toks"][o + 1:o + 1 + k] = d
            if carry:
                a["carry_map"][o] = i
                a["pos"][o:o + 1 + k] = np.arange(1 + k)
                a["pos_map"][o:o + 1 + k] = i
                a["steps_map"][r] = i
                ct[i], cp[i], cs[i] = s["tok0"][i], wpos, 1
            else:
                a["toks"][o] = s["tok0"][i]
                a["pos"][o:o + 1 + k] = np.arange(wpos, wpos + 1 + k)
                a["steps"][r] = 1
            a["sample_idx"][r] = o + np.minimum(np.arange(K1), k)
            a["dlen"][r], a["row_slot"][r] = k, i
            emit[r] = True
        o += w if not window else K1
    # slots without a row keep a carry that must pass through
    ct[2:] = [11, 12]
    cp[2:] = [40, 41]
    cs[2:] = [5, 6]
    return a, emit, slot_rows, (ct, cp, cs)


def _run_round(s, window, carry, mode):
    from paddle_tpu.sampling import greedy_args as jgreedy

    a, emit, slot_rows, carries = round_plan(s, window, carry)
    P = a["dlen"].size
    tab = s["jc"].table_array(slot_rows, 8)
    jsp, jmode = s["js"].unified_args(slot_rows, emit, a["steps"])
    tsp, tmode = s["ts"].unified_args(slot_rows, emit, a["steps"])
    assert jmode == tmode
    names = ("toks", "seg", "pos")
    rest = ("sample_idx", "dlen", "row_slot", "carry_map", "pos_map",
            "steps_map")
    jr = s["jd"].unified_round(
        s["jp"], *[jnp.asarray(a[n]) for n in names], jnp.asarray(tab),
        *[jnp.asarray(a[n]) for n in rest],
        *[jnp.asarray(c) for c in carries], s["jc"].k_blocks,
        s["jc"].v_blocks, jsp, jmode, window=window)
    tr = s["td"].unified_round(
        s["tp"], *[t(a[n]) for n in names], t(tab), *[t(a[n]) for n in rest],
        *[t(c) for c in carries], s["tc"].k_blocks, s["tc"].v_blocks, tsp,
        tmode, window=window)
    # the logits: the reference's packed prefill of the same stream with
    # the carried values resolved on the host
    toks = a["toks"].copy()
    pos = a["pos"].copy()
    cm = a["carry_map"] >= 0
    toks[cm] = carries[0][a["carry_map"][cm]]
    pm = a["pos_map"] >= 0
    pos[pm] += carries[1][a["pos_map"][pm]]
    lr = s["jdl"].packed_prefill(
        s["jp"], jnp.asarray(toks), jnp.asarray(a["seg"]), jnp.asarray(pos),
        jnp.asarray(tab), jnp.asarray(a["sample_idx"].reshape(-1)),
        s["jc"].k_blocks, s["jc"].v_blocks, jgreedy(P * K1))
    return jr, tr, np.asarray(lr[5])


@pytest.mark.parametrize("window", [False, True], ids=["mixed", "window"])
@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_unified_round_matches_reference(tiny, mode, window):
    """Host inputs and carried inputs: the same outputs as the
    reference's, and the same as each other."""
    outs = {}
    for carry in (False, True):
        s = round_setup(tiny, mode)
        jr, tr, logits = _run_round(s, window, carry, mode)
        for n, name in ((0, "vtok"), (1, "accepted"), (2, "stopped"),
                        (6, "carry_tok"), (7, "carry_pos"),
                        (8, "carry_steps")):
            np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]),
                                          err_msg=f"{name} carry={carry}")
        if mode[1]:
            np.testing.assert_array_equal(tr[5].numpy(), np.asarray(jr[5]))
        else:
            assert tr[5] is None and jr[5] is None
        P = tr[0].shape[0]
        np.testing.assert_allclose(tr[9].reshape(P * K1, -1).numpy(),
                                   logits, atol=LOGIT_ATOL, rtol=0)
        outs[carry] = [x.numpy() for x in tr[:3]]
        ct = tr[6].numpy()
        assert ct[3] == 12  # a feeding row leaves its slot's carry
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_unified_round_int8_pool_matches_reference(tiny):
    mode = (True, True)
    s = round_setup(tiny, mode, kv_dtype="int8")
    jr, tr, logits = _run_round(s, False, True, mode)
    for n in (0, 1, 2, 6, 7, 8, 5):
        np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]))
    P = tr[0].shape[0]
    np.testing.assert_allclose(tr[9].reshape(P * K1, -1).numpy(), logits,
                               atol=LOGIT_ATOL * 10, rtol=0)


# ---- the servers ------------------------------------------------------------

BASE_KW = dict(max_slots=2, block_size=BS, max_new_tokens=10,
               prefill_chunk_tokens=8)


def _serve(srv, prompts, sampling=None):
    try:
        futs = [srv.submit(p, sampling=None if sampling is None
                           else sampling(i)) for i, p in enumerate(prompts)]
        srv.start()
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


def _mixed_sampling(i, cls):
    if i % 2 == 0:
        return None
    return cls(temperature=0.8, top_p=0.9, seed=100 + i,
               repetition_penalty=1.2)


def _spec(value, ref):
    """True stays True; a SpecConfig dict becomes each side's class."""
    if not isinstance(value, dict):
        return value
    if ref:
        from paddle_tpu.spec_decode import SpecConfig as JSpec

        return JSpec(**value)
    from paddle_tpu_torch.spec_decode import SpecConfig

    return SpecConfig(**value)


class TestUnifiedRoundParity:
    """split == unified == async on the port, and == the reference's
    unified and async servers with the same options."""

    def _prompts(self, cfg, n=4, repetitive=True):
        rng = np.random.RandomState(7)
        if repetitive:
            base = rng.randint(1, cfg.vocab_size, (6,)).astype(np.int32)
            return [np.tile(base, 3)[:14 + i].astype(np.int32)
                    for i in range(n)]
        return [rng.randint(1, cfg.vocab_size,
                            (int(rng.randint(4, 20)),)).astype(np.int32)
                for _ in range(n)]

    def _assert_parity(self, tiny, prompts, sampled=False, **extra):
        from paddle_tpu.inference import PagedGenerationServer as JServer
        from paddle_tpu.sampling import SamplingParams as JParams

        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.sampling import SamplingParams

        def port(**kw):
            kw = dict(BASE_KW, **extra, **kw)
            kw["speculation"] = _spec(kw.get("speculation"), False)
            return PagedGenerationServer(tiny[2], device="cpu", **kw)

        def ref(**kw):
            kw = dict(BASE_KW, **extra, **kw)
            kw["speculation"] = _spec(kw.get("speculation"), True)
            return JServer(tiny[0], **kw)

        tfn = (lambda i: _mixed_sampling(i, SamplingParams)) if sampled \
            else None
        jfn = (lambda i: _mixed_sampling(i, JParams)) if sampled else None
        split, st_s = _serve(port(), prompts, tfn)
        uni, st_u = _serve(port(unified_round=True), prompts, tfn)
        asy, st_a = _serve(port(async_rounds=True), prompts, tfn)
        runi, _ = _serve(ref(unified_round=True), prompts, jfn)
        rasy, _ = _serve(ref(async_rounds=True), prompts, jfn)
        for i, a in enumerate(split):
            for name, b in (("unified", uni), ("async", asy),
                            ("reference unified", runi),
                            ("reference async", rasy)):
                np.testing.assert_array_equal(a, b[i],
                                              err_msg=f"{name} request {i}")
        for st in (st_u, st_a):
            assert st["rounds"]["unified"] is True
            assert st["rounds"]["dispatches_per_round"] == 1.0
        assert st_a["rounds"]["async"] is True
        assert st_s["rounds"]["unified"] is False
        return st_s, st_u, st_a

    def test_parity_greedy_plain(self, tiny):
        self._assert_parity(tiny, self._prompts(tiny[1], repetitive=False))

    def test_parity_speculation_mixed_sampling(self, tiny):
        _s, st_u, st_a = self._assert_parity(
            tiny, self._prompts(tiny[1]), sampled=True,
            speculation=dict(max_draft_tokens=3))
        for st in (st_u, st_a):
            sp = st["speculation"]
            assert sp["proposed_tokens"] > 0
            assert sp["proposed_tokens"] == (sp["accepted_tokens"]
                                             + sp["rolled_back_tokens"])
            assert sp["accepted_tokens"] > 0

    def test_parity_full_composed_stack(self, tiny):
        """The prefix cache, speculation, W8A16, int8 KV and mixed
        sampling at once."""
        self._assert_parity(tiny, self._prompts(tiny[1]), sampled=True,
                            speculation=True, enable_prefix_cache=True,
                            quantization="w8a16", kv_dtype="int8")


class TestDispatchCount:
    def test_mixed_round_is_one_attention_dispatch(self, tiny):
        """A round with prefill chunk rows, a decode row and verify work
        is ONE dispatch, and the split programs never run. The reference
        test waits for A's first token through the front door's
        `on_token`; here B is submitted once A's slot holds a token."""
        import time

        from paddle_tpu_torch.inference import PagedGenerationServer

        cfg = tiny[1]
        rng = np.random.RandomState(5)
        base = rng.randint(1, cfg.vocab_size, (5,)).astype(np.int32)
        pa = np.tile(base, 4)[:18].astype(np.int32)
        pb = rng.randint(1, cfg.vocab_size, (15,)).astype(np.int32)
        srv = PagedGenerationServer(tiny[2], max_slots=2, block_size=BS,
                                    max_new_tokens=30,
                                    prefill_chunk_tokens=5,
                                    speculation=True, unified_round=True,
                                    device="cpu")
        calls = {"unified": 0, "split": 0}
        dec = srv._decoder
        real_unified = dec.unified_round

        def count_unified(*a, **k):
            calls["unified"] += 1
            return real_unified(*a, **k)

        def count_split(*a, **k):
            calls["split"] += 1
            raise AssertionError("split program dispatched on the "
                                 "unified engine")

        dec.unified_round = count_unified
        dec.packed_prefill = count_split
        dec.step = count_split
        dec.packed_verify = count_split
        dec.multistep = count_split
        srv.start()
        try:
            fa = srv.submit(pa)
            t0 = time.monotonic()
            while not any(s is not None and s["toks"]
                          for s in list(srv._slots)):
                assert time.monotonic() - t0 < 120 and not fa.done()
                time.sleep(0.001)
            fb = srv.submit(pb)
            fa.result(timeout=600)
            fb.result(timeout=600)
            st = srv.stats()
        finally:
            srv.stop()
        rd = st["rounds"]
        assert rd["dispatches_per_round"] == 1.0, rd
        assert rd["attention_dispatches"] == rd["rounds"] == calls["unified"]
        assert calls["split"] == 0
        assert rd["mixed_rounds"] >= 1, rd
        assert st["speculation"]["proposed_tokens"] > 0
        assert st["speculation"]["verify_dispatches"] >= 1

    def test_split_path_reports_multi_dispatch_rounds(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as JServer

        from paddle_tpu_torch.inference import PagedGenerationServer

        rng = np.random.RandomState(5)
        prompts = [rng.randint(1, tiny[1].vocab_size, (15,)).astype(np.int32)
                   for _ in range(3)]
        kw = dict(max_slots=2, block_size=BS, max_new_tokens=8,
                  prefill_chunk_tokens=5)
        outs, st = _serve(PagedGenerationServer(tiny[2], device="cpu", **kw),
                          prompts)
        routs, rst = _serve(JServer(tiny[0], **kw), prompts)
        for a, b in zip(outs, routs):
            np.testing.assert_array_equal(a, b)
        rd = st["rounds"]
        assert rd["unified"] is False and rd["async"] is False
        assert rd["rounds"] >= 1
        assert rd["attention_dispatches"] >= rd["rounds"]
        assert rd["overlap_seconds"] == 0.0
        assert rd["mixed_rounds"] >= 1
        assert rd["dispatches_per_round"] > 1.0
        assert rst["rounds"]["dispatches_per_round"] > 1.0


def test_rounds_stats_schema_and_reset(tiny):
    """The reference server's keys; zero before any round; reset."""
    from paddle_tpu.inference import PagedGenerationServer as JServer

    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(tiny[2], max_slots=2, block_size=BS,
                                max_new_tokens=4, device="cpu")
    rd = srv.stats()["rounds"]
    assert set(rd) == set(JServer(tiny[0], max_slots=2, block_size=BS,
                                  max_new_tokens=4).stats()["rounds"])
    assert rd["rounds"] == 0 and rd["overlap_seconds"] == 0.0
    srv.start()
    try:
        srv.submit([1, 2, 3]).result(timeout=600)
        assert srv.stats()["rounds"]["rounds"] >= 1
        srv.reset_stats()
        rd = srv.stats()["rounds"]
        assert rd["rounds"] == 0
        assert rd["attention_dispatches"] == 0
        assert rd["mixed_rounds"] == 0
    finally:
        srv.stop()


def test_unified_requires_single_step_dispatch(tiny):
    from paddle_tpu_torch.inference import PagedGenerationServer

    with pytest.raises(ValueError, match="steps_per_dispatch"):
        PagedGenerationServer(tiny[2], unified_round=True,
                              steps_per_dispatch=4, device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        PagedGenerationServer(tiny[2], async_rounds=True,
                              steps_per_dispatch=2, device="cpu")


def test_async_round_overlaps_and_stops_clean(tiny):
    """Async rounds count host time hidden behind a round in flight, and
    a stop with requests resident leaves no round in flight."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, tiny[1].vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(3, 12, 4)]
    srv = PagedGenerationServer(tiny[2], max_slots=2, block_size=BS,
                                max_new_tokens=6, prefill_chunk_tokens=8,
                                async_rounds=True, device="cpu")
    outs, st = _serve(srv, prompts)
    assert st["rounds"]["overlap_seconds"] > 0.0
    assert srv._pending is None
    assert all(o.size == p.size + 6 for o, p in zip(outs, prompts))
