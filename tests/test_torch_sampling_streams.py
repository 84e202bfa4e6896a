"""The port's per-request PRNG streams and the whole sampled pipeline held
to the reference on the CPU.

  * `sampling.prng` against `jax.random` (jax_threefry_partitionable):
    threefry2x32 on a known answer and on random words, the keys of
    `fold_in(PRNGKey(seed), step)`, `jax.random.bits` and the uniforms bit
    for bit, and `jax.random.gumbel` within 4 ulp, at V 50257 and at a
    small odd V, for the seeds {0, 1, 2^31, 2^32 - 1} and four from a
    RandomState, at the steps {0, 1, 31, 2^31 - 1};
  * `sample_tokens` token-identical to the reference's over 64 seeds, in
    every mode, with rows mixing greedy, temperature, top-k, top-p, min-p
    and the three penalties;
  * `PagedDecoder.packed_prefill`, `step` and `multistep(4, mode)` on
    GPT2Config.tiny() against the reference `PagedDecoder`: identical
    tokens and count buffers in every mode;
  * the port's `PagedGenerationServer` against the reference server with
    the same seeds on a pinned tiny workload (greedy, sampled, top-k,
    top-p, min-p, penalties, stop ids, stop strings) at k = 1 and k = 4:
    identical tokens.

The Gumbel tolerance: `-log(-log(u))` in torch and in XLA round `log`
differently by an ulp or two (the uniforms are bitwise equal). Near
g = 0 the error is that of the inner -log(u) relative to its size, so the
ulp is taken at max(|g|, 1): |g - g_ref| <= 4 * spacing(max(|g_ref|, 1)).
Token identity holds wherever the top two of `filt + gumbel` are further
apart than that; the draws here have no closer margin (the tests check
the margin of the 64-seed sweep)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_twin_util import reference_tiny_model, t

from paddle_tpu_torch.sampling import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 2**31, 2**32 - 1] + [int(s) for s in np.random.RandomState(
    2026).randint(0, 2**32, 4, dtype=np.uint64)]
STEPS = [0, 1, 31, 2**31 - 1]
GUMBEL_ULPS = 4


def _grid():
    """Every (seed, step) pair: [32] uint32 seeds and int32 steps."""
    s, k = np.meshgrid(np.array(SEEDS, np.uint64), np.array(STEPS),
                       indexing="ij")
    return s.reshape(-1).astype(np.uint32), k.reshape(-1).astype(np.int32)


def _ref_keys(seeds, steps):
    from paddle_tpu.sampling.processors import fold_in_keys

    return fold_in_keys(jnp.asarray(seeds), jnp.asarray(steps))


def _port_keys(seeds, steps):
    return prng.fold_in_keys(torch.from_numpy(seeds.astype(np.int64)),
                             torch.from_numpy(steps))


def test_threefry_known_answer():
    """Threefry-2x32 (20 rounds) on the Random123 known answer that
    JAX's own tests use, and on random words against JAX's primitive."""
    from jax._src import prng as jprng

    k = torch.tensor([0x13198A2E, 0x03707344])
    x = torch.tensor([0x243F6A88, 0x85A308D3])
    o0, o1 = prng.threefry2x32(k[0], k[1], x[0], x[1])
    assert (int(o0), int(o1)) == (0xC4923A9C, 0x483DF7A0)
    rs = np.random.RandomState(0)
    key = rs.randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    words = rs.randint(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                         jnp.asarray(words)))
    kt = torch.from_numpy(key.astype(np.int64))
    wt = torch.from_numpy(words.astype(np.int64))
    o0, o1 = prng.threefry2x32(kt[0], kt[1], wt[:32], wt[32:])
    np.testing.assert_array_equal(torch.cat([o0, o1]).numpy(),
                                  ref.astype(np.int64))


def test_fold_in_keys_match_jax_bitwise():
    seeds, steps = _grid()
    got = _port_keys(seeds, steps).numpy()
    ref = np.asarray(_ref_keys(seeds, steps)).astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    # counter-based: one (seed, step) gives one key whatever its row
    perm = np.random.RandomState(1).permutation(seeds.size)
    np.testing.assert_array_equal(
        _port_keys(seeds[perm], steps[perm]).numpy(), got[perm])


@pytest.mark.parametrize("V", [50257, 37])
def test_bits_and_uniform_match_jax_bitwise(V):
    seeds, steps = _grid()
    if V > 1000:                  # the eight rows of chip_smoke phase 4s
        seeds, steps = seeds[::4], steps[[0, 1, 2, 3] * 2]
    keys = _port_keys(seeds, steps)
    jkeys = _ref_keys(seeds, steps)
    bits = prng.random_bits(keys, V).numpy()
    jbits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (V,), jnp.uint32))(jkeys))
    np.testing.assert_array_equal(bits, jbits.astype(np.int64))
    u = prng.uniform(keys, V).numpy()
    tiny = np.finfo(np.float32).tiny
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), jnp.float32, minval=tiny, maxval=1.0))(jkeys))
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    assert u.dtype == np.float32 and u.min() >= tiny and u.max() < 1.0


@pytest.mark.parametrize("V", [50257, 37])
def test_gumbel_within_4_ulp(V):
    seeds, steps = _grid()
    if V > 1000:
        seeds, steps = seeds[::4], steps[[0, 1, 2, 3] * 2]
    g = prng.gumbel(_port_keys(seeds, steps), V).numpy()
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (V,), jnp.float32))(_ref_keys(seeds, steps)))
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    err = np.abs(g.astype(np.float64) - jg) / ulp
    assert err.max() <= GUMBEL_ULPS, err.max()


# ---- sample_tokens --------------------------------------------------------

MODES = [(False, False), (True, False), (False, True), (True, True)]


def _mode_id(m):
    return f"s{int(m[0])}p{int(m[1])}"


def _sp_columns(rs, R, V, mode, seed):
    """One dispatch's per-row columns: rows mixing greedy, temperature,
    top-k, top-p, min-p and the penalties (the columns of the mode)."""
    sampled, penalties = mode
    sp = {}
    if sampled:
        temp = np.array([0.0, 1.0, 0.7, 1.3, 0.9, 1.0, 0.0, 2.0],
                        np.float32)[:R]
        sp.update(
            temperature=temp, sample=temp > 0,
            top_k=np.array([0, 0, 5, 0, 20, 3, 0, 0], np.int32)[:R],
            top_p=np.array([1.0, 1.0, 1.0, 0.85, 0.9, 1.0, 0.7, 0.95],
                           np.float32)[:R],
            min_p=np.array([0.0, 0.0, 0.0, 0.0, 0.05, 0.1, 0.0, 0.02],
                           np.float32)[:R],
            seeds=(seed * 7919 + np.arange(R) * 104729).astype(np.uint32),
            steps=rs.randint(0, 2**31 - 1, R).astype(np.int32))
    if penalties:
        sp.update(
            rep=np.array([1.0, 1.2, 1.0, 0.8, 1.5, 1.0, 1.1, 1.3],
                         np.float32)[:R],
            pres=np.array([0.0, 0.0, 0.5, 0.0, 0.3, -0.2, 0.4, 0.1],
                          np.float32)[:R],
            freq=np.array([0.0, 0.1, 0.0, 0.2, 0.0, 0.3, 0.05, 0.2],
                          np.float32)[:R],
            counts=(rs.randint(0, 3, (R, V)) * (rs.rand(R, V) < 0.2))
            .astype(np.int32))
    return sp


def _port_sp(sp):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in sp.items()}
    if "seeds" in out:
        out["seeds"] = out["seeds"].to(torch.int64)
    return out


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_sample_tokens_match_reference_over_64_seeds(mode):
    """Token-identical to the reference pipeline for 64 seeds of logits,
    PRNG seeds and steps, in the given mode."""
    from paddle_tpu.sampling import processors as jproc

    R, V = 8, 211
    fn = jax.jit(lambda lg, sp: jproc.sample_tokens(
        lg, sp, sampled=mode[0], penalties=mode[1]))
    worst = np.inf
    for seed in range(64):
        rs = np.random.RandomState(seed)
        logits = (rs.randn(R, V) * 2.0).astype(np.float32)
        sp = _sp_columns(rs, R, V, mode, seed)
        got = _port_sample(logits, sp, mode)
        ref = np.asarray(fn(jnp.asarray(logits),
                            {k: jnp.asarray(v) for k, v in sp.items()}))
        np.testing.assert_array_equal(got, ref, err_msg=f"seed {seed}")
        if mode[0]:
            worst = min(worst, _margin(logits, sp, mode))
    if mode[0]:
        # the draws compared are decided by more than the noise's error
        assert worst > 1e-5, worst


def _port_sample(logits, sp, mode):
    from paddle_tpu_torch.sampling import processors as proc

    return proc.sample_tokens(torch.from_numpy(logits), _port_sp(sp),
                              sampled=mode[0], penalties=mode[1]).numpy()


def _margin(logits, sp, mode):
    """The smallest top-two gap of `filt + gumbel` over the sampled rows
    (the port's own values)."""
    from paddle_tpu_torch.sampling import processors as proc

    tsp = _port_sp(sp)
    lg = torch.from_numpy(logits)
    if mode[1]:
        lg = proc.apply_penalties(lg, tsp["counts"], tsp["rep"],
                                  tsp["pres"], tsp["freq"])
    scaled = lg / torch.clamp_min(tsp["temperature"], 1e-6)[:, None]
    filt = proc.filter_logits(scaled, tsp["top_k"], tsp["top_p"],
                              tsp["min_p"])
    z = filt + prng.gumbel(prng.fold_in_keys(tsp["seeds"], tsp["steps"]),
                           lg.shape[-1])
    top2 = torch.topk(z, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])[tsp["sample"]]
    return float(gap.min())


def test_greedy_mode_is_a_bare_argmax(monkeypatch):
    """The greedy variant runs no sort and no PRNG."""
    from paddle_tpu_torch.sampling import processors as proc

    def boom(*a, **kw):
        raise AssertionError("the greedy variant sorted or drew noise")

    monkeypatch.setattr(proc, "filter_logits", boom)
    monkeypatch.setattr(proc.prng, "gumbel", boom)
    lg = torch.randn(4, 50)
    tok = proc.sample_tokens(lg, {}, sampled=False, penalties=False)
    assert torch.equal(tok, torch.argmax(lg, -1).to(torch.int32))


# ---- the decoder programs ------------------------------------------------

BS = 4

MODE_PARAMS = {
    (False, False): [dict(), dict(stop_token_ids=(3,)), dict()],
    (True, False): [dict(), dict(temperature=1.0, top_k=7, seed=5),
                    dict(temperature=0.8, top_p=0.9, min_p=0.05, seed=6)],
    (False, True): [dict(presence_penalty=0.7),
                    dict(repetition_penalty=1.4, frequency_penalty=0.3),
                    dict()],
    (True, True): [dict(temperature=1.1, frequency_penalty=0.5, seed=7),
                   dict(),
                   dict(temperature=0.9, top_k=10, repetition_penalty=1.3,
                        presence_penalty=0.2, seed=8)],
}


@pytest.fixture(scope="module")
def models():
    return reference_tiny_model(31)


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_decoder_programs_match_reference(models, mode):
    """packed_prefill (with a padding row), step and multistep(4, mode)
    over three slots on both sides: identical tokens and count
    buffers."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
    from paddle_tpu.nn.decode import PagedDecoder as JDec
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TCache
    from paddle_tpu_torch.nn.decode import PagedDecoder as TDec
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    model, cfg, port, tcfg = models
    jparams, _ = model.functional_state()
    tparams = port.flat_params()
    H, Dh, V = cfg.num_heads, cfg.hidden_size // cfg.num_heads, \
        cfg.vocab_size
    jc = JCache(cfg.num_layers, H, Dh, block_size=BS, num_blocks=24)
    tc = TCache(tcfg.num_layers, H, Dh, block_size=BS, num_blocks=24,
                device="cpu")
    jdec = JDec.for_config(cfg, BS)
    tdec = TDec.for_config(tcfg, BS)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, V, (n,)).astype(np.int32) for n in (7, 5, 9)]
    js, ts = JStore(3, V), SlotParamStore(3, V, "cpu")
    for i, kw in enumerate(MODE_PARAMS[mode]):
        seed = 1000 + i
        js.set_slot(i, JParams(**kw), seed, prompt_ids=prompts[i])
        ts.set_slot(i, SamplingParams(**kw), seed, prompt_ids=prompts[i])
    assert ts.mode() == js.mode() == mode

    def compare(what, jr, tr, rows=slice(None)):
        np.testing.assert_array_equal(tr[0].numpy()[..., rows],
                                      np.asarray(jr[0])[..., rows],
                                      err_msg=what)
        np.testing.assert_array_equal(tr[1].numpy()[..., rows],
                                      np.asarray(jr[1])[..., rows],
                                      err_msg=what)
        if mode[1]:
            np.testing.assert_array_equal(tr[4].numpy(), np.asarray(jr[4]),
                                          err_msg=what)
        else:
            assert tr[4] is None and jr[4] is None
        js.swap_counts(jr[4])
        ts.swap_counts(tr[4])
        jc.swap_arrays(jr[2], jr[3])

    # packed prefill: three fresh prompts and a padding row
    T = sum(-(-p.size // 8) * 8 for p in prompts)
    toks = np.zeros(T, np.int32)
    seg = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    sidx = np.zeros(4, np.int32)
    o = 0
    for r, p in enumerate(prompts):
        toks[o:o + p.size] = p
        seg[o:o + p.size] = r
        pos[o:o + p.size] = np.arange(p.size)
        sidx[r] = o + p.size - 1
        o += -(-p.size // 8) * 8
    for c in (jc, tc):
        c.ensure_many([(r, p.size + 6) for r, p in enumerate(prompts)])
    tab = jc.table_array([0, 1, 2, None], 4)
    rows, done = [0, 1, 2, None], [True, True, True, False]
    jsp, jmode = js.packed_args(rows, done)
    tsp, tmode = ts.packed_args(rows, done)
    assert jmode == tmode == mode
    jr = jdec.packed_prefill(jparams, jnp.asarray(toks), jnp.asarray(seg),
                             jnp.asarray(pos), jnp.asarray(tab),
                             jnp.asarray(sidx), jc.k_blocks, jc.v_blocks,
                             jsp, jmode)
    tr = tdec.packed_prefill(tparams, t(toks), t(seg), t(pos), t(tab),
                             t(sidx), tc.k_blocks, tc.v_blocks, tsp, tmode)
    compare("packed_prefill", jr, tr, slice(0, 3))
    tok = np.asarray(jr[0])[:3]
    # one decode step at PRNG step 1, then four at steps 2..5
    lens = np.array([p.size for p in prompts], np.int32)
    tab = jc.table_array([0, 1, 2], 4)
    act = np.ones(3, bool)
    steps = np.ones(3, np.int32)
    jsp, jmode = js.step_args(steps)
    tsp, tmode = ts.step_args(steps)
    jr = jdec.step(jparams, jnp.asarray(tok), jnp.asarray(lens),
                   jnp.asarray(act), jnp.asarray(tab), jc.k_blocks,
                   jc.v_blocks, jsp, jmode)
    tr = tdec.step(tparams, t(tok), t(lens), t(act), t(tab), tc.k_blocks,
                   tc.v_blocks, tsp, tmode)
    compare("step", jr, tr)
    tok = np.asarray(jr[0])
    jsp, jmode = js.step_args(steps + 1)
    tsp, tmode = ts.step_args(steps + 1)
    jr = jdec.multistep(4, jmode)(jparams, jnp.asarray(tok),
                                  jnp.asarray(lens + 1), jnp.asarray(act),
                                  jnp.asarray(tab), jc.k_blocks,
                                  jc.v_blocks, jsp)
    tr = tdec.multistep(4, tmode)(tparams, t(tok), t(lens + 1), t(act),
                                  t(tab), tc.k_blocks, tc.v_blocks, tsp)
    compare("multistep(4)", jr, tr)


def test_multistep_draws_the_streams_of_single_steps(models):
    """multistep(4, mode) equals four calls of step at PRNG steps s..s+3
    with the counts threaded, on the port alone."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    _model, _cfg, port, tcfg = models
    params = port.flat_params()
    H, Dh, V = tcfg.num_heads, tcfg.hidden_size // tcfg.num_heads, \
        tcfg.vocab_size
    rs = np.random.RandomState(8)
    prompts = [rs.randint(1, V, (n,)).astype(np.int32) for n in (3, 4)]
    lens = np.array([3, 4], np.int32)
    runs = []
    for fused in (False, True):
        cache = PagedKVCache(tcfg.num_layers, H, Dh, block_size=BS,
                             num_blocks=12, device="cpu")
        cache.ensure_many([(0, 12), (1, 12)])
        tab = t(cache.table_array([0, 1], 3))
        store = SlotParamStore(2, V, "cpu")
        for i, kw in enumerate([dict(temperature=1.5, seed=1,
                                     presence_penalty=0.6),
                                dict(temperature=0.7, top_p=0.8, seed=2)]):
            store.set_slot(i, SamplingParams(**kw), 100 + i,
                           prompt_ids=prompts[i])
        dec = PagedDecoder.for_config(tcfg, BS)
        # write the prompts through single steps (the cache's contents)
        for j in range(int(lens.max())):
            act = torch.from_numpy(lens > j)
            tok = t([p[min(j, p.size - 1)] for p in prompts])
            sp, mode = store.step_args(np.zeros(2, np.int32))
            dec.step(params, tok, t(np.full(2, j, np.int32)), act, tab,
                     cache.k_blocks, cache.v_blocks, sp, mode)
        tok = t([5, 9])
        sp, mode = store.step_args(np.array([3, 3], np.int32))
        if fused:
            toks, _st, _k, _v, counts = dec.multistep(4, mode)(
                params, tok, t(lens), torch.ones(2, dtype=torch.bool), tab,
                cache.k_blocks, cache.v_blocks, sp)
        else:
            out, counts = [], sp["counts"]
            for j in range(4):
                spj = dict(sp, steps=sp["steps"] + j, counts=counts)
                tok, _st, _k, _v, counts = dec.step(
                    params, tok, t(lens + j), torch.ones(2, dtype=torch.bool),
                    tab, cache.k_blocks, cache.v_blocks, spj, mode)
                out.append(tok)
            toks = torch.stack(out)
        runs.append((toks, counts))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# ---- the server against the reference server ------------------------------

def _detok(toks):
    return "".join(f"<{int(x)}>" for x in toks)


def _workload(vocab, stops=None):
    """Nine pinned requests: greedy, sampled, top-k, top-p, min-p, the
    penalties with and without sampling, and two that get stop ids and
    a stop string (`stops`: {index: gen tokens of a run without them})."""
    from paddle_tpu.sampling import SamplingParams as JParams

    from paddle_tpu_torch.sampling import SamplingParams

    rs = np.random.RandomState(21)
    prompts = [rs.randint(1, vocab, (n,)).astype(np.int32)
               for n in (3, 12, 7, 16, 5, 9, 4, 11, 6)]
    kws = [dict(),
           dict(temperature=1.0, seed=5),
           dict(temperature=0.8, top_k=5, seed=6),
           dict(temperature=1.2, top_p=0.8, seed=7),
           dict(temperature=1.0, min_p=0.2, seed=8),
           dict(temperature=0.9, repetition_penalty=1.3,
                presence_penalty=0.4, frequency_penalty=0.3, seed=9),
           dict(presence_penalty=0.8),
           dict(temperature=1.0, seed=10),
           dict(temperature=1.1, top_p=0.95)]           # an auto seed
    if stops is not None:
        kws[7]["stop_token_ids"] = (int(stops[7][2]),)
        kws[8]["stop_strings"] = (_detok(stops[8][1:3]),)
    return ([(p, SamplingParams(**kw)) for p, kw in zip(prompts, kws)],
            [(p, JParams(**kw)) for p, kw in zip(prompts, kws)])


SERVER_KW = dict(max_slots=3, block_size=4, max_prompt_len=16,
                 max_new_tokens=6, prefill_chunk_tokens=10, seed=42)


def _run_port(port, work, k):
    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(port, steps_per_dispatch=k,
                                detokenize=_detok, device="cpu",
                                **SERVER_KW).start()
    try:
        outs = [f.result(timeout=120) for f in
                [srv.submit(p, sampling=s) for p, s in work]]
        return outs, srv.stats()["stop_reasons"]
    finally:
        srv.stop()


@pytest.mark.parametrize("k", [1, 4])
def test_server_tokens_equal_reference_server(models, k):
    from paddle_tpu.inference import PagedGenerationServer as JServer

    model, cfg, port, tcfg = models
    twork, _ = _workload(tcfg.vocab_size)
    first, _ = _run_port(port, twork, 1)
    gen = {i: first[i][twork[i][0].size:] for i in (7, 8)}
    twork, jwork = _workload(tcfg.vocab_size, gen)
    outs, reasons = _run_port(port, twork, k)
    assert reasons["stop_token"] == 1 and reasons["stop_string"] == 1
    jsrv = JServer(model, steps_per_dispatch=k, detokenize=_detok,
                   **SERVER_KW).start()
    try:
        ref = [f.result(timeout=300) for f in
               [jsrv.submit(p, sampling=s) for p, s in jwork]]
    finally:
        jsrv.stop()
    for i, (r, o) in enumerate(zip(ref, outs)):
        np.testing.assert_array_equal(o, np.asarray(r), err_msg=f"req {i}")
    # the stops only cut the streams of the run without them, where the
    # stop id or string first appears
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, first[i][:o.size])
    n7 = list(gen[7]).index(gen[7][2]) + 1
    n8 = next(n for n in range(1, 7) if _detok(gen[8][1:3])
              in _detok(gen[8][:n]))
    assert outs[7].size == twork[7][0].size + n7
    assert outs[8].size == twork[8][0].size + n8
