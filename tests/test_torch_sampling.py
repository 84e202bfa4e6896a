"""The port's sampling subsystem (paddle_tpu_torch/sampling/, ops/search.py)
held to the reference's on the CPU: SamplingParams validation, the
processors (`apply_penalties` bitwise, the keep mask of `filter_logits`
identical, greedy readout and `check_stops`), `topk_impl` (the twins of
tests/test_sampling.py's TestTopkOp), `SlotParamStore`'s argument dicts
column by column, and the server twins of tests/test_sampling.py's
TestMixedBatchOneDispatch, TestSeededStreams, TestStopHandling, the
server tests of TestPenalties, `test_submit_type_error` and
`test_stop_strings_need_detokenizer`, plus a detokenizer that raises.

Where the reference tests compare with the reference's own `generate`,
these compare with `dense_greedy` (torch_twin_util), a plain
full-recompute greedy decode of the same weights. The PRNG streams and
the whole sampled pipeline against the reference are in
test_torch_sampling_streams.py.

The top-p boundary: the frameworks' cumulative sums add in different
orders, so `cum < top_p` may flip where a cumulative probability lies
within an ulp of top_p. The filter twins draw their logits from a numpy
seed and first assert that no cumulative probability lies within 1e-5
of its row's top_p, and no token probability within 1e-5 (relative) of
its row's min_p threshold."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import dense_greedy, reference_tiny_model

from paddle_tpu_torch.sampling import GREEDY_MODE, SamplingParams
from paddle_tpu_torch.sampling import SlotParamStore
from paddle_tpu_torch.sampling import processors as proc

torch.set_num_threads(1)


@pytest.mark.parametrize("kw,field", [
    (dict(temperature=-0.1), "temperature"),
    (dict(temperature=math.nan), "temperature"),
    (dict(temperature=math.inf), "temperature"),
    (dict(top_k=-1), "top_k"),
    (dict(top_k=1.5), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
    (dict(min_p=1.0), "min_p"),
    (dict(min_p=-0.1), "min_p"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(presence_penalty=math.nan), "presence_penalty"),
    (dict(frequency_penalty=math.inf), "frequency_penalty"),
    (dict(stop_token_ids=(3, -1)), "stop_token_ids"),
    (dict(stop_strings=("",)), "stop_strings"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(seed="x"), "seed"),
])
def test_params_validation_names_field(kw, field):
    """Every bad value fails at construction, naming the field — the
    reference's eager-validation contract, on the port's copy."""
    from paddle_tpu.sampling import SamplingParams as JParams

    with pytest.raises(ValueError, match=field):
        SamplingParams(**kw)
    with pytest.raises(ValueError, match=field):
        JParams(**kw)


def test_params_normalization_matches_reference():
    from paddle_tpu.sampling import SamplingParams as JParams

    kw = dict(temperature=0, top_k=3.0, seed=-1, stop_token_ids=[5, 2],
              max_new_tokens=4.0)
    a, b = SamplingParams(**kw), JParams(**kw)
    for f in ("temperature", "top_k", "seed", "stop_token_ids",
              "max_new_tokens", "is_greedy", "uses_penalties"):
        assert getattr(a, f) == getattr(b, f), f


def test_greedy_readout_and_stops_match_reference():
    """argmax with ties to the FIRST maximum, and the stop matrix check,
    on the same logits as the reference pipeline."""
    from paddle_tpu.sampling import processors as jproc

    rs = np.random.RandomState(0)
    logits = rs.randn(6, 50).astype(np.float32)
    logits[1, [7, 30]] = 9.0           # a tie: the first index wins
    logits[4, :] = 0.0                 # all equal: index 0
    stop = np.full((6, 2), -1, np.int32)
    stop[0, 0] = int(np.argmax(logits[0]))
    stop[2] = [int(np.argmax(logits[2])), 3]
    active = np.array([1, 1, 0, 1, 1, 1], bool)
    tok = proc.sample_tokens(torch.from_numpy(logits), {}, sampled=False,
                             penalties=False)
    jtok = jproc.sample_tokens(jnp.asarray(logits), {"stop": None},
                               sampled=False, penalties=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert tok.dtype == torch.int32 and tok[1] == 7 and tok[4] == 0
    st = proc.check_stops(tok, torch.from_numpy(stop),
                          torch.from_numpy(active))
    jst = jproc.check_stops(jtok, jnp.asarray(stop), jnp.asarray(active))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert st.tolist() == [True, False, False, False, False, False]


def test_update_counts_matches_reference():
    from paddle_tpu.sampling import processors as jproc

    counts = np.zeros((3, 10), np.int32)
    rows = np.array([0, 2, 0], np.int32)
    tok = np.array([4, 4, 4], np.int32)
    inc = np.array([True, True, False])
    got = proc.update_counts(torch.from_numpy(counts), torch.from_numpy(rows),
                             torch.from_numpy(tok), torch.from_numpy(inc))
    ref = jproc.update_counts(jnp.asarray(counts), jnp.asarray(rows),
                              jnp.asarray(tok), jnp.asarray(inc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- processors ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_bitwise(seed):
    """Repetition (both signs of the logit), presence and frequency
    penalties, with identity rows, bit for bit against the reference."""
    from paddle_tpu.sampling import processors as jproc

    rs = np.random.RandomState(seed)
    R, V = 6, 83
    logits = (rs.randn(R, V) * 3).astype(np.float32)
    counts = rs.randint(0, 4, (R, V)).astype(np.int32) \
        * (rs.rand(R, V) < 0.3)
    rep = np.array([1.0, 1.3, 0.7, 1.0, 2.5, 1.1], np.float32)
    pres = np.array([0.0, 0.0, 0.5, -0.3, 1.0, 0.2], np.float32)
    freq = np.array([0.0, 0.1, 0.0, 0.25, -0.5, 0.3], np.float32)
    got = proc.apply_penalties(*(torch.from_numpy(a) for a in (
        logits, counts.astype(np.int32), rep, pres, freq)))
    ref = np.asarray(jproc.apply_penalties(*(jnp.asarray(a) for a in (
        logits, counts.astype(np.int32), rep, pres, freq))))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
    # identity rows are the logits themselves
    np.testing.assert_array_equal(got[0].numpy(), logits[0])


def _filter_inputs(seed, R=8, V=97):
    """Logits and per-row filter settings (one row per filter, mixes,
    and every filter off), checked to lie away from the top-p and min-p
    boundaries (see the module docstring)."""
    rs = np.random.RandomState(seed)
    scaled = (rs.randn(R, V) * 2.5).astype(np.float32)
    top_k = np.array([0, 5, 0, 0, 12, 3, 0, 40], np.int32)[:R]
    top_p = np.array([1.0, 1.0, 0.9, 1.0, 0.8, 0.95, 0.5, 1.0],
                     np.float32)[:R]
    min_p = np.array([0.0, 0.0, 0.0, 0.1, 0.05, 0.0, 0.02, 0.3],
                     np.float32)[:R]
    x = scaled.astype(np.float64)
    for r in range(R):
        srt = np.sort(x[r])[::-1]
        k = top_k[r] if 0 < top_k[r] < V else V
        p = np.exp(srt[:k] - srt[0])
        p /= p.sum()
        cum = np.cumsum(p) - p
        if top_p[r] < 1.0:
            assert np.abs(cum - top_p[r]).min() > 1e-5, (seed, r)
        if min_p[r] > 0:
            assert np.abs(p / p[0] - min_p[r]).min() > 1e-5, (seed, r)
    return scaled, top_k, top_p, min_p


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_filter_logits_keep_mask_matches_reference(seed):
    from paddle_tpu.sampling import processors as jproc

    args = _filter_inputs(seed)
    got = proc.filter_logits(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jproc.filter_logits(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    keep = np.isfinite(got)
    np.testing.assert_array_equal(got[keep], args[0][keep])
    assert keep.any(axis=-1).all()     # the best token always survives
    assert keep[0].all()               # every filter off keeps all


def test_filter_keeps_ties_at_the_threshold():
    """A tie at the k-th value is kept (standard top-k ties), as the
    reference's filter does."""
    from paddle_tpu.sampling import processors as jproc

    scaled = np.array([[3.0, 1.0, 2.0, 2.0, 0.5]], np.float32)
    args = (scaled, np.array([2], np.int32), np.array([1.0], np.float32),
            np.array([0.0], np.float32))
    got = proc.filter_logits(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jproc.filter_logits(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got[0]).tolist() == [True, False, True, True, False]


# ---- ops/search.py: twins of TestTopkOp ------------------------------------

def test_topk_values_consistent_with_indices_duplicates():
    from paddle_tpu_torch.ops.search import topk_impl

    x = torch.tensor([2.0, 1.0, 2.0, 1.0, 3.0])
    for largest in (True, False):
        vals, idx = topk_impl(x, 3, largest=largest)
        assert torch.equal(vals, x[idx.long()])
        assert idx.dtype == torch.int32
    vals, idx = topk_impl(x, 3, largest=False)
    assert vals.tolist() == [1.0, 1.0, 2.0]
    assert idx.tolist() == [1, 3, 0]                       # stable
    vals, idx = topk_impl(x, 3)
    assert vals.tolist() == [3.0, 2.0, 2.0]
    assert idx.tolist() == [4, 0, 2]               # ties: lower index


def test_topk_unsigned_smallest():
    from paddle_tpu_torch.ops.search import topk_impl

    x = torch.tensor([3, 0, 2, 7], dtype=torch.uint32)
    vals, idx = topk_impl(x, 2, largest=False)
    assert vals.dtype == torch.uint32
    assert vals.to(torch.int64).tolist() == [0, 2]
    assert idx.tolist() == [1, 2]


def test_topk_int_min_smallest():
    from paddle_tpu_torch.ops.search import topk_impl

    lo = np.iinfo(np.int32).min
    x = torch.tensor([5, lo, -1], dtype=torch.int32)
    vals, idx = topk_impl(x, 2, largest=False)
    assert vals.tolist() == [lo, -1]
    assert idx.tolist() == [1, 2]


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_topk_matches_reference_impl(dtype, largest):
    """Values and indices equal the reference `topk_impl`'s on input
    full of duplicates, along either axis."""
    from paddle_tpu.ops.search import topk_impl as jtopk

    from paddle_tpu_torch.ops.search import topk_impl

    rs = np.random.RandomState(4)
    x = rs.randint(0, 6, (5, 9)).astype(dtype)
    for axis in (-1, 0):
        vals, idx = topk_impl(torch.from_numpy(x), 4, axis=axis,
                              largest=largest)
        jv, ji = jtopk(jnp.asarray(x), 4, axis=axis, largest=largest)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_processor_uses_shared_impl():
    """The top-k filter's thresholds come from `topk_impl`'s descending
    sort: per-row dynamic k against a numpy reference."""
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 16).astype(np.float32)
    top_k = np.array([4, 0, 1], np.int32)   # 0 = off
    out = proc.filter_logits(torch.from_numpy(logits),
                             torch.from_numpy(top_k), torch.ones(3),
                             torch.zeros(3)).numpy()
    for r in range(3):
        k = int(top_k[r]) or 16
        kth = np.sort(logits[r])[::-1][k - 1]
        keep = logits[r] >= kth
        assert np.isfinite(out[r][keep]).all()
        assert np.isneginf(out[r][~keep]).all()


# ---- sampling/buffers.py ------------------------------------------------

def _store_pair(n=4, V=100):
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore

    ts, js = SlotParamStore(n, V, "cpu"), JStore(n, V)
    slots = [(0, dict(stop_token_ids=(5, 9, 2)), 11, [3, 3, 7]),
             (1, dict(temperature=0.7, top_k=5, top_p=0.9, seed=3), 2**32 - 1,
              [1]),
             (3, dict(temperature=1.2, min_p=0.1, repetition_penalty=1.3,
                      presence_penalty=0.5, frequency_penalty=0.2), 2**31,
              [4, 4, 4, 99, 0])]
    for i, kw, seed, prompt in slots:
        ts.set_slot(i, SamplingParams(**kw), seed, eos=7, prompt_ids=prompt)
        js.set_slot(i, JParams(**kw), seed, eos=7, prompt_ids=prompt)
    return ts, js


def _assert_sp_equal(sp, jsp):
    assert sorted(sp) == sorted(jsp)
    for key in jsp:
        ref = np.asarray(jsp[key])
        got = sp[key].numpy()
        if key == "seeds":       # uint32 seeds travel as int64
            ref = ref.astype(np.int64)
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


def test_stop_matrix_matches_reference_store():
    """The slot store's stop-id matrix (EOS joined, -1 padded, pow2
    width) equals the reference SlotParamStore's for the same slots."""
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore

    ts = SlotParamStore(4, 100, "cpu")
    js = JStore(4, 100)
    for i, ids in ((0, (5, 9, 2)), (2, ())):
        ts.set_slot(i, SamplingParams(stop_token_ids=ids), 0, eos=7)
        js.set_slot(i, JParams(stop_token_ids=ids), seed=0, eos=7)
    sp, mode = ts.step_args(np.zeros(4, np.int32))
    jsp, jmode = js.step_args(np.zeros(4, np.int32))
    assert mode == jmode == GREEDY_MODE
    np.testing.assert_array_equal(sp["stop"].numpy(),
                                  np.asarray(jsp["stop"]))
    sp, _ = ts.packed_args([2, None, 0], [True, False, True])
    jsp, _ = js.packed_args([2, None, 0], [True, False, True])
    np.testing.assert_array_equal(sp["stop"].numpy(),
                                  np.asarray(jsp["stop"]))
    ts.clear_slot(0)
    assert ts._stop_ids[0] == ()


@pytest.mark.parametrize("mode", [(False, False), (True, False),
                                  (False, True), (True, True)])
def test_assemble_matches_reference_store(mode):
    ts, js = _store_pair()
    rows, steps = [3, 0, 1, 1], np.array([5, 0, 2**31 - 1, 7], np.int32)
    _assert_sp_equal(ts._assemble(rows, steps, mode),
                     js._assemble(rows, steps, mode))


def test_step_args_matches_reference_store():
    ts, js = _store_pair()
    steps = np.array([4, 1, 0, 9], np.int32)
    (sp, mode), (jsp, jmode) = ts.step_args(steps), js.step_args(steps)
    assert mode == jmode == (True, True)
    _assert_sp_equal(sp, jsp)
    # releasing the sampled and penalized slots gives the greedy variant
    for s in (ts, js):
        s.clear_slot(1)
        s.clear_slot(3)
    (sp, mode), (jsp, jmode) = ts.step_args(steps), js.step_args(steps)
    assert mode == jmode == GREEDY_MODE
    _assert_sp_equal(sp, jsp)


@pytest.mark.parametrize("slot_rows,done", [
    ([1, None, 3], [True, False, False]),
    ([0, 1, None, None], [True, True, False, False]),
    ([0, None], [True, False]),
    ([3, 1], [False, True]),
])
def test_packed_args_matches_reference_store(slot_rows, done):
    """Padding rows are masked out of `sample`; in penalty mode `crows`
    names each row's slot and `row_done` the completing real rows."""
    ts, js = _store_pair()
    steps = np.arange(len(slot_rows), dtype=np.int32)
    for st in (None, steps):
        (sp, mode) = ts.packed_args(slot_rows, done, st)
        (jsp, jmode) = js.packed_args(slot_rows, done, st)
        assert mode == jmode
        _assert_sp_equal(sp, jsp)


def test_counts_rows_reset_from_the_prompt():
    ts, js = _store_pair()
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert ts.counts[3, 4] == 3 and ts.counts[0].sum() == 0
    new = ts.counts.clone()
    new[2, 1] = 5
    ts.swap_counts(new)
    assert ts.counts[2, 1] == 5
    ts.swap_counts(None)               # a variant without penalties
    assert ts.counts is new


# ---- the server: twins of tests/test_sampling.py ---------------------------

@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(11)
    return port, tcfg, port.flat_params()


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("device", "cpu")
    return PagedGenerationServer(port, **kw)


def _serve(port, submits, **kw):
    srv = _server(port, **kw)
    futs = [srv.submit(p, sampling=s) for p, s in submits]
    srv.start()
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(1, vocab, (n,)) \
        .astype(np.int32)


def test_submit_type_error(tiny):
    port, _tcfg, _p = tiny
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=4)
    with pytest.raises(TypeError):
        srv.submit([1, 2], sampling={"temperature": 1.0})
    assert not srv._queue


def test_stop_strings_need_detokenizer(tiny):
    port, _tcfg, _p = tiny
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=4)
    with pytest.raises(ValueError, match="detokeniz"):
        srv.submit([1, 2], sampling=SamplingParams(stop_strings=("x",)))
    assert not srv._queue                # nothing was enqueued


def test_server_sampling_arguments_are_validated(tiny):
    port, _tcfg, _p = tiny
    with pytest.raises(ValueError, match="stop_tail_tokens"):
        _server(port, max_slots=1, block_size=4, max_new_tokens=4,
                stop_tail_tokens=0)
    with pytest.raises(ValueError, match="temperature"):
        _server(port, max_slots=1, block_size=4, max_new_tokens=4,
                temperature=-1.0)
    srv = _server(port, max_slots=1, block_size=4, max_new_tokens=4,
                  temperature=0.7)
    assert srv._default_sampling.temperature == 0.7


def test_one_dispatch_serves_greedy_and_sampled(tiny):
    """A batch mixing a greedy and a sampled slot is served by ONE
    decode dispatch per step; the greedy slot is exact."""
    port, tcfg, params = tiny
    greedy_p = _prompt(3, 4, tcfg.vocab_size)
    sampled_p = _prompt(33, 5, tcfg.vocab_size)
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=4)
    calls = {"step": 0, "prefill": 0}
    real_step = srv._decoder.step
    real_packed = srv._decoder.packed_prefill

    def counting_step(*a, **kw):
        calls["step"] += 1
        return real_step(*a, **kw)

    def counting_packed(*a, **kw):
        calls["prefill"] += 1
        return real_packed(*a, **kw)

    srv._decoder.step = counting_step
    srv._decoder.packed_prefill = counting_packed
    f1 = srv.submit(greedy_p)  # burst BEFORE start: admitted together
    f2 = srv.submit(sampled_p, sampling=SamplingParams(
        temperature=1.0, top_p=0.9, seed=17))
    srv.start()
    try:
        np.testing.assert_array_equal(f1.result(timeout=120),
                                      dense_greedy(params, tcfg, greedy_p, 4))
        assert f2.result(timeout=120).size == sampled_p.size + 4
        # budget 4 = 1 prefill-sampled token + 3 decode steps; both
        # slots decode in lockstep, so 3 shared dispatches in all
        assert calls["prefill"] == 1
        assert calls["step"] == 3
        st = srv.stats()
        assert st["sampling_sampled_dispatches"] == 3
        assert st["sampling_fast_path_dispatches"] == 0
    finally:
        srv.stop()


def test_served_greedy_rides_the_fast_path(tiny):
    port, tcfg, params = tiny
    p = _prompt(2, 5, tcfg.vocab_size)
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=5).start()
    try:
        out = srv.submit(p, sampling=SamplingParams()).result(timeout=120)
        np.testing.assert_array_equal(out, dense_greedy(params, tcfg, p, 5))
        st = srv.stats()
        assert st["sampling_fast_path_dispatches"] > 0
        assert st["sampling_sampled_dispatches"] == 0
    finally:
        srv.stop()


def test_fixed_seed_invariant_to_composition_and_slot(tiny):
    port, tcfg, _p = tiny
    rs = np.random.RandomState(4)
    target = rs.randint(1, tcfg.vocab_size, (6,)).astype(np.int32)
    others = [rs.randint(1, tcfg.vocab_size, (n,)).astype(np.int32)
              for n in (3, 8, 5)]
    sp = SamplingParams(temperature=1.0, top_p=0.95, seed=123)
    kw = dict(max_slots=4, block_size=4, max_prompt_len=8,
              max_new_tokens=5)
    alone = _serve(port, [(target, sp)], **kw)[0]
    # with greedy co-residents, in the highest slot
    packed = _serve(port, [(o, None) for o in others] + [(target, sp)],
                    **kw)[-1]
    np.testing.assert_array_equal(alone, packed)
    # submitted FIRST (slot 0), with sampled co-residents
    sp2 = SamplingParams(temperature=1.3, seed=77)
    first = _serve(port, [(target, sp)] + [(o, sp2) for o in others],
                   **kw)[0]
    np.testing.assert_array_equal(alone, first)


def test_fixed_seed_reproducible_across_servers(tiny):
    port, tcfg, _p = tiny
    p = _prompt(5, 5, tcfg.vocab_size)
    sp = SamplingParams(temperature=0.9, top_k=8, seed=99)
    kw = dict(max_slots=2, block_size=4, max_prompt_len=8,
              max_new_tokens=6)
    a = _serve(port, [(p, sp)], **kw)[0]
    b = _serve(port, [(p, sp)], **kw)[0]
    np.testing.assert_array_equal(a, b)


def test_auto_seeds_give_distinct_streams(tiny):
    """Two identical sampled requests without explicit seeds do not
    mirror each other (auto-derived per-request streams)."""
    port, tcfg, _p = tiny
    p = _prompt(6, 4, tcfg.vocab_size)
    sp = SamplingParams(temperature=2.0)
    outs = _serve(port, [(p, sp), (p, sp)], max_slots=2, block_size=4,
                  max_prompt_len=8, max_new_tokens=8)
    assert not np.array_equal(outs[0], outs[1])


def test_multistep_matches_single_step_sampled(tiny):
    """The k-step dispatch advances each stream with the step index, so
    k = 3 reproduces k = 1 token for token for sampled requests."""
    port, tcfg, _p = tiny
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 6)]
    sps = [SamplingParams(temperature=1.0, seed=31),
           SamplingParams(temperature=0.8, top_p=0.9, seed=32,
                          frequency_penalty=0.4)]
    outs = {}
    for k in (1, 3):
        outs[k] = _serve(port, list(zip(prompts, sps)), max_slots=2,
                         block_size=4, max_prompt_len=8, max_new_tokens=6,
                         steps_per_dispatch=k)
    for a, b in zip(outs[1], outs[3]):
        np.testing.assert_array_equal(a, b)


def test_stop_token_ids_stop_on_device(tiny):
    port, tcfg, params = tiny
    p = _prompt(9, 4, tcfg.vocab_size)
    first = int(dense_greedy(params, tcfg, p, 1)[-1])
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=5).start()
    try:
        out = srv.submit(p, sampling=SamplingParams(
            stop_token_ids=(first,))).result(timeout=120)
        # stopped on the FIRST generated token, which is kept
        assert out.size == p.size + 1 and out[-1] == first
        st = srv.stats()
        assert st["stop_reasons"]["stop_token"] == 1
        assert st["stop_reasons"]["budget"] == 0
    finally:
        srv.stop()


def _detok(toks):
    return "".join(f"<{t}>" for t in toks)


def test_stop_strings_host_side(tiny):
    port, tcfg, params = tiny
    p = _prompt(10, 3, tcfg.vocab_size)
    ref = dense_greedy(params, tcfg, p, 6)
    gen = ref[p.size:]
    # a two-token stop string completes when the second token lands
    target = f"<{int(gen[0])}><{int(gen[1])}>"
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=6, detokenize=_detok).start()
    try:
        out = srv.submit(p, sampling=SamplingParams(
            stop_strings=(target,))).result(timeout=120)
        np.testing.assert_array_equal(out, ref[:p.size + 2])
        assert srv.stats()["stop_reasons"]["stop_string"] == 1
    finally:
        srv.stop()


def test_stop_strings_see_only_the_tail(tiny):
    """The stop check reads the last `stop_tail_tokens` tokens: a string
    that needs the first of three tokens does not match at tail 2."""
    port, tcfg, params = tiny
    p = _prompt(10, 3, tcfg.vocab_size)
    ref = dense_greedy(params, tcfg, p, 6)
    gen = [int(x) for x in ref[p.size:]]
    target = _detok(gen[:3])
    outs = {}
    for tail in (2, 3):
        srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                      max_new_tokens=6, detokenize=_detok,
                      stop_tail_tokens=tail).start()
        try:
            outs[tail] = srv.submit(p, sampling=SamplingParams(
                stop_strings=(target,))).result(timeout=120)
        finally:
            srv.stop()
    np.testing.assert_array_equal(outs[3], ref[:p.size + 3])
    np.testing.assert_array_equal(outs[2], ref)


def test_per_request_budget_from_params(tiny):
    port, tcfg, _p = tiny
    p = _prompt(11, 4, tcfg.vocab_size)
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=6).start()
    try:
        out = srv.submit(p, sampling=SamplingParams(
            max_new_tokens=2)).result(timeout=120)
        assert out.size == p.size + 2
        # the explicit submit arg wins over the params field
        out2 = srv.submit(p, max_new_tokens=3, sampling=SamplingParams(
            max_new_tokens=2)).result(timeout=120)
        assert out2.size == p.size + 3
        with pytest.raises(ValueError):
            srv.submit(p, sampling=SamplingParams(max_new_tokens=99))
    finally:
        srv.stop()


def test_broken_detokenizer_fails_one_request(tiny):
    """A detokenizer that raises fails that request, naming the
    'detokenize' seam, frees its slot and blocks, and the co-resident
    request is served in full."""
    port, tcfg, params = tiny

    def detok(toks):
        raise KeyError("no such token")

    p1, p2 = _prompt(12, 4, tcfg.vocab_size), _prompt(13, 5, tcfg.vocab_size)
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=4, detokenize=detok)
    bad = srv.submit(p1, sampling=SamplingParams(stop_strings=("x",)))
    good = srv.submit(p2)
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="'detokenize'"):
            bad.result(timeout=120)
        np.testing.assert_array_equal(good.result(timeout=120),
                                      dense_greedy(params, tcfg, p2, 4))
        assert srv.cache.stats()["used_blocks"] == 0
        assert all(s is None for s in srv._slots)
    finally:
        srv.stop()


def test_presence_penalty_prevents_repeats(tiny):
    port, tcfg, _p = tiny
    p = _prompt(12, 4, tcfg.vocab_size)
    out = _serve(port, [(p, SamplingParams(presence_penalty=1e9))],
                 max_slots=1, block_size=4, max_prompt_len=8,
                 max_new_tokens=8)[0]
    gen = out[p.size:].tolist()
    # a huge presence penalty forbids every seen token: all generated
    # tokens distinct and absent from the prompt
    assert len(set(gen)) == len(gen)
    assert not set(gen) & set(p.tolist())


def test_penalty_counts_reset_on_slot_refill(tiny):
    """A slot reused by a second penalty request does not inherit the
    first request's token counts."""
    port, tcfg, _p = tiny
    p = _prompt(13, 4, tcfg.vocab_size)
    sp = SamplingParams(repetition_penalty=1.5)
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=4).start()
    try:
        a = srv.submit(p, sampling=sp).result(timeout=120)
        b = srv.submit(p, sampling=sp).result(timeout=120)
        np.testing.assert_array_equal(a, b)
    finally:
        srv.stop()
