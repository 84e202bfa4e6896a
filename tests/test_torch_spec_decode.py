"""Speculative decoding on the port (`paddle_tpu_torch/spec_decode/`,
`PagedDecoder.packed_verify`, the server's `speculation=`), held to the
JAX reference (`tests/test_spec_decode.py`'s suite) in float32 on the
CPU, with the same weights through the weight bridge
(`GPT2Config.tiny()`, `block_size=4`):

  * twins of `TestSpecConfig`, `TestNgramDrafter`, `TestVerifyPlan` and
    `TestTruncateSeq` (the rollbacks through `torch_twin_util.PoolMirror`,
    the reference's pool beside the port's after every op), the n-gram
    drafter and the verify plan against the reference's on random
    inputs, and the `DraftModelDrafter` seam with a stub model;
  * `verify_window_attention_plain` against the reference's dense
    per-row fallback and against `unified_ragged_attention_kernel(
    interpret=True)` on the flattened stream (rows with pos >= 0: K1 and
    the kernel give pad rows other values than the fallback), dense and
    int8, within 1e-5;
  * `packed_verify` against the reference decoder's in all 4 sampling
    modes: vtok, accepted, stopped and the count buffer equal, the pools
    and the logits (against the reference's packed prefill of the same
    stream, return_logits) within `LOGIT_ATOL`;
  * the speculating server against the reference's speculating server
    with the same options, token for token, and against the port's plain
    server: `TestSpecParity`'s twins (n-gram and replay drafters, greedy,
    seeded sampled and penalties, the prefix cache, int8 KV and W8A16),
    the stats schema and the checks of the constructor.

The two `TestSpecParity` tests that are red in the reference fail there
on their data, not on the engine: `test_stop_token_inside_accepted_prefix`
picks the third generated token as the stop token, but the first
generated token already is it; `test_verify_failure_cleans_up_and_serves
_on` relies on the n-gram drafter proposing on the first round, which it
does not when the first generated token is outside the prompt's motif.
Their twins keep each test's intent and make the workload exercise it:
a stop token whose first occurrence is generated token 2, and a drafter
that always proposes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import PoolMirror, dense_greedy, reference_tiny_model, t

torch.set_num_threads(1)

BS = 4
LOGIT_ATOL = 1e-4     # tests/test_torch_decoder.py's float32 limit
ATTN_ATOL = 1e-5
MODES = [(False, False), (True, False), (False, True), (True, True)]


def _mode_id(m):
    return f"s{int(m[0])}p{int(m[1])}"


@pytest.fixture(scope="module")
def tiny():
    # tests/test_spec_decode.py's weights: paddle.seed(11)
    return reference_tiny_model(11)


class ReplayDrafter:
    """Proposes the recorded continuation's next tokens: every draft is
    accepted (the reference test's oracle)."""

    def __init__(self, refs):
        self._refs = [np.asarray(r, np.int32) for r in refs]

    def propose(self, token_ids, max_tokens):
        ctx = np.asarray(token_ids, np.int32)
        for ref in self._refs:
            if ctx.size < ref.size and np.array_equal(ref[:ctx.size], ctx):
                return ref[ctx.size:ctx.size + int(max_tokens)]
        return np.empty((0,), np.int32)


class CorruptingReplayDrafter(ReplayDrafter):
    """The replay drafter with one token a round made wrong, at a depth
    that varies with the context length: every round partly accepts and
    rolls back."""

    def propose(self, token_ids, max_tokens):
        prop = np.array(super().propose(token_ids, max_tokens), np.int32,
                        copy=True)
        if prop.size:
            j = int(np.asarray(token_ids).size % prop.size)
            prop[j] = prop[j] - 1 if prop[j] > 0 else 1
        return prop


class AlwaysDrafter:
    """Proposes max_tokens copies of the context's last token, on every
    round: a verify dispatch runs from the first decode round on."""

    def propose(self, token_ids, max_tokens):
        return np.full((int(max_tokens),), int(np.asarray(token_ids)[-1]),
                       np.int32)


def _sp_pair(**kw):
    """The same SamplingParams on both sides."""
    from paddle_tpu.sampling import SamplingParams as JParams

    from paddle_tpu_torch.sampling import SamplingParams

    return JParams(**kw), SamplingParams(**kw)


def _spec_pair(**kw):
    """(reference SpecConfig, port SpecConfig) from the same knobs; a
    drafter instance is shared (both sides only call its propose)."""
    from paddle_tpu.spec_decode import SpecConfig as JSpec

    from paddle_tpu_torch.spec_decode import SpecConfig

    return JSpec(**kw), SpecConfig(**kw)


def _serve(srv, subs):
    """Every request queued before the loop starts (a fixed schedule);
    the outputs and the stats; the server is stopped."""
    try:
        futs = [srv.submit(p, sampling=sp) for p, sp in subs]
        srv.start()
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


def _kw(**kw):
    return dict(dict(max_slots=2, block_size=BS, max_prompt_len=16,
                     max_new_tokens=6), **kw)


def _port(tiny, spec=None, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(tiny[2], speculation=spec, device="cpu",
                                 **_kw(**kw))


def _ref(tiny, spec=None, **kw):
    from paddle_tpu.inference import PagedGenerationServer as JServer

    return JServer(tiny[0], speculation=spec, **_kw(**kw))


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


def _triple(tiny, prompts, spec_kw, params=None, **kw):
    """The port's plain server, the port's speculating server and the
    reference's speculating server on the same requests. Returns (plain
    outputs, port outputs, port stats, reference outputs)."""
    jsp, tsp = _sp_pair(**params) if params is not None else (None, None)
    plain, _ = _serve(_port(tiny, **kw), [(p, tsp) for p in prompts])
    jspec, tspec = _spec_pair(**spec_kw)
    out, st = _serve(_port(tiny, tspec, **kw), [(p, tsp) for p in prompts])
    ref, _ = _serve(_ref(tiny, jspec, **kw), [(p, jsp) for p in prompts])
    return plain, out, st, ref


# ---- SpecConfig -------------------------------------------------------------

class TestSpecConfig:
    @pytest.mark.parametrize("kw,field", [
        (dict(max_draft_tokens=0), "max_draft_tokens"),
        (dict(max_draft_tokens=2.5), "max_draft_tokens"),
        (dict(ngram_max_match=0), "ngram_max_match"),
        (dict(ngram_min_match=-1), "ngram_min_match"),
        (dict(drafter="bigram"), "drafter"),
        (dict(drafter=object()), "drafter"),
    ])
    def test_bad_value_names_field(self, kw, field):
        """The reference's message for the same bad value."""
        from paddle_tpu.spec_decode import SpecConfig as JSpec

        from paddle_tpu_torch.spec_decode import SpecConfig

        with pytest.raises(ValueError) as ei:
            SpecConfig(**kw)
        with pytest.raises(ValueError) as ej:
            JSpec(**kw)
        assert field in str(ei.value)
        if "drafter" not in kw:  # a drafter object prints its address
            assert str(ei.value) == str(ej.value)

    def test_min_above_max_rejected(self):
        from paddle_tpu_torch.spec_decode import SpecConfig

        with pytest.raises(ValueError, match="ngram_min_match"):
            SpecConfig(ngram_min_match=4, ngram_max_match=2)

    def test_make_drafter(self):
        from paddle_tpu_torch.spec_decode import NgramDrafter, SpecConfig

        d = SpecConfig(ngram_max_match=2).make_drafter()
        assert isinstance(d, NgramDrafter) and d.max_match == 2
        custom = ReplayDrafter([])
        assert SpecConfig(drafter=custom).make_drafter() is custom

    def test_server_rejects_bad_combinations(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer

        port = tiny[2]
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            PagedGenerationServer(port, max_prompt_len=8, max_new_tokens=4,
                                  speculation=True, steps_per_dispatch=4,
                                  device="cpu")
        with pytest.raises(TypeError, match="SpecConfig"):
            PagedGenerationServer(port, max_prompt_len=8, max_new_tokens=4,
                                  speculation={"max_draft_tokens": 4},
                                  device="cpu")

    @pytest.mark.parametrize("extra", [dict(), dict(async_rounds=True)],
                             ids=["split", "async"])
    def test_overrun_slack_matches_reference(self, tiny, extra):
        """Admission reserves the reference's horizon: max(k - 1, K), plus
        1 + K with async rounds; the default max_prompt_len follows."""
        jspec, tspec = _spec_pair(max_draft_tokens=5)
        kw = dict(max_new_tokens=4, **extra)
        a = _port(tiny, tspec, **dict(kw, max_prompt_len=None))
        b = _ref(tiny, jspec, **dict(kw, max_prompt_len=None))
        assert a._overrun == b._overrun == (5 + (6 if extra else 0))
        assert a.max_prompt_len == b.max_prompt_len
        assert a._worst_blocks(_FakeReq(9, 4)) == b._worst_blocks(
            _FakeReq(9, 4))


class _FakeReq:
    def __init__(self, n, budget):
        self.ids = np.zeros((n,), np.int32)
        self.budget = budget
        self.resume_ids = None
        self.gen0 = []


# ---- the drafters -----------------------------------------------------------

class TestNgramDrafter:
    def _d(self, **kw):
        from paddle_tpu_torch.spec_decode import NgramDrafter

        return NgramDrafter(**kw)

    def test_proposes_continuation_of_repeated_suffix(self):
        d = self._d(max_match=3, min_match=1)
        ctx = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32)
        np.testing.assert_array_equal(d.propose(ctx, 4), [4, 1, 2, 3])

    def test_longest_match_wins(self):
        d = self._d(max_match=3, min_match=1)
        ctx = np.array([8, 5, 7, 8, 9, 1, 7, 8], np.int32)
        np.testing.assert_array_equal(d.propose(ctx, 1), [9])

    def test_most_recent_occurrence_wins(self):
        d = self._d(max_match=2, min_match=1)
        ctx = np.array([3, 4, 3, 5, 3], np.int32)
        np.testing.assert_array_equal(d.propose(ctx, 1), [5])

    def test_no_match_and_short_context(self):
        d = self._d(max_match=3, min_match=1)
        assert d.propose(np.array([1, 2, 3], np.int32), 4).size == 0
        assert d.propose(np.array([7], np.int32), 4).size == 0
        assert d.propose(np.array([7, 7], np.int32), 0).size == 0

    def test_periodic_extension_fills_budget(self):
        d = self._d(max_match=1, min_match=1)
        np.testing.assert_array_equal(
            d.propose(np.array([5, 9, 5], np.int32), 8),
            [9, 5, 9, 5, 9, 5, 9, 5])
        np.testing.assert_array_equal(
            d.propose(np.array([3, 7, 7, 7], np.int32), 4), [7, 7, 7, 7])

    def test_validation(self):
        with pytest.raises(ValueError):
            self._d(max_match=1, min_match=2)

    @pytest.mark.parametrize("window", [(3, 1), (2, 2), (4, 1)])
    def test_proposals_equal_reference_on_random_contexts(self, window):
        """The reference's proposal for 300 contexts over a small
        alphabet (many repeats), every budget 0..6."""
        from paddle_tpu.spec_decode import NgramDrafter as JNgram

        mx, mn = window
        ours, theirs = self._d(max_match=mx, min_match=mn), JNgram(mx, mn)
        rs = np.random.RandomState(mx * 10 + mn)
        for _ in range(300):
            ctx = rs.randint(0, 5, (int(rs.randint(1, 30)),)).astype(
                np.int32)
            for k in range(7):
                a, b = ours.propose(ctx, k), theirs.propose(ctx, k)
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)


class _StubModel:
    """`generate(ids[1, S], n) -> [1, S + n]`: the port's weights decoded
    greedily by a plain full-recompute forward (`dense_greedy`), returned
    as a tensor, as a model on a device would."""

    def __init__(self, port, cfg):
        self.params = port.flat_params()
        self.cfg = cfg
        self.calls = 0

    def generate(self, ids, n):
        self.calls += 1
        return torch.from_numpy(dense_greedy(self.params, self.cfg,
                                             np.asarray(ids)[0], n)[None])


def test_draft_model_drafter_seam(tiny):
    """The seam reads back a tensor, returns the continuation only, and
    refuses nothing: an empty context or budget gives no proposal."""
    from paddle_tpu_torch.spec_decode import DraftModelDrafter

    stub = _StubModel(tiny[2], tiny[3])
    d = DraftModelDrafter(stub)
    ctx = np.array([5, 6, 7], np.int32)
    prop = d.propose(ctx, 4)
    assert prop.dtype == np.int32 and prop.shape == (4,)
    np.testing.assert_array_equal(
        prop, dense_greedy(stub.params, tiny[3], ctx, 4)[3:])
    assert d.propose(ctx, 0).size == 0
    assert d.propose(np.empty((0,), np.int32), 3).size == 0
    assert stub.calls == 1


# ---- truncate_seq: the speculative rollback ---------------------------------

class TestTruncateSeq:
    """`TestTruncateSeq`'s twins, each op on the reference pool and the
    port's (`PoolMirror` compares tables, free list, retention,
    refcounts and the index after every op)."""

    def _cache(self):
        return PoolMirror(num_blocks=10, block_size=4)

    def test_rollback_frees_tail_blocks(self):
        c = self._cache()
        c.allocate("a", 14)
        assert c.truncate_seq("a", 9) == 1
        assert c.seq_len("a") == 9 and len(c.block_table("a")) == 3
        assert c.free_block_count == 6
        assert c.truncate_seq("a", 9) == 0
        c.allocate("b", 4)
        assert c.free_block_count == 5
        c.check()

    def test_truncate_to_zero_and_errors(self):
        c = self._cache()
        c.allocate("a", 6)
        assert c.truncate_seq("a", 0) == 2
        assert c.seq_len("a") == 0 and c.block_table("a") == []
        with pytest.raises(ValueError, match="only rolls back"):
            c.truncate_seq("a", 1)
        with pytest.raises(KeyError, match="unknown sequence"):
            c.truncate_seq("ghost", 0)
        c.check()

    def test_shared_prefix_blocks_survive_rollback(self):
        c = self._cache()
        toks = np.arange(100, 108, dtype=np.int32)
        c.allocate("a", 8)
        c.publish_prefix("a", toks)
        assert c.attach_prefix("b", np.concatenate(
            [toks, np.arange(5, dtype=np.int32)])) == 8
        shared = c.block_table("b")[:2]
        c.ensure("b", 13)
        assert c.truncate_seq("b", 9) == 1
        assert c.block_table("b")[:2] == shared
        assert c.port._ref[shared[0]] == 2
        c.check()
        assert c.truncate_seq("b", 4) == 2
        assert c.port._ref[shared[0]] == 2 and c.port._ref[shared[1]] == 1
        assert c.seq_len("a") == 8
        c.check()
        c.free("b")
        c.free("a")
        assert c.free_block_count + c.retained_block_count \
            == c.num_blocks - 1
        c.check()

    def test_rollback_into_retained_entry_block(self):
        c = self._cache()
        toks = np.arange(10, dtype=np.int32)
        c.allocate("a", 10)
        c.publish_prefix("a", toks)
        tail = c.block_table("a")[2]
        assert c.truncate_seq("a", 8) == 1
        assert tail in c.port._retained
        assert c.retained_block_count == 1
        c.check()


# ---- the verify plan --------------------------------------------------------

class TestVerifyPlan:
    def test_layout_and_buckets(self):
        from paddle_tpu_torch.spec_decode import build_verify_plan

        entries = [(0, 7, 10, 3, np.array([1, 2], np.int32)),
                   (2, 9, 4, 1, np.array([5], np.int32)),
                   (3, 8, 6, 2, np.array([4, 5, 6], np.int32))]
        plan = build_verify_plan(entries, 4, pack_align=8)
        assert plan.rows == 3
        assert plan.dlen.shape[0] == 4
        assert plan.toks.shape[0] == 32
        np.testing.assert_array_equal(plan.toks[:3], [7, 1, 2])
        np.testing.assert_array_equal(plan.pos[:3], [10, 11, 12])
        np.testing.assert_array_equal(plan.seg[:3], [0, 0, 0])
        assert plan.pos[3] == -1
        np.testing.assert_array_equal(plan.sample_idx[0], [0, 1, 2, 2, 2])
        np.testing.assert_array_equal(plan.sample_idx[1], [8, 9, 9, 9, 9])
        np.testing.assert_array_equal(plan.dlen, [2, 1, 3, -1])
        np.testing.assert_array_equal(plan.steps, [3, 1, 2, 0])
        assert plan.grow_updates(["s0", "s2", "s3"]) == [
            ("s0", 13), ("s2", 6), ("s3", 10)]
        assert build_verify_plan([], 4, 8) is None

    @pytest.mark.parametrize("align", [1, 8])
    def test_plans_equal_reference_on_random_entries(self, align):
        """Every array and list of the reference's plan, for 50 random
        entry sets (draft-free rows included), at the port's align 1 and
        the reference's CPU pack_align 8; the port's W at align 1 is
        K + 1."""
        from paddle_tpu.spec_decode import build_verify_plan as jplan

        from paddle_tpu_torch.spec_decode import build_verify_plan

        rs = np.random.RandomState(align)
        for _ in range(50):
            K = int(rs.randint(1, 8))
            n = int(rs.randint(1, 7))
            entries = [(int(rs.randint(0, 16)), int(rs.randint(0, 99)),
                        int(rs.randint(0, 60)), int(rs.randint(0, 30)),
                        rs.randint(0, 99, (int(rs.randint(0, K + 1)),))
                        .astype(np.int32)) for _ in range(n)]
            mr = int(rs.randint(1, 9))
            a = build_verify_plan(entries, K, align, min_rows=mr)
            b = jplan(entries, K, align, min_rows=mr)
            for f in ("toks", "seg", "pos", "sample_idx", "dlen", "steps"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.slots == b.slots and a.write_pos == b.write_pos
            for x, y in zip(a.drafts, b.drafts):
                np.testing.assert_array_equal(x, y)
            if align == 1:
                assert a.toks.size == a.dlen.size * (K + 1)


# ---- verify_window_attention ------------------------------------------------

def _window_case(seed, quant, W=4):
    """P 4 windows of W tokens over a pool of 14 blocks of 4: row r's
    region [last token, drafts] at positions ctx_r - 1 .., its pads at
    -1; row 3 a padding row (every position -1)."""
    rs = np.random.RandomState(seed)
    P, H, Dh, N, M = 4, 2, 8, 14, 4
    kb = rs.randn(N, BS, H, Dh).astype(np.float32)
    vb = rs.randn(N, BS, H, Dh).astype(np.float32)
    tables = np.zeros((P, M), np.int32)
    perm = rs.permutation(N - 1) + 1
    for r in range(3):
        tables[r] = perm[r * M:(r + 1) * M]
    pos = np.full((P, W), -1, np.int32)
    for r, (wpos, k) in enumerate([(5, 3), (11, 0), (2, 2)]):
        pos[r, :1 + k] = np.arange(wpos, wpos + 1 + k)
    q = rs.randn(P, W, H, Dh).astype(np.float32)
    if quant:
        from paddle_tpu.inference.kv_quant import QuantizedKV, kv_encode

        jk = QuantizedKV(*kv_encode(jnp.asarray(kb)))
        jv = QuantizedKV(*kv_encode(jnp.asarray(vb)))
        from paddle_tpu_torch.inference.kv_quant import QuantizedKV as TQ

        tk = TQ(t(np.asarray(jk.codes)), t(np.asarray(jk.scales)))
        tv = TQ(t(np.asarray(jv.codes)), t(np.asarray(jv.scales)))
    else:
        jk, jv, tk, tv = jnp.asarray(kb), jnp.asarray(vb), t(kb), t(vb)
    return q, jk, jv, tk, tv, tables, pos


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_verify_window_plain_matches_reference_fallback(quant):
    """Every row, pad rows too (both average the row there)."""
    from paddle_tpu.ops.attention import verify_window_attention as jvw

    from paddle_tpu_torch.ops.attention import verify_window_attention_plain

    q, jk, jv, tk, tv, tables, pos = _window_case(1, quant)
    ref = np.asarray(jvw(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                         jnp.asarray(pos)))
    out = verify_window_attention_plain(t(q), tk, tv, t(tables),
                                        t(pos)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_verify_window_plain_matches_stream_kernel(quant):
    """The reference's Pallas K1 (interpret mode) on the flattened [P·W]
    stream, one W-row query tile a window, as the reference runs it on
    a TPU; rows with pos >= 0 (its pad rows compute positions past the
    region's, and K1's give zeros). The CPU route of
    `verify_window_attention` is the plain version."""
    from paddle_tpu.ops.pallas.unified_attention import (
        unified_ragged_attention_kernel)

    from paddle_tpu_torch.ops.attention import (verify_window_attention,
                                                verify_window_attention_plain)

    q, jk, jv, tk, tv, tables, pos = _window_case(2, quant)
    P, W, H, Dh = q.shape
    ker = np.asarray(unified_ragged_attention_kernel(
        jnp.asarray(q.reshape(P * W, H, Dh)), jk, jv, jnp.asarray(tables),
        jnp.arange(P, dtype=jnp.int32), jnp.asarray(pos[:, 0]), q_tile=W,
        interpret=True)).reshape(P, W, H, Dh)
    out = verify_window_attention_plain(t(q), tk, tv, t(tables),
                                        t(pos)).numpy()
    live = pos >= 0
    np.testing.assert_allclose(out[live], ker[live], atol=ATTN_ATOL, rtol=0)
    routed = verify_window_attention(t(q), tk, tv, t(tables), t(pos))
    np.testing.assert_array_equal(routed.numpy(), out)


def test_unified_stream_attention_is_the_ragged_op():
    from paddle_tpu_torch.ops.attention import (ragged_prefill_attention,
                                                unified_stream_attention)

    q, _jk, _jv, tk, tv, tables, pos = _window_case(3, False)
    P, W, H, Dh = q.shape
    seg = t(np.repeat(np.arange(P, dtype=np.int32), W))
    a = unified_stream_attention(t(q.reshape(P * W, H, Dh)), tk, tv,
                                 t(tables), seg, t(pos.reshape(-1)))
    b = ragged_prefill_attention(t(q.reshape(P * W, H, Dh)), tk, tv,
                                 t(tables), seg, t(pos.reshape(-1)))
    assert torch.equal(a, b)


# ---- packed_verify ----------------------------------------------------------

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


def verify_setup(tiny, mode, kv_dtype=None, K=3):
    """Both decoders, pools and stores after one packed prefill of three
    prompts (7, 5 and 9 tokens) in `mode`, then a verify plan over the
    three slots: slot 0 proposes the reference's own greedy continuation
    (accepted as far as the mode keeps it), slot 1 nothing, slot 2 random
    drafts. Returns a dict of everything."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
    from paddle_tpu.nn.decode import PagedDecoder as JDec
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore
    from paddle_tpu.spec_decode import build_verify_plan as jplan

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache as TCache
    from paddle_tpu_torch.nn.decode import PagedDecoder as TDec
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    model, cfg, port, tcfg = tiny
    jp, _ = model.functional_state()
    tp = port.flat_params()
    H, Dh, V = cfg.num_heads, cfg.hidden_size // cfg.num_heads, \
        cfg.vocab_size
    jc = JCache(cfg.num_layers, H, Dh, block_size=BS, num_blocks=24,
                kv_dtype=kv_dtype)
    tc = TCache(tcfg.num_layers, H, Dh, block_size=BS, num_blocks=24,
                kv_dtype=kv_dtype, device="cpu")
    jd = JDec.for_config(cfg, BS, kv_dtype=kv_dtype)
    jdl = JDec.for_config(cfg, BS, return_logits=True, kv_dtype=kv_dtype)
    td = TDec.for_config(tcfg, BS, return_logits=True, kv_dtype=kv_dtype)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, V, (n,)).astype(np.int32) for n in (7, 5, 9)]
    js, ts = JStore(3, V), SlotParamStore(3, V, "cpu")
    for i, kw in enumerate(MODE_PARAMS[mode]):
        js.set_slot(i, JParams(**kw), 1000 + i, prompt_ids=prompts[i])
        ts.set_slot(i, SamplingParams(**kw), 1000 + i,
                    prompt_ids=prompts[i])
    # the prompts through the reference's packed prefill, K/V copied
    # into the port's pool: both verify from the same cache
    T = sum(-(-p.size // 8) * 8 for p in prompts)
    toks, seg = np.zeros(T, np.int32), np.zeros(T, np.int32)
    pos, sidx = np.full(T, -1, np.int32), np.zeros(3, np.int32)
    o = 0
    for r, p in enumerate(prompts):
        toks[o:o + p.size], seg[o:o + p.size] = p, r
        pos[o:o + p.size] = np.arange(p.size)
        sidx[r] = o + p.size - 1
        o += -(-p.size // 8) * 8
    for c in (jc, tc):
        c.ensure_many([(r, p.size + K + 1) for r, p in enumerate(prompts)])
    tab = jc.table_array([0, 1, 2], 4)
    jsp, _m = js.packed_args([0, 1, 2], [True] * 3)
    jr = jd.packed_prefill(jp, jnp.asarray(toks), jnp.asarray(seg),
                           jnp.asarray(pos), jnp.asarray(tab),
                           jnp.asarray(sidx), jc.k_blocks, jc.v_blocks, jsp,
                           mode)
    jc.swap_arrays(jr[2], jr[3])
    js.swap_counts(jr[4])
    tok0 = np.asarray(jr[0])
    for i in range(3):  # token 0 joins the counts, as the server's
        if mode[1]:
            ts.counts[i] = torch.from_numpy(
                np.asarray(js.counts)[i].copy())
    for a, b in zip(_leaves(jc), _leaves(tc)):
        b.copy_(torch.from_numpy(np.asarray(a).copy()))
    greedy = [dense_greedy(tp, tcfg, np.append(p, tok0[r]), K)[p.size + 1:]
              for r, p in enumerate(prompts)]
    drafts = [greedy[0], np.empty((0,), np.int32),
              rs.randint(1, V, (K,)).astype(np.int32)]
    entries = [(r, int(tok0[r]), prompts[r].size, 1, drafts[r])
               for r in range(3)]
    return dict(jp=jp, tp=tp, jc=jc, tc=tc, jd=jd, jdl=jdl, td=td, js=js,
                ts=ts, entries=entries, K=K, jplan=jplan)


def _leaves(c):
    kb, vb = c.k_blocks, c.v_blocks
    out = []
    for x in (kb, vb):
        out += [x.codes, x.scales] if hasattr(x, "codes") else [x]
    return out


def _np_leaf(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_packed_verify_matches_reference(tiny, mode, kv_dtype):
    from paddle_tpu.sampling import greedy_args as jgreedy

    from paddle_tpu_torch.spec_decode import build_verify_plan

    s = verify_setup(tiny, mode, kv_dtype)
    plan = build_verify_plan(s["entries"], s["K"], 1, min_rows=4)
    jplan = s["jplan"](s["entries"], s["K"], 1, min_rows=4)
    P = plan.dlen.shape[0]
    rows = [0, 1, 2, None]
    tab = s["jc"].table_array(rows, 4)
    jsp, jmode = s["js"].verify_args(rows, jplan.steps)
    tsp, tmode = s["ts"].verify_args(rows, plan.steps)
    assert jmode == tmode == mode
    # the reference's packed prefill of the same stream (return_logits)
    # on the pre-verify pool: the logits at every verify position
    K1 = s["K"] + 1
    lr = s["jdl"].packed_prefill(
        s["jp"], jnp.asarray(jplan.toks), jnp.asarray(jplan.seg),
        jnp.asarray(jplan.pos), jnp.asarray(tab),
        jnp.asarray(jplan.sample_idx.reshape(-1)), s["jc"].k_blocks,
        s["jc"].v_blocks, jgreedy(P * K1))
    jr = s["jd"].packed_verify(
        s["jp"], jnp.asarray(jplan.toks), jnp.asarray(jplan.seg),
        jnp.asarray(jplan.pos), jnp.asarray(tab),
        jnp.asarray(jplan.sample_idx), jnp.asarray(jplan.dlen),
        s["jc"].k_blocks, s["jc"].v_blocks, jsp, jmode)
    tr = s["td"].packed_verify(
        s["tp"], t(plan.toks), t(plan.seg), t(plan.pos), t(tab),
        t(plan.sample_idx), t(plan.dlen), s["tc"].k_blocks,
        s["tc"].v_blocks, tsp, tmode)
    for n, name in enumerate(("vtok", "accepted", "stopped")):
        np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]),
                                      err_msg=name)
    np.testing.assert_allclose(
        tr[6].reshape(P * K1, -1).numpy(), np.asarray(lr[5]),
        atol=LOGIT_ATOL * (10 if kv_dtype else 1), rtol=0)
    if mode[1]:
        np.testing.assert_array_equal(tr[5].numpy(), np.asarray(jr[5]))
    else:
        assert tr[5] is None and jr[5] is None
    s["jc"].swap_arrays(jr[3], jr[4])
    for a, b in zip(_leaves(s["jc"]), _leaves(s["tc"])):
        a, b = _np_leaf(a), _np_leaf(b)
        if a.dtype == np.int8:  # one code step where rounding ties
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)
    # the case is real: slot 0 accepts its greedy drafts when greedy
    acc = np.asarray(jr[1])
    if not mode[0] and not mode[1]:
        assert acc[0] == s["K"] and acc[1] == 0


def test_packed_verify_position_steps_and_draft_counts(tiny):
    """Position j samples at PRNG step base + j, with drafts 1..j in its
    penalty counts: drafts grown one confirmed token at a time (each
    run's sample at the first unconfirmed position joins them) end in a
    verify that accepts all K, whose tokens are the confirmed ones; the
    count buffer grows by exactly the emitted tokens."""
    from paddle_tpu_torch.spec_decode import build_verify_plan

    mode = (True, True)
    s = verify_setup(tiny, mode)
    rows = [0, 1, 2, None]
    tab = t(s["jc"].table_array(rows, 4))
    base = s["ts"].counts.clone()
    K = s["K"]

    def run(drafts):
        entries = [(r, last, wpos, step, drafts[r])
                   for r, last, wpos, step, _d in s["entries"]]
        plan = build_verify_plan(entries, K, 1, min_rows=4)
        sp, _m = s["ts"].verify_args(rows, plan.steps)
        return s["td"].packed_verify(
            s["tp"], t(plan.toks), t(plan.seg), t(plan.pos), tab,
            t(plan.sample_idx), t(plan.dlen), s["tc"].k_blocks,
            s["tc"].v_blocks, sp, mode)

    seq = [np.empty((0,), np.int32) for _ in range(3)]
    for m in range(K):
        out = run(seq)
        vt = out[0].numpy()
        seq = [np.append(seq[r], vt[r, m]).astype(np.int32)
               for r in range(3)]
    out = run(seq)
    acc, stop = out[1].numpy(), out[2].numpy()
    vt = out[0].numpy()
    for r in range(3):
        np.testing.assert_array_equal(vt[r, :K], seq[r])
        assert acc[r] == K, r  # a stop flag does not reject a draft
    grown = (out[5] - base).sum(dim=1).numpy()
    emit = [int(np.flatnonzero(stop[r])[0]) + 1 if stop[r].any() else K + 1
            for r in range(3)]
    np.testing.assert_array_equal(grown, emit)


# ---- the speculating server -------------------------------------------------

class TestSpecParity:
    """Twins of the reference's `TestSpecParity`: the port's speculating
    server gives the reference's speculating server's tokens and the
    port's plain server's."""

    def test_greedy_ngram_matches_plain(self, tiny):
        rs = np.random.RandomState(1)
        V = tiny[1].vocab_size
        prompts = [rs.randint(1, V, (n,)).astype(np.int32)
                   for n in (3, 7, 5, 9)]
        plain, out, st, ref = _triple(tiny, prompts,
                                      dict(max_draft_tokens=3))
        _same(out, plain)
        _same(out, ref)
        sp = st["speculation"]
        assert sp["enabled"] and sp["proposed_tokens"] > 0
        assert sp["verify_dispatches"] > 0
        assert sp["proposed_tokens"] == (sp["accepted_tokens"]
                                         + sp["rolled_back_tokens"])

    def test_oracle_drafter_full_acceptance_fewer_dispatches(self, tiny):
        rs = np.random.RandomState(2)
        V = tiny[1].vocab_size
        prompts = [rs.randint(1, V, (n,)).astype(np.int32) for n in (4, 6)]
        plain, st_plain = _serve(_port(tiny, max_new_tokens=8),
                                 [(p, None) for p in prompts])
        jspec, tspec = _spec_pair(max_draft_tokens=7,
                                  drafter=ReplayDrafter(plain))
        out, st = _serve(_port(tiny, tspec, max_new_tokens=8),
                         [(p, None) for p in prompts])
        ref, st_ref = _serve(_ref(tiny, jspec, max_new_tokens=8),
                             [(p, None) for p in prompts])
        _same(out, plain)
        _same(out, ref)
        sp = st["speculation"]
        assert sp["acceptance_rate"] == 1.0
        assert sp["rolled_back_tokens"] == 0
        assert sp["verify_dispatches"] <= 2
        assert st["decode_steps"] < st_plain["decode_steps"]
        for key in ("proposed_tokens", "accepted_tokens",
                    "verify_dispatches", "slot_rounds"):
            assert sp[key] == st_ref["speculation"][key], key

    def test_sampled_fixed_seed_matches_plain(self, tiny):
        rs = np.random.RandomState(3)
        V = tiny[1].vocab_size
        prompts = [rs.randint(1, V, (n,)).astype(np.int32)
                   for n in (3, 7, 5)]
        params = dict(temperature=1.0, top_p=0.9, seed=123)
        jsp, tsp = _sp_pair(**params)
        plain, _ = _serve(_port(tiny), [(p, tsp) for p in prompts])
        plain_ref, _ = _serve(_ref(tiny), [(p, jsp) for p in prompts])
        _same(plain, plain_ref)
        spec = dict(max_draft_tokens=3,
                    drafter=CorruptingReplayDrafter(plain))
        _p, out, st, ref = _triple(tiny, prompts, spec, params)
        _same(out, plain)
        _same(out, ref)
        assert st["speculation"]["proposed_tokens"] > 0
        assert st["speculation"]["rolled_back_tokens"] > 0

    def test_sampled_full_acceptance_via_replay(self, tiny):
        rs = np.random.RandomState(4)
        V = tiny[1].vocab_size
        prompts = [rs.randint(1, V, (n,)).astype(np.int32) for n in (4, 6)]
        params = dict(temperature=1.1, top_k=8, seed=42,
                      presence_penalty=0.5)
        _jsp, tsp = _sp_pair(**params)
        plain, _ = _serve(_port(tiny), [(p, tsp) for p in prompts])
        _p, out, st, ref = _triple(
            tiny, prompts, dict(max_draft_tokens=3,
                                drafter=ReplayDrafter(plain)), params)
        _same(out, plain)
        _same(out, ref)
        assert st["speculation"]["acceptance_rate"] == 1.0

    def test_alone_vs_packed_invariance_under_speculation(self, tiny):
        """A fixed seed reproduces a request's tokens alone without
        speculation and packed with speculating co-residents, here with
        the draft-model seam (a stub over the port's weights)."""
        from paddle_tpu_torch.spec_decode import DraftModelDrafter, \
            SpecConfig

        rs = np.random.RandomState(5)
        V = tiny[1].vocab_size
        target = rs.randint(1, V, (6,)).astype(np.int32)
        others = [rs.randint(1, V, (n,)).astype(np.int32) for n in (3, 8)]
        _jsp, tsp = _sp_pair(temperature=1.0, top_p=0.95, seed=321)
        alone = _serve(_port(tiny), [(target, tsp)])[0][0]
        spec = SpecConfig(max_draft_tokens=3, drafter=DraftModelDrafter(
            _StubModel(tiny[2], tiny[3])))
        packed, st = _serve(_port(tiny, spec, max_slots=3),
                            [(o, None) for o in others] + [(target, tsp)])
        np.testing.assert_array_equal(alone, packed[-1])
        assert st["speculation"]["accepted_tokens"] > 0

    def test_prefix_cache_on_off_parity_under_speculation(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as JServer

        from paddle_tpu_torch.inference import PagedGenerationServer

        rs = np.random.RandomState(6)
        V = tiny[1].vocab_size
        prefix = rs.randint(1, V, (10,)).astype(np.int32)
        prompts = [np.concatenate([prefix, rs.randint(1, V, (n,)).astype(
            np.int32)]) for n in (3, 5)]
        params = dict(temperature=1.1, top_p=0.9, seed=5150)
        jsp, tsp = _sp_pair(**params)
        plain, _ = _serve(_port(tiny, max_new_tokens=5),
                          [(p, tsp) for p in prompts])
        jspec, tspec = _spec_pair(max_draft_tokens=3,
                                  drafter=CorruptingReplayDrafter(plain))
        outs = {}
        for on in (False, True):
            srv = PagedGenerationServer(
                tiny[2], max_slots=2, block_size=BS, max_prompt_len=16,
                max_new_tokens=5, enable_prefix_cache=on,
                speculation=tspec, device="cpu").start()
            try:  # one request at a time: the second attaches
                outs[on] = [srv.submit(p, sampling=tsp).result(timeout=600)
                            for p in prompts]
                if on:
                    assert srv.cache.stats()["prefix_cache"]["hits"] >= 1
                assert srv.cache.stats()["used_blocks"] == 0
            finally:
                srv.stop()
        jsrv = JServer(tiny[0], max_slots=2, block_size=BS,
                       max_prompt_len=16, max_new_tokens=5,
                       enable_prefix_cache=True, speculation=jspec).start()
        try:
            ref = [jsrv.submit(p, sampling=jsp).result(timeout=600)
                   for p in prompts]
        finally:
            jsrv.stop()
        _same(outs[True], outs[False])
        _same(outs[True], plain)
        _same(outs[True], ref)

    @pytest.mark.parametrize("qkw", [dict(kv_dtype="int8"),
                                     dict(quantization="w8a16"),
                                     dict(quantization="w8a16",
                                          kv_dtype="int8")],
                             ids=["kv8", "w8a16", "w8a16_kv8"])
    def test_quantized_speculation_matches_reference(self, tiny, qkw):
        """int8 KV and W8A16 (alone and together): the reference's
        speculating server with the same options, n-gram drafts on
        repetitive prompts, greedy and seeded sampled mixed, and the
        port's plain server with those options."""
        rs = np.random.RandomState(9)
        V = tiny[1].vocab_size
        base = rs.randint(1, V, (5,)).astype(np.int32)
        prompts = [np.tile(base, 3)[:10 + i] for i in range(3)]
        plain, out, st, ref = _triple(tiny, prompts,
                                      dict(max_draft_tokens=3),
                                      dict(temperature=0.8, seed=77), **qkw)
        _same(out, plain)
        _same(out, ref)
        assert st["speculation"]["verify_dispatches"] > 0

    def test_stop_token_inside_accepted_prefix(self, tiny):
        """A stop token emitted inside an accepted prefix ends the
        request there. The reference test's stop token (the third
        generated token of RandomState(7)'s prompt) is also its first;
        here the prompt is the first of RandomState(7)'s whose third
        generated token appears first at that place, so the replayed
        drafts carry it inside the accepted prefix."""
        V = tiny[1].vocab_size
        rs = np.random.RandomState(7)
        for _ in range(50):
            p = rs.randint(1, V, (4,)).astype(np.int32)
            ref = dense_greedy(tiny[2].flat_params(), tiny[3], p, 6)
            gen = ref[p.size:]
            if gen[2] not in gen[:2]:
                break
        else:
            pytest.fail("no prompt with a fresh third token")
        stop = int(gen[2])
        jsp, tsp = _sp_pair(stop_token_ids=(stop,))
        plain, _ = _serve(_port(tiny), [(p, tsp)])
        jspec, tspec = _spec_pair(max_draft_tokens=7,
                                  drafter=ReplayDrafter([ref]))
        out, st = _serve(_port(tiny, tspec), [(p, tsp)])
        refout, _ = _serve(_ref(tiny, jspec), [(p, jsp)])
        np.testing.assert_array_equal(out[0], plain[0])
        np.testing.assert_array_equal(out[0], refout[0])
        assert out[0].size == p.size + 3
        assert out[0][-1] == stop
        assert st["stop_reasons"]["stop_token"] == 1
        # the stop sat inside the accepted prefix: drafts after it went
        assert st["speculation"]["accepted_tokens"] >= 2

    def test_verify_failure_cleans_up_and_serves_on(self, tiny, monkeypatch):
        """A verify dispatch that raises fails exactly the speculating
        requests, releases their blocks, and the server serves later
        requests (the reference's recovery=False path). The drafter
        always proposes, so the failing verify runs on the first decode
        round."""
        srv = _port(tiny, _spec_pair(max_draft_tokens=3,
                                     drafter=AlwaysDrafter())[1],
                    max_new_tokens=4, recovery=False)
        boom = {"armed": True}
        real = srv._decoder.packed_verify

        def flaky(*a, **kw):
            if boom.pop("armed", False):
                raise RuntimeError("injected verify failure")
            return real(*a, **kw)

        monkeypatch.setattr(srv._decoder, "packed_verify", flaky)
        srv.start()
        try:
            rep = np.tile(np.array([5, 6, 7], np.int32), 4)
            bad = srv.submit(rep)
            with pytest.raises(RuntimeError, match="injected"):
                bad.result(timeout=600)
            assert "armed" not in boom
            assert srv.cache.stats()["used_blocks"] == 0
            p = np.random.RandomState(8).randint(
                1, tiny[1].vocab_size, (4,)).astype(np.int32)
            np.testing.assert_array_equal(
                srv.submit(p).result(timeout=600),
                dense_greedy(tiny[2].flat_params(), tiny[3], p, 4))
        finally:
            srv.stop()

    def test_disabled_speculation_keeps_schema_zeroed(self, tiny):
        """The reference's schema, zeros when speculation is off."""
        _out, st = _serve(_port(tiny), [(np.array([1, 2, 3], np.int32),
                                         None)])
        _rout, rst = _serve(_ref(tiny), [(np.array([1, 2, 3], np.int32),
                                          None)])
        assert st["speculation"] == rst["speculation"]
        assert st["speculation"]["enabled"] is False
        assert st["speculation"]["verify_dispatches"] == 0
