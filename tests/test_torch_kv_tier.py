"""The port's host-RAM KV tier (paddle_tpu_torch/inference/kv_tier.py and
the pool's tier half) on the CPU — twins of tests/test_kv_tier.py and
TestTierInterleavingFuzz of tests/test_prefix_cache.py:

  * demotion and promotion round trips, the watermark sweep, the tier's
    capacity LRU, re-publication dropping a stale tier copy, the zeroed
    stats block and the constructor checks, each through
    `torch_twin_util.PoolMirror` (every op compared with the reference
    pool, every pool element and tier payload bit for bit);
  * a fixed-seed op sequence with demote_cold and promoting matches,
    dense and int8 pools, step against the reference pool;
  * the reference's tier interleaving fuzzes, through the same mirror;
  * the server: tier on == off == the reference server's tokens with
    demotion forced mid-run (greedy and a fixed seed, dense and int8
    pools), a warm resume after full demotion, and the migration of a
    partially tiered session.

Dense pools go through the tier as int8 codes (`kv_encode` on demote,
`kv_decode` on promote), a lossy codec by design: the promoted rows are
held within absmax/254 of the demoted ones. Against the reference they
were found bitwise — both encoders take the absmax in float32, divide by
127 and then divide each element by that scale, rounding half to even —
and the mirror asserts bitwise."""
import time

import numpy as np
import pytest
import torch

from torch_twin_util import (PoolMirror, check_pool_invariants, hold_at,
                             pool_step_fuzz, reference_tiny_model)

from paddle_tpu_torch.inference.kv_cache import (BlockPoolExhausted,
                                                 PagedKVCache)
from paddle_tpu_torch.inference.kv_tier import (HostKVTier,
                                                disabled_tier_stats,
                                                normalize_kv_tier)

torch.set_num_threads(1)


def _tiered(capacity_blocks, watermark, **kw):
    kw.setdefault("block_size", 4)
    return PoolMirror(tier=dict(capacity_blocks=capacity_blocks,
                                watermark=watermark), **kw)


def _rows(c, b, rows):
    """The port pool's K rows [0, rows) of block b: (codes, scales) or
    the dense rows, as numpy copies."""
    k = c.k_blocks
    if c.kv_dtype == "int8":
        return (k.codes[:, b, :rows].numpy().copy(),
                k.scales[:, b, :rows].numpy().copy())
    return (k[:, b, :rows].numpy().copy(),)


class TestTierPoolUnit:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"],
                             ids=["dense", "int8"])
    def test_demote_promote_round_trip(self, kv_dtype):
        c = _tiered(16, 0.0, num_blocks=8, kv_dtype=kv_dtype,
                    shape=(2, 2, 4))
        rng = np.random.RandomState(0)
        ids = rng.randint(0, 100, size=11)
        c.allocate("s", 11)
        tbl = c.block_table("s")
        c.write("s", 0)
        snap = {b: _rows(c, b, 4) for b in tbl}
        c.publish_prefix("s", ids)
        c.free("s")
        avail0 = c.available_block_count
        assert c.demote_cold(10) == 3
        assert c.available_block_count == avail0
        assert c.retained_block_count == 0
        assert len(c.tier) == 3 and not c._index
        st = c.stats()["tier"]
        assert st["enabled"] and st["demotions"] == 3
        assert st["tiered_tokens"] == 11
        assert c.match_prefix_len(ids) == 10  # len-1 cap
        st = c.stats()["tier"]
        assert st["promotions"] == 3 and st["hit_tokens"] == 10
        assert len(c.tier) == 0
        assert c.attach_prefix("t", ids) == 10
        for bi, (b_old, b_new) in enumerate(zip(tbl, c.block_table("t"))):
            rows = min(4, 11 - bi * 4)
            old = [x[:, :rows] for x in snap[b_old]]
            new = _rows(c, b_new, rows)
            if kv_dtype == "int8":   # the pool's own codes and scales
                for x, y in zip(old, new):
                    np.testing.assert_array_equal(x, y)
            else:                    # kv_encode / kv_decode round trip
                err = np.abs(old[0] - new[0])
                assert err.max() <= np.abs(old[0]).max() / 254 + 1e-6

    def test_watermark_sweep_on_release(self):
        c = _tiered(8, 0.9, num_blocks=6, shape=(2, 2, 4))
        c.allocate("a", 9)
        c.write("a", 0)
        c.publish_prefix("a", np.arange(9))
        c.free("a")
        # low = 0.9 * 5 = 4: free() left free=2, the sweep demotes until
        # free recovers to 4, leaving one retained
        assert c.free_block_count == 4
        assert c.retained_block_count == 1
        assert len(c.tier) == 2

    def test_tier_capacity_lru_evicts(self):
        c = _tiered(2, 0.0, num_blocks=8)
        for i, tok0 in enumerate((0, 100, 200)):
            c.allocate(i, 8)
            c.write(i, 0)
            c.publish_prefix(i, np.arange(tok0, tok0 + 8))
            c.free(i)
            c.demote_cold(4)
        assert len(c.tier) == 2
        assert c.tier.evictions > 0
        assert c.match_prefix_len(np.arange(0, 9)) == 0

    def test_republish_drops_stale_tier_copy(self):
        c = _tiered(8, 0.0, num_blocks=8)
        ids = np.arange(8)
        c.allocate("a", 8)
        c.publish_prefix("a", ids)
        c.free("a")
        c.demote_cold(2)
        assert len(c.tier) == 2
        c.allocate("b", 8)
        c.publish_prefix("b", ids)
        assert len(c.tier) == 0
        assert not set(c._index) & set(c.tier._entries)

    def test_stats_zeroed_when_disabled(self):
        plain = PagedKVCache(1, 1, 2, block_size=4, num_blocks=4,
                             device="cpu")
        tiered = PagedKVCache(1, 1, 2, block_size=4, num_blocks=4,
                              tier=True, device="cpu")
        off, on = plain.stats()["tier"], tiered.stats()["tier"]
        assert set(off) == set(on)
        assert off == disabled_tier_stats()
        assert off["enabled"] is False and on["enabled"] is True
        assert all(off[k] == 0 for k in off if k != "enabled")
        from paddle_tpu.inference.kv_tier import disabled_tier_stats as jd

        assert off == jd()

    def test_normalize_and_validation(self):
        assert normalize_kv_tier(None) is None
        assert isinstance(normalize_kv_tier(True), HostKVTier)
        t = HostKVTier(capacity_blocks=3)
        assert normalize_kv_tier(t) is t
        with pytest.raises(TypeError, match="HostKVTier"):
            normalize_kv_tier("big")
        with pytest.raises(ValueError, match="capacity_blocks"):
            HostKVTier(capacity_blocks=0)
        with pytest.raises(ValueError, match="watermark"):
            HostKVTier(watermark=1.5)

    def test_tier_events_reported(self):
        """`on_tier_event` sees each demotion, each promotion and one
        aggregated `tier_promote` per promoting walk."""
        c = PagedKVCache(1, 1, 2, block_size=4, num_blocks=8, device="cpu",
                         tier=HostKVTier(capacity_blocks=8, watermark=0.0))
        seen = []
        c.on_tier_event = lambda kind, **f: seen.append((kind, f))
        c.allocate("a", 8)
        c.publish_prefix("a", np.arange(8))
        c.free("a")
        c.demote_cold(2)
        c.match_prefix_len(np.arange(9))
        kinds = [k for k, _ in seen]
        assert kinds == ["demote", "demote", "promote", "promote",
                         "tier_promote"]
        agg = seen[-1][1]
        assert agg["blocks"] == 2 and agg["tokens"] == 8
        assert agg["bytes"] == c.stats()["tier"]["bytes_in"] > 0
        assert agg["overlapped"] is False


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("seed", [41, 42])
def test_tier_pool_step_against_reference(kv_dtype, seed):
    """Every op of a fixed-seed sequence with demotions and promotions
    gives the reference pool's result and state, tier payloads and pool
    elements bit for bit."""
    c = _tiered(6, 0.25, num_blocks=12, kv_dtype=kv_dtype, seed=seed)
    st = pool_step_fuzz(c, np.random.RandomState(seed), 250, tier=True)
    t = st["tier"]
    assert t["demotions"] > 5 and t["promotions"] > 5
    assert t["hit_tokens"] > 0


def _tier_fuzz(n_ops, seed, kv_dtype=None):
    """TestTierInterleavingFuzz._fuzz's op mix, on a PoolMirror."""
    rs = np.random.RandomState(seed)
    c = _tiered(6, 0.25, num_blocks=12, kv_dtype=kv_dtype)
    master = rs.randint(1, 50, size=40).astype(np.int32)
    live = {}
    next_seq = [0]

    def new_tokens():
        n = int(rs.randint(1, 26))
        t = master[:n].copy()
        if rs.rand() < 0.4:
            t = np.concatenate([t, rs.randint(
                1, 50, size=int(rs.randint(1, 7))).astype(np.int32)])
        return t

    def op_admit():
        seq = next_seq[0]
        next_seq[0] += 1
        toks = new_tokens()
        try:
            cached = c.attach_prefix(seq, toks)
            if cached == 0:
                c.allocate(seq, toks.size)
            else:
                c.prepare_write(seq, cached)
                c.ensure(seq, toks.size)
        except BlockPoolExhausted:
            if c.has_seq(seq):
                c.free(seq)
            return
        live[seq] = toks

    def op_probe():
        c.match_prefix_len(new_tokens())

    def op_demote():
        c.demote_cold(int(rs.randint(1, 4)))

    def op_publish():
        if live:
            seq = list(live)[int(rs.randint(len(live)))]
            c.publish_prefix(seq, live[seq])

    def op_write():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        try:
            c.prepare_write(seq, int(rs.randint(0, c.seq_len(seq) + 1)))
        except BlockPoolExhausted:
            pass

    def op_truncate():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        c.truncate_seq(seq, int(rs.randint(0, c.seq_len(seq) + 1)))
        live[seq] = live[seq][:c.seq_len(seq)]
        if live[seq].size == 0:
            c.free(seq)
            del live[seq]

    def op_swap_out():
        if live:
            seq = list(live)[int(rs.randint(len(live)))]
            c.swap_out_seq(seq, live[seq])
            del live[seq]

    def op_free():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        if rs.rand() < 0.5:
            c.publish_prefix(seq, live[seq])
        c.free(seq)
        del live[seq]

    ops = [op_admit, op_admit, op_probe, op_demote, op_publish, op_write,
           op_truncate, op_swap_out, op_free]
    for _ in range(n_ops):
        ops[int(rs.randint(len(ops)))]()
        check_pool_invariants(c.port)
    for seq in list(live):
        c.free(seq)
        check_pool_invariants(c.port)
    assert c._ref == {}
    assert c.free_block_count + c.retained_block_count == c.num_blocks - 1
    st = c.stats()["tier"]
    assert st["enabled"]
    assert st["demotions"] > 5
    assert st["promotions"] > 5
    assert st["hit_tokens"] > 0
    return c


class TestTierInterleavingFuzz:
    def test_tier_interleaving_keeps_invariants(self):
        _tier_fuzz(300, seed=2026)

    def test_tier_interleaving_int8_pool(self):
        _tier_fuzz(300, seed=2027, kv_dtype="int8")

    def test_tier_interleaving_long(self):
        c = _tier_fuzz(2500, seed=909)
        assert c.tier.evictions > 0


# ---- the server -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(11)
    return model, cfg, port, tcfg


def _port_server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("device", "cpu")
    return PagedGenerationServer(port, **kw)


def _ref_server(model, **kw):
    from paddle_tpu.inference import PagedGenerationServer

    return PagedGenerationServer(model, **kw)


def test_ctor_requires_prefix_cache(tiny):
    port = tiny[2]
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        _port_server(port, kv_tier=True)
    with pytest.raises(ValueError, match="kv_dtype"):
        _port_server(port, kv_dtype="fp8")
    with pytest.raises(TypeError, match="HostKVTier"):
        _port_server(port, enable_prefix_cache=True, kv_tier="big")


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_tier_on_off_token_parity_forced_demotion(tiny, kv_dtype):
    """Tier on == off on a pool sized so demotion fires mid-run (shared
    prefix churn under a high watermark), greedy and at a fixed seed —
    and both equal to the reference server with its tier on."""
    from paddle_tpu.inference.kv_tier import HostKVTier as JTier
    from paddle_tpu.sampling import SamplingParams as JParams

    from paddle_tpu_torch.sampling import SamplingParams

    model, cfg, port, tcfg = tiny
    rng = np.random.RandomState(7)
    shared = rng.randint(1, tcfg.vocab_size, (24,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        1, tcfg.vocab_size, (k,)).astype(np.int32)]) for k in (3, 5, 7, 4)]
    spec = dict(temperature=0.9, top_p=0.9, seed=5)
    kw = dict(max_slots=2, block_size=8, max_new_tokens=6,
              prefill_chunk_tokens=16, enable_prefix_cache=True,
              num_blocks=14, max_prompt_len=40, kv_dtype=kv_dtype)

    def run(srv, params):
        sps = [None, params, None, None]
        outs = []
        srv.start()
        try:
            for p, s in zip(prompts, sps):   # sequential churn
                outs.append(srv.submit(p, sampling=s)
                            .result(timeout=600).tolist())
            batch = [srv.submit(p, sampling=s) for p, s in zip(prompts, sps)]
            outs += [f.result(timeout=600).tolist() for f in batch]
        finally:
            srv.stop()
        return outs, srv.stats()

    off, _ = run(_port_server(port, **kw), SamplingParams(**spec))
    on, st = run(_port_server(port, kv_tier=HostKVTier(
        capacity_blocks=32, watermark=0.5), **kw), SamplingParams(**spec))
    ref, _ = run(_ref_server(model, kv_tier=JTier(
        capacity_blocks=32, watermark=0.5), **kw), JParams(**spec))
    assert on == off
    assert on == ref
    # the counts depend on when the loop admits the burst, so they are
    # held to the reference pool's only in the pool twins (PoolMirror)
    t = st["kv_cache"]["tier"]
    assert t["demotions"] > 0, "pool never demoted — dead test"
    assert t["promotions"] > 0 and t["hit_tokens"] > 0


def test_warm_resume_promotes_after_demotion(tiny):
    """Publish, demote everything, resubmit: the attach promotes the
    tiered chain and the tokens are the first run's."""
    port, tcfg = tiny[2], tiny[3]
    rng = np.random.RandomState(9)
    prompt = rng.randint(1, tcfg.vocab_size, (21,)).astype(np.int32)
    srv = _port_server(port, max_slots=1, block_size=8, max_prompt_len=32,
                       max_new_tokens=6, enable_prefix_cache=True,
                       kv_tier=HostKVTier(capacity_blocks=16, watermark=0.0),
                       prefill_chunk_tokens=16).start()
    try:
        first = srv.submit(prompt).result(timeout=600)
        assert srv.cache.demote_cold(16) > 0
        assert srv.cache.retained_block_count == 0
        again = srv.submit(prompt).result(timeout=600)
        st = srv.stats()
    finally:
        srv.stop()
    np.testing.assert_array_equal(first, again)
    t = st["kv_cache"]["tier"]
    assert t["promotions"] > 0 and t["hit_tokens"] > 0
    assert st["kv_cache"]["prefix_cache"]["hit_tokens"] > 0


def test_migration_of_partially_tiered_session(tiny):
    """export_prefix with part of the chain in the tier promotes it
    first; a fresh server imports the payload and serves the prompt
    with the prefix warm and the same tokens."""
    port, tcfg = tiny[2], tiny[3]
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, tcfg.vocab_size, (21,)).astype(np.int32)
    mk = dict(max_slots=1, block_size=8, max_prompt_len=32,
              max_new_tokens=6, enable_prefix_cache=True,
              prefill_chunk_tokens=16)
    src = _port_server(port, kv_tier=HostKVTier(capacity_blocks=16,
                                                 watermark=0.0),
                       **mk).start()
    try:
        first = src.submit(prompt).result(timeout=600)
        assert src.cache.demote_cold(1) == 1
        assert len(src.cache.tier) >= 1
        payload = src.cache.export_prefix(prompt)
    finally:
        src.stop()
    assert payload is not None
    assert sum(payload["fills"]) >= prompt.size - 1
    dst = _port_server(port, **mk).start()
    try:
        assert dst.cache.import_prefix(payload) == sum(payload["fills"])
        out = dst.submit(prompt).result(timeout=600)
        st = dst.stats()
    finally:
        dst.stop()
    np.testing.assert_array_equal(first, out)
    assert st["kv_cache"]["prefix_cache"]["hit_tokens"] \
        >= prompt.size - (payload["block_size"] + 1)


# ---- the front door and prefetch-ahead ---------------------------------------

def test_frontdoor_preempt_resume_with_tier(tiny):
    """Preemption composed with the tier: the victim's swap-out content
    lives through pool pressure in the tier, and both requests give the
    reference's tokens."""
    from paddle_tpu_torch.frontend import FrontDoor

    model, cfg, port, tcfg = tiny
    rs = np.random.RandomState(2)
    pv = rs.randint(1, tcfg.vocab_size, (1, 7)).astype(np.int32)[0]
    pi = rs.randint(1, tcfg.vocab_size, (1, 4)).astype(np.int32)[0]
    fd = FrontDoor(port, max_slots=1, block_size=4, max_prompt_len=16,
                   max_new_tokens=24, enable_prefix_cache=True,
                   kv_tier=HostKVTier(capacity_blocks=16, watermark=0.6),
                   device="cpu").start()
    try:
        cb, reached, go = hold_at(2)
        hv = fd.submit(pv, lane="batch", max_new_tokens=24, on_token=cb)
        assert reached.wait(120)
        hi = fd.submit(pi, lane="interactive", max_new_tokens=3)
        go.set()
        out_i = hi.result(timeout=600)
        out_v = hv.result(timeout=600)
        st = fd.stats()
    finally:
        fd.stop()
    assert st["frontdoor"]["preemptions"] >= 1
    assert st["frontdoor"]["resumes"] >= 1
    np.testing.assert_array_equal(out_v,
                                  model.generate(pv[None], 24).numpy()[0])
    np.testing.assert_array_equal(out_i,
                                  model.generate(pi[None], 3).numpy()[0])


class TestTierPrefetchAhead:
    """Tier prefetch-ahead: a QUEUED request's tiered blocks promote into
    the pool while the current round runs, so its admission attach finds
    them resident, with the same tokens either way."""

    _kw = dict(max_slots=1, block_size=8, max_prompt_len=32,
               enable_prefix_cache=True, prefill_chunk_tokens=16)

    def test_ctor_validation(self, tiny):
        port = tiny[2]
        with pytest.raises(ValueError, match="tier_prefetch"):
            _port_server(port, tier_prefetch=True,
                         enable_prefix_cache=True)
        with pytest.raises(ValueError, match="tier_prefetch"):
            _port_server(port, tier_prefetch=0, kv_tier=True,
                         enable_prefix_cache=True)

    @pytest.mark.parametrize("front", ["fifo", "frontdoor"])
    def test_prefetch_ahead_hits_and_token_parity(self, tiny, front):
        """Demote a finished prompt's chain, hold the only slot busy and
        queue the prompt again: the tick promotes the chain during the
        occupier's rounds (under a front door through the scheduler's
        `peek`, which pops and charges nobody), the admission settles
        every block as a hit, and the tokens equal the first run's."""
        from paddle_tpu_torch.frontend import FrontDoor

        port, tcfg = tiny[2], tiny[3]
        rng = np.random.RandomState(9)
        prompt = rng.randint(1, tcfg.vocab_size, (21,)).astype(np.int32)
        other = rng.randint(1, tcfg.vocab_size, (5,)).astype(np.int32)
        kw = dict(self._kw, max_new_tokens=16,
                  kv_tier=HostKVTier(capacity_blocks=16, watermark=0.0),
                  tier_prefetch=True, flight_recorder=True)
        if front == "fifo":
            srv = _port_server(port, **kw)
            fd = None
        else:
            fd = FrontDoor(port, device="cpu", **kw)
            srv = fd.server
        srv.start()
        sub = ((lambda p, lane, tenant, **k: srv.submit(p, **k))
               if fd is None else
               (lambda p, lane, tenant, **k: fd.submit(
                   p, lane=lane, tenant=tenant, **k)))
        try:
            first = sub(prompt, "batch", "b").result(timeout=600)
            assert srv.cache.demote_cold(16) > 0
            cb, reached, go = hold_at(1)
            fa = sub(other, "interactive", "a", on_token=cb)
            assert reached.wait(120)
            fb = sub(prompt, "batch", "b")   # queued behind the occupier
            go.set()
            fa.result(timeout=600)
            again = fb.result(timeout=600)
            st = srv.stats()
            ring = [e for e in srv._recorder.events()
                    if e["name"] == "tier_promote"]
        finally:
            srv.stop()
        np.testing.assert_array_equal(first, again)
        tp = st["tier_prefetch"]
        assert tp["enabled"] and tp["lookahead"] == 2
        assert tp["issued_blocks"] > 0, "prefetch never fired"
        assert tp["hit_blocks"] == tp["issued_blocks"]
        assert tp["hit_rate"] > 0.8
        assert tp["overlap_promote_s"] > 0.0
        ov = [e for e in ring if e.get("overlapped")]
        assert ov and ov[0]["blocks"] > 0 and ov[0]["bytes"] > 0
        assert ov[0]["dur_s"] > 0
        if fd is not None:
            lanes = st["frontdoor"]["lanes"]
            assert lanes["batch"]["ttft"]["n"] == 2
            assert lanes["interactive"]["ttft"]["n"] == 1
            assert st["frontdoor"]["rate_throttled_skips"] == 0
            assert st["requests"] == 3

    def test_sync_promote_event_split_from_admission(self, tiny):
        """The synchronous promote-on-attach walk emits its own
        `tier_promote` event carrying the request id; the assembler
        reports it beside the phases, which still tile the wall clock."""
        from paddle_tpu_torch.observability import tracing as T

        port, tcfg = tiny[2], tiny[3]
        rng = np.random.RandomState(13)
        prompt = rng.randint(1, tcfg.vocab_size, (21,)).astype(np.int32)
        T.TRACER.reset()
        T.enable()
        try:
            srv = _port_server(port, max_new_tokens=4,
                               kv_tier=HostKVTier(capacity_blocks=16,
                                                  watermark=0.0),
                               **self._kw).start()
            try:
                srv.submit(prompt).result(timeout=600)
                assert srv.cache.demote_cold(16) > 0
                srv.submit(prompt).result(timeout=600)
            finally:
                srv.stop()
            evs = T.events()
            proms = [e for e in evs if e.get("name") == "tier_promote"]
            assert proms, "sync attach promoted without the event"
            ev = proms[-1]
            assert ev["blocks"] > 0 and ev["bytes"] > 0
            assert ev["overlapped"] is False
            assert ev.get("request_id"), "promote not attributed"
            rec = T.assemble_request_traces(evs)[ev["request_id"]]
            assert rec["tier_promote_ms"] > 0
            assert rec["tier_promote_blocks"] == ev["blocks"]
            assert "tier_promote" not in rec["phases_ms"]
            assert sum(rec["phases_ms"].values()) == \
                pytest.approx(rec["wall_ms"], rel=0.10)
        finally:
            T.disable()
            T.TRACER.reset()

    def test_wasted_on_timeout_expiry(self, tiny):
        """A queued request that times out before its admission settles
        what was prefetched for it as wasted."""
        from paddle_tpu_torch.reliability import RequestTimeout

        port, tcfg = tiny[2], tiny[3]
        rng = np.random.RandomState(17)
        prompt = rng.randint(1, tcfg.vocab_size, (21,)).astype(np.int32)
        other = rng.randint(1, tcfg.vocab_size, (5,)).astype(np.int32)
        srv = _port_server(port, max_new_tokens=24,
                           kv_tier=HostKVTier(capacity_blocks=16,
                                              watermark=0.0),
                           tier_prefetch=True, **self._kw).start()
        try:
            srv.submit(prompt).result(timeout=600)
            assert srv.cache.demote_cold(16) > 0
            cb, reached, go = hold_at(1)
            fa = srv.submit(other, on_token=cb)
            assert reached.wait(120)
            fb = srv.submit(prompt, timeout_s=0.05)
            # the occupier resumes only once fb is past its deadline:
            # the round's tick prefetches for fb, the next loop pass
            # expires it while it is still queued
            time.sleep(0.1)
            go.set()
            with pytest.raises(RequestTimeout):
                fb.result(timeout=600)
            fa.result(timeout=600)
            st = srv.stats()
        finally:
            srv.stop()
        tp = st["tier_prefetch"]
        assert tp["issued_blocks"] > 0
        assert tp["wasted_blocks"] == tp["issued_blocks"]
        assert tp["hit_blocks"] == 0

    def test_stats_schema_zeroed_when_disabled(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as RefSrv

        model, port = tiny[0], tiny[2]
        kw = dict(max_slots=1, max_prompt_len=16, max_new_tokens=4)
        off = _port_server(port, **kw).stats()["tier_prefetch"]
        assert off == RefSrv(model, **kw).stats()["tier_prefetch"]
        assert off["enabled"] is False
        assert all(off[k] == 0 for k in off if k != "enabled")
        assert set(off) == {"enabled", "lookahead", "issued_blocks",
                            "hit_blocks", "wasted_blocks", "hit_rate",
                            "overlap_promote_s"}
