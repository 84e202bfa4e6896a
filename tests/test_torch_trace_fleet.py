"""The port's causal tracing (paddle_tpu_torch/observability/
trace_context.py and the paged server's trace stamps) on the CPU: twins
of tests/test_trace_fleet.py, its fleet cases on the port's
`paddle_tpu_torch.fleet`.

  * `TraceContext` equals the reference's: the same fields, the same
    dict form, the same stamps.
  * The port's server stamps every event, flight-recorder entry and
    journal record of a request with one trace_id; the causal assembler
    folds a fault retry and a journal recovery into new hops of the
    same trace, with phases tiling the wall clock.
  * A journal written by the reference's server, whose entry carries
    meta and a trace context, is recovered by the port's server into
    the same trace and the same tenant.
  * Across a fleet: a replica killed mid-stream leaves one tree per
    request spanning both replicas (hops admit, failover), and a planned
    migration links the source hop to the target hop; the tokens are
    the reference fleet's.
A crash lands at a fixed token by an on_token callback that waits until
the engine is stopped: nothing here leans on a wall-clock margin."""
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability import tracing  # noqa: E402
from paddle_tpu_torch.observability.trace_context import (  # noqa: E402
    TraceContext, assemble_causal_traces, check_tiling)
from paddle_tpu_torch.reliability import FaultPlan  # noqa: E402

TILE_TOL_MS = 0.05  # float-rounding tolerance on exact tiling


@pytest.fixture(autouse=True)
def _tracer_guard():
    was = tracing.enabled()
    tracing.enable()
    tracing.reset()
    yield
    tracing.reset()
    if not was:
        tracing.disable()


@pytest.fixture(scope="module")
def tiny():
    """(reference GPT2, the port's GPT2 with the same float32 weights)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(100)
    cfg = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=4, max_position=128)
    cfg.dropout = 0.0
    ref = GPT2(cfg)
    ref.eval()
    params, _ = ref.functional_state()
    tcfg = TConfig(vocab_size=512, hidden_size=128, num_layers=2,
                   num_heads=4, max_position=128, dropout=0.0)
    port = from_reference_params(
        tcfg, {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return ref, port


def _kw(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_prompt_len", 24)
    kw.setdefault("max_new_tokens", 8)
    return kw


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, device="cpu", **_kw(kw))


def _kill_at(srv, n):
    """An on_token callback that holds the engine at its n-th token
    (bounded) until `srv` is stopped; `reached` tells the caller when to
    kill."""
    reached = threading.Event()
    seen = [0]

    def cb(_tok, _reason):
        seen[0] += 1
        if seen[0] == n:
            reached.set()
            deadline = time.monotonic() + 60
            while not srv.liveness()[1]["stopped"] \
                    and time.monotonic() < deadline:
                time.sleep(0.001)

    return cb, reached


WORK = [np.array([3, 5, 7, 9], np.int32), np.array([1, 2, 3], np.int32),
        np.array([8, 8, 1, 4, 2], np.int32)]


class TestTraceContext:
    def test_mint_is_unique_hop0_admit(self):
        a, b = TraceContext.mint(), TraceContext.mint()
        assert a.trace_id != b.trace_id
        assert a.hop == 0 and a.cause == "admit"

    def test_child_bumps_hop_and_sets_cause(self):
        c = TraceContext.mint()
        f = c.child("failover")
        assert (f.trace_id, f.hop, f.cause) == (c.trace_id, 1, "failover")
        assert f.child("retry").hop == 2

    def test_immutable_and_validated(self):
        c = TraceContext.mint()
        with pytest.raises(AttributeError):
            c.hop = 3
        with pytest.raises(ValueError, match="cause"):
            c.child("teleport")
        with pytest.raises(ValueError, match="hop"):
            TraceContext("t", hop=-1)

    def test_dict_round_trip(self):
        from paddle_tpu.observability.trace_context import \
            TraceContext as RefCtx

        c = TraceContext("tX", 2, "migration")
        assert TraceContext.from_dict(c.to_dict()) == c
        assert TraceContext.from_dict(None) is None
        # the two packages speak one dict form
        assert RefCtx.from_dict(c.to_dict()).to_dict() == c.to_dict()
        assert TraceContext.from_dict(
            RefCtx("tY", 1, "retry").to_dict()) == \
            TraceContext("tY", 1, "retry")

    def test_attrs_carry_replica(self):
        d = TraceContext("tX", 1, "retry").attrs(replica="r3")
        assert d == {"trace_id": "tX", "hop": 1, "cause": "retry",
                     "replica": "r3"}
        assert "replica" not in TraceContext("tX").attrs()


class TestEngineStamping:
    def test_events_ring_and_journal_share_one_trace_id(self, tiny,
                                                        tmp_path):
        _ref, port = tiny
        srv = _server(port, journal=str(tmp_path / "j.jsonl"),
                      flight_recorder=True).start()
        try:
            out = srv.submit(np.array([3, 5, 7], np.int32),
                             max_new_tokens=4).result(timeout=300)
        finally:
            srv.stop()
        assert out.size == 7
        evs = [e for e in tracing.events() if e.get("trace_id")]
        tids = {e["trace_id"] for e in evs}
        assert len(tids) == 1
        assert {"request_submitted", "request_admitted", "prefill",
                "request_done", "detokenize"} <= {e["name"] for e in evs}
        for e in evs:
            assert e["hop"] == 0 and e["cause"] == "admit"
        ring = {e["name"]: e for e in srv._recorder.events()}
        tid = tids.pop()
        for name in ("submit", "admit", "request_done"):
            assert ring[name]["trace_id"] == tid, name
            assert ring[name]["cause"] == "admit"
        accepts = [st["ent"] for st in srv._journal._state.values()]
        assert accepts and accepts[0]["trace"]["trace_id"] == tid

    def test_single_hop_assembly_tiles_wall_clock(self, tiny):
        _ref, port = tiny
        srv = _server(port).start()
        try:
            futs = [srv.submit(ids, max_new_tokens=4) for ids in WORK]
            for f in futs:
                f.result(timeout=300)
        finally:
            srv.stop()
        recs = assemble_causal_traces()
        assert len(recs) == 3
        for r in recs.values():
            assert r["n_hops"] == 1 and r["causes"] == ["admit"]
            assert r["complete"]
            assert r["tree"]["name"] == "request"
            assert check_tiling(r) < TILE_TOL_MS
            phases = [c["name"] for c in r["hops"][0]["children"]]
            assert phases == ["queue_wait", "admission", "prefill",
                              "decode", "detokenize"]
            for leaf in r["hops"][0]["children"]:
                assert leaf["hop"] == 0 and leaf["cause"] == "admit"

    def test_fault_retry_starts_a_retry_hop(self, tiny):
        from paddle_tpu_torch.reliability import RecoveryPolicy

        _ref, port = tiny
        plan = FaultPlan([("decode", 0)], name="one-decode-fault")
        srv = _server(port, fault_plan=plan,
                      recovery=RecoveryPolicy(backoff_base_s=0.0)).start()
        try:
            out = srv.submit(np.array([3, 5, 7, 9], np.int32),
                             max_new_tokens=6).result(timeout=300)
        finally:
            srv.stop()
        assert out.size == 10
        (rec,) = assemble_causal_traces().values()
        assert rec["n_hops"] == 2
        assert rec["causes"] == ["admit", "retry"]
        assert [h["hop"] for h in rec["hops"]] == [0, 1]
        assert rec["complete"]
        assert check_tiling(rec) < TILE_TOL_MS

    def test_trace_ctx_passthrough_and_validation(self, tiny):
        _ref, port = tiny
        srv = _server(port)
        with pytest.raises(TypeError, match="TraceContext"):
            srv.submit(np.array([1, 2], np.int32), trace_ctx="nope")
        ctx = TraceContext.mint().child("failover")
        srv.start()
        try:
            srv.submit(np.array([1, 2], np.int32), max_new_tokens=2,
                       trace_ctx=ctx).result(timeout=300)
        finally:
            srv.stop()
        evs = [e for e in tracing.events()
               if e.get("trace_id") == ctx.trace_id]
        assert evs and all(e["hop"] == 1 and e["cause"] == "failover"
                           for e in evs)


class TestJournalRecovery:
    def test_journal_recovery_resumes_the_same_trace(self, tiny,
                                                     tmp_path):
        """kill + recover_from_journal: the re-admission is a new hop of
        the SAME trace (cause retry), carried by the journal entry, and
        the output equals an uninterrupted run's."""
        _ref, port = tiny
        path = str(tmp_path / "j.jsonl")
        prompt = np.array([3, 5, 7, 9], np.int32)
        srv = _server(port, journal=path, max_new_tokens=16).start()
        cb, reached = _kill_at(srv, 2)
        fut = srv.submit(prompt, max_new_tokens=16, on_token=cb)
        assert reached.wait(timeout=120)
        srv.kill()
        assert not fut.done()
        srv2 = _server(port, journal=path, max_new_tokens=16).start()
        try:
            (out,) = [f.result(timeout=300)
                      for f in srv2.recover_from_journal().values()]
        finally:
            srv2.stop()
        solo = _server(port, max_new_tokens=16).start()
        try:
            want = solo.submit(prompt, max_new_tokens=16).result(
                timeout=300)
        finally:
            solo.stop()
        np.testing.assert_array_equal(out, want)
        recs = assemble_causal_traces()
        multi = [r for r in recs.values() if r["n_hops"] == 2]
        assert len(multi) == 1
        assert multi[0]["causes"] == ["admit", "retry"]
        assert check_tiling(multi[0]) < TILE_TOL_MS

    def test_reference_journal_entry_keeps_meta_and_trace(self, tiny,
                                                          tmp_path):
        """A journal the reference's server left at kill(), for a
        request with a RequestMeta and a trace context, is recovered by
        the port's server: the resumed request keeps its tenant and
        lane (they reach the attribution ledger and the lane stats) and
        continues the same trace as hop 1, cause retry."""
        from paddle_tpu.inference import PagedGenerationServer as RefSrv
        from paddle_tpu.inference.serving import RequestMeta as RefMeta
        from paddle_tpu.observability.trace_context import \
            TraceContext as RefCtx

        ref, port = tiny
        path = str(tmp_path / "ref.jsonl")
        prompt = np.array([3, 5, 7, 9], np.int32)
        a = RefSrv(ref, journal=path, **_kw({"max_new_tokens": 12}))
        a.start()
        cb, reached = _kill_at(a, 3)
        ctx = RefCtx.mint()
        fut = a.submit(prompt, max_new_tokens=12, on_token=cb,
                       meta=RefMeta(lane="batch", tenant="acme",
                                    deadline_s=5.0, cost=16),
                       trace_ctx=ctx)
        assert reached.wait(timeout=300)
        a.kill()
        assert not fut.done()
        b = _server(port, journal=path, max_new_tokens=12,
                    attribution=True).start()
        try:
            (out,) = [f.result(timeout=300)
                      for f in b.recover_from_journal().values()]
            st = b.stats()
        finally:
            b.stop()
        want = ref.generate(prompt[None], 12).numpy()[0]
        np.testing.assert_array_equal(out, want)
        assert set(st["attribution"]["tenants"]) == {"acme"}
        assert st["frontdoor"]["deadline_requests"] == {"batch": 1}
        evs = [e for e in tracing.events()
               if e.get("trace_id") == ctx.trace_id]
        assert evs, "the recovered request lost its trace"
        assert {(e["hop"], e["cause"]) for e in evs} == {(1, "retry")}


# ---- the fleet ------------------------------------------------------------

def _fleet_work(sp):
    return [(np.array([3, 5, 7, 9], np.int32), {}),
            (np.array([1, 2, 3], np.int32),
             {"sampling": sp(temperature=0.8, top_p=0.9, seed=77)}),
            (np.array([8, 8, 1, 4, 2], np.int32), {}),
            (np.array([6, 6, 6], np.int32), {})]


def _replica(port, name, **kw):
    from paddle_tpu_torch.fleet import Replica

    return Replica(name, _server(port, enable_prefix_cache=True, **kw))


def _ref_fleet_run(ref, work, **kw):
    """The reference fleet's uninterrupted run (one replica)."""
    from paddle_tpu.fleet import FleetRouter, Replica
    from paddle_tpu.inference import PagedGenerationServer

    router = FleetRouter([Replica("ref", PagedGenerationServer(
        ref, enable_prefix_cache=True, **_kw(kw)))]).start()
    try:
        futs = [router.submit(ids, **k) for ids, k in work]
        return [f.result(timeout=300) for f in futs]
    finally:
        router.stop()


class TestFleetCausalTree:
    """One tree spanning both replicas, phases tiling the wall clock, hops
    in order."""

    def test_failover_assembles_one_tree_across_replicas(self, tiny):
        from paddle_tpu.sampling import SamplingParams as JSP

        from paddle_tpu_torch.fleet import FleetRouter
        from paddle_tpu_torch.sampling import SamplingParams

        want = _ref_fleet_run(tiny[0], _fleet_work(JSP))
        tracing.reset()
        work = _fleet_work(SamplingParams)
        plan = FaultPlan([("replica_kill", 2)], name="chaos-kill")
        reps = [_replica(tiny[1], f"r{i}") for i in range(2)]
        router = FleetRouter(reps, fault_plan=plan, probe_interval_s=0.2)
        router.start()
        try:
            futs = [router.submit(ids, **kw) for ids, kw in work]
            outs = [f.result(timeout=300) for f in futs]
            st = router.stats()
        finally:
            router.stop()
        assert st["replica_kills"] == 1
        assert st["failover_sessions"] >= 1
        for a, b in zip(outs, want):
            np.testing.assert_array_equal(a, b)
        recs = assemble_causal_traces()
        assert len(recs) == len(work)
        failed_over = [r for r in recs.values() if r["n_hops"] > 1]
        assert failed_over, "no multi-hop trace despite a failover"
        for rec in failed_over:
            assert rec["tree"]["name"] == "request"
            assert rec["complete"]
            assert [h["hop"] for h in rec["hops"]] == \
                list(range(rec["n_hops"]))
            assert rec["causes"][0] == "admit"
            assert set(rec["causes"][1:]) == {"failover"}
            assert len(set(rec["replicas"])) > 1
            for prev, nxt in zip(rec["hops"], rec["hops"][1:]):
                assert nxt["from_replica"] == prev["replica"]
            assert check_tiling(rec) < TILE_TOL_MS
            for hop in rec["hops"]:
                assert sum(c["dur"] for c in hop["children"]) == \
                    pytest.approx(hop["dur"], abs=TILE_TOL_MS * 1e-3)
        for rec in recs.values():
            assert check_tiling(rec) < TILE_TOL_MS

    def test_migration_hops_link_source_to_target(self, tiny):
        from paddle_tpu_torch.fleet import FleetRouter

        prompt = np.array([3, 5, 7, 9, 11, 2], np.int32)
        (want,) = _ref_fleet_run(tiny[0], [(prompt, {"max_new_tokens": 20})],
                                 max_new_tokens=24)
        tracing.reset()
        reps = [_replica(tiny[1], f"r{i}", max_new_tokens=24)
                for i in range(2)]
        router = FleetRouter(reps)
        router.start()
        try:
            first = threading.Event()
            fut = router.submit(prompt, max_new_tokens=20,
                                on_token=lambda t, r: first.set())
            assert first.wait(timeout=120)
            rid = next(iter(router._sessions))
            source = router._sessions[rid].replica
            target_name = router.migrate_session(rid)
            out = fut.result(timeout=300)
        finally:
            router.stop()
        np.testing.assert_array_equal(out, want)
        recs = assemble_causal_traces()
        (rec,) = [r for r in recs.values() if r["request_id"] == rid]
        assert rec["n_hops"] == 2
        assert rec["causes"] == ["admit", "migration"]
        mig = rec["hops"][1]
        assert mig["from_replica"] == source.name == \
            rec["hops"][0]["replica"]
        assert mig["replica"] == target_name != source.name
        assert rec["hops"][0].get("migrated_out")
        assert rec["complete"]
        assert check_tiling(rec) < TILE_TOL_MS
