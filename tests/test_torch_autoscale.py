"""The port's elastic fleet autoscaler (paddle_tpu_torch/fleet/autoscale)
on the CPU: twins of tests/test_autoscale.py. The decision function runs
in both packages on the same synthetic snapshots and clock and must give
byte-identical decision journals (each package's `replay` of the other's
recorded feed too); the live cases drive the port's fleet on port
engines (the reference's `paddle.seed(211)` GPT-2 tiny carried across by
`from_reference_params`) and hold every session md5-equal to the
reference fleet's never-scaled run: dynamic membership with the warm
gate, the elastic lifecycle, SIGKILL mid-drain, the autoscaler thread
killed mid-tick, and rebalance actuation."""
import hashlib
import json
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.fleet import (Autoscaler,  # noqa: E402
                                    AutoscalePolicy, FleetRouter, Replica,
                                    ScaleDecision)
from paddle_tpu_torch.fleet.router import AUTOSCALE_ZERO  # noqa: E402
from paddle_tpu_torch.observability.capacity import (  # noqa: E402
    fleet_aggregate)
from paddle_tpu_torch.sampling import SamplingParams  # noqa: E402


@pytest.fixture(autouse=True)
def _registry_guard():
    from paddle_tpu.observability import metrics as J
    from paddle_tpu_torch.observability import metrics as M

    was = (M.REGISTRY.enabled, J.REGISTRY.enabled)
    yield
    M.REGISTRY.enabled, J.REGISTRY.enabled = was
    M.REGISTRY.reset()
    J.REGISTRY.reset()


@pytest.fixture(scope="module")
def tiny():
    """(reference GPT2, the port's GPT2 with the same float32 weights):
    tests/test_autoscale.py's model."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(211)
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
    kw.setdefault("max_new_tokens", 16)
    kw.setdefault("prefill_chunk_tokens", 8)
    kw.setdefault("enable_prefix_cache", True)
    return kw


def _engine(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, device="cpu", **_kw(kw))


def _md5(arr):
    return hashlib.md5(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _work(sp):
    return [
        (np.array([3, 5, 7, 9], np.int32), {}),
        (np.array([1, 2, 3], np.int32),
         {"sampling": sp(temperature=0.8, top_p=0.9, seed=77)}),
        (np.array([8, 8, 1, 4, 2], np.int32), {}),
        (np.array([6, 6, 6], np.int32),
         {"sampling": sp(temperature=1.1, top_k=40, seed=123)}),
        (np.array([2, 7, 1, 8], np.int32), {}),
        (np.array([9, 1, 9], np.int32),
         {"sampling": sp(temperature=0.7, seed=31)}),
    ]


WORK = _work(SamplingParams)


@pytest.fixture(scope="module")
def baseline(tiny):
    """The never-scaled run on the REFERENCE fleet: one replica, the same
    fleet seed and submit order — the parity bar every elastic run of
    the port must meet."""
    from paddle_tpu.fleet import FleetRouter as JRouter
    from paddle_tpu.fleet import Replica as JReplica
    from paddle_tpu.inference import PagedGenerationServer as JServer
    from paddle_tpu.sampling import SamplingParams as JSP

    router = JRouter([JReplica("r0", JServer(tiny[0], **_kw({})))], seed=5,
                     probe_interval_s=30.0).start()
    try:
        futs = [router.submit(ids, **kw) for ids, kw in _work(JSP)]
        return [_md5(f.result(timeout=300)) for f in futs]
    finally:
        router.stop()


def _snap(n=1, headroom=0.5, burn=None, q=0, slots=4, loads=None,
          etas=None):
    """Synthetic federated capacity snapshot for decide-level tests."""
    replicas = {}
    for i in range(n):
        free = int(100 * headroom)
        replicas[f"r{i}"] = {
            "schema_version": 1,
            "pool": {"num_blocks": 100, "free_blocks": free,
                     "used_blocks": 100 - free},
            "queues": {"queue_depth": q if i == 0 else 0,
                       "busy_slots": (loads[i] if loads else 0),
                       "max_slots": slots},
            "admission": {"sheds": 0, "draining": False},
            "slo": ({"enabled": True,
                     "slos": [{"burn_fast": burn, "burn_slow": burn}]}
                    if burn is not None else {"enabled": False}),
            "forecast": {"exhaustion_eta_s":
                         (etas[i] if etas else None)},
        }
    return {"schema_version": 2, "replicas": replicas,
            "aggregate": fleet_aggregate(replicas)}


class TestPolicyValidation:
    def test_defaults_valid(self):
        AutoscalePolicy()

    @pytest.mark.parametrize("kw", [
        {"min_replicas": 0},
        {"max_replicas": 1, "min_replicas": 2},
        {"up_headroom_frac": 1.5},
        {"up_headroom_frac": 0.6, "down_headroom_frac": 0.4},
        {"up_after": 0},
        {"down_after": 0},
        {"up_cooldown_s": -1.0},
        {"rebalance_eta_s": 0.0},
        {"max_concurrent_migrations": 0},
    ])
    def test_eager_rejects(self, kw):
        with pytest.raises(ValueError):
            AutoscalePolicy(**kw)

    def test_autoscaler_eager_rejects(self):
        with pytest.raises(TypeError):
            Autoscaler(None, policy={"min_replicas": 1})
        with pytest.raises(ValueError):
            Autoscaler(None, AutoscalePolicy(), interval_s=0.0)


class TestDecideLoop:
    """Pure decision-function semantics on synthetic snapshots —
    no engines anywhere."""

    def test_scale_up_hysteresis_and_cooldown(self):
        p = AutoscalePolicy(min_replicas=1, max_replicas=3,
                            up_queue_per_slot=1.0, up_after=2,
                            up_cooldown_s=10.0)
        a = Autoscaler(None, p)
        # one pressure tick: held (hysteresis)
        d = a.tick(now=0.0, snapshot=_snap(q=8))[0]
        assert d.action == "hold" and "pressure" in d.reason
        # second consecutive pressure tick: scale up, name auto1
        d = a.tick(now=1.0, snapshot=_snap(q=8))[0]
        assert d.action == "scale_up" and d.replica == "auto1"
        assert "queue/slot" in d.reason
        # pressure persists at n=2 but the cooldown gates the next up
        for t in (2.0, 3.0):
            d = a.tick(now=t, snapshot=_snap(n=2, q=8))[0]
            assert d.action == "hold", d
        d = a.tick(now=11.5, snapshot=_snap(n=2, q=8))[0]
        assert d.action == "scale_up" and d.replica == "auto2"
        # at max_replicas, pressure can no longer scale up
        for t in (12.0, 13.0, 25.0):
            d = a.tick(now=t, snapshot=_snap(n=3, q=8))[0]
            assert d.action == "hold"

    def test_scale_down_picks_least_loaded(self):
        p = AutoscalePolicy(min_replicas=1, max_replicas=3,
                            up_headroom_frac=0.0,
                            down_headroom_frac=0.4, down_after=2,
                            down_cooldown_s=0.0)
        a = Autoscaler(None, p)
        calm = _snap(n=3, headroom=0.8, loads=[2, 0, 1])
        assert a.tick(now=0.0, snapshot=calm)[0].action == "hold"
        d = a.tick(now=1.0, snapshot=calm)[0]
        assert d.action == "scale_down"
        assert d.replica == "r1"  # load 0 beats loads 2 and 1
        # at min_replicas, calm never removes the last replica
        a2 = Autoscaler(None, p)
        one = _snap(n=1, headroom=0.9)
        for t in (0.0, 1.0, 2.0, 3.0):
            assert a2.tick(now=t, snapshot=one)[0].action == "hold"

    def test_burn_triggers_pressure(self):
        p = AutoscalePolicy(up_burn=2.0, up_after=1)
        a = Autoscaler(None, p)
        d = a.tick(now=0.0, snapshot=_snap(burn=3.5))[0]
        assert d.action == "scale_up" and "burn" in d.reason

    def test_rebalance_on_exhaustion_forecast(self):
        p = AutoscalePolicy(up_headroom_frac=0.0,
                            rebalance_eta_s=30.0,
                            rebalance_headroom_frac=0.3)
        a = Autoscaler(None, p)
        snap = _snap(n=3, headroom=0.6, etas=[12.0, None, None])
        d = a.tick(now=0.0, snapshot=snap)[0]
        assert d.action == "rebalance"
        assert d.replica == "r0" and d.target in ("r1", "r2")
        assert "exhaustion eta" in d.reason
        # no target with enough headroom -> no rebalance
        a2 = Autoscaler(None, p)
        tight = _snap(n=2, headroom=0.1, etas=[12.0, None])
        assert a2.tick(now=0.0, snapshot=tight)[0].action == "hold"

    def test_old_shape_snapshot_tolerated(self):
        """A schema-v1 federated snapshot (no aggregate block) is
        re-aggregated on the fly — old sources keep working."""
        p = AutoscalePolicy(up_queue_per_slot=1.0, up_after=1)
        snap = _snap(q=8)
        del snap["aggregate"]
        snap["schema_version"] = 1
        a = Autoscaler(None, p)
        assert a.tick(now=0.0, snapshot=snap)[0].action == "scale_up"

    def test_replay_is_byte_identical(self):
        """The acceptance bar: a replayed decision journal reproduces
        the decision stream BYTE-FOR-BYTE from recorded (now,
        snapshot) inputs — zero live engines."""
        p = AutoscalePolicy(min_replicas=1, max_replicas=3,
                            up_queue_per_slot=1.0, up_after=2,
                            up_cooldown_s=5.0,
                            up_headroom_frac=0.05,
                            down_headroom_frac=0.4, down_after=3,
                            down_cooldown_s=0.0,
                            rebalance_eta_s=20.0)
        a = Autoscaler(None, p)
        trace = [
            _snap(q=0), _snap(q=8), _snap(q=9), _snap(n=2, q=2),
            _snap(n=2, headroom=0.7, etas=[5.0, None]),
            _snap(n=2, headroom=0.8), _snap(n=2, headroom=0.8),
            _snap(n=2, headroom=0.8), _snap(n=1, headroom=0.8),
        ]
        for i, s in enumerate(trace):
            a.tick(now=float(i), snapshot=s)
        actions = [json.loads(line)["action"] for line in a.decisions]
        assert "scale_up" in actions and "scale_down" in actions \
            and "rebalance" in actions, actions
        # the recorded feed survives a JSON wire round-trip and
        # replays to the exact same bytes
        recorded = json.loads(json.dumps(a.recorded))
        replayed = Autoscaler.replay(p, recorded)
        assert replayed == a.decisions
        # and ScaleDecision lines themselves are canonical JSON
        d = ScaleDecision(tick=1, now=0.0, action="hold",
                          replica=None, target=None, reason="x")
        assert json.loads(d.to_line()) == d.to_dict()

    def test_decision_journal_equals_the_reference(self):
        """Both packages' autoscalers on the same policy, clock and
        snapshots write the same journal bytes, and each replays the
        other's recorded feed to them."""
        from paddle_tpu.fleet import Autoscaler as JAutoscaler
        from paddle_tpu.fleet import AutoscalePolicy as JPolicy

        kw = dict(min_replicas=1, max_replicas=3, up_queue_per_slot=1.0,
                  up_after=2, up_cooldown_s=5.0, up_headroom_frac=0.05,
                  down_headroom_frac=0.4, down_after=3,
                  down_cooldown_s=0.0, rebalance_eta_s=20.0, up_burn=2.0)
        trace = [
            _snap(q=0), _snap(q=8), _snap(q=9), _snap(n=2, q=2),
            _snap(n=2, headroom=0.7, etas=[5.0, None]),
            _snap(n=2, burn=3.0), _snap(n=2, burn=3.0),
            _snap(n=3, headroom=0.8, loads=[1, 0, 2]),
            _snap(n=3, headroom=0.8, loads=[1, 0, 2]),
            _snap(n=3, headroom=0.8, loads=[1, 0, 2]),
            _snap(n=2, headroom=0.8), _snap(n=1, headroom=0.02, q=5),
        ]
        a, j = Autoscaler(None, AutoscalePolicy(**kw)), \
            JAutoscaler(None, JPolicy(**kw))
        for i, snap in enumerate(trace):
            a.tick(now=float(i) * 1.5, snapshot=json.loads(
                json.dumps(snap)))
            j.tick(now=float(i) * 1.5, snapshot=json.loads(
                json.dumps(snap)))
        assert a.decisions == j.decisions
        assert len({json.loads(x)["action"] for x in a.decisions}) >= 3
        assert a.stats_block() == j.stats_block()
        rec_a = json.loads(json.dumps(a.recorded))
        rec_j = json.loads(json.dumps(j.recorded))
        assert rec_a == rec_j
        assert Autoscaler.replay(AutoscalePolicy(**kw), rec_j) == \
            j.decisions
        assert JAutoscaler.replay(JPolicy(**kw), rec_a) == a.decisions

    def test_replica_seconds_metering(self):
        a = Autoscaler(None, AutoscalePolicy())
        a.tick(now=0.0, snapshot=_snap(n=2))
        a.tick(now=2.0, snapshot=_snap(n=2))   # 2 replicas x 2s
        a.tick(now=3.0, snapshot=_snap(n=1))   # 1 replica  x 1s
        blk = a.stats_block()
        assert blk["replica_seconds"] == pytest.approx(5.0)
        assert blk["ticks"] == 3 and blk["enabled"] is True


class TestDynamicMembership:
    def test_add_replica_warm_gate_and_remove(self, tiny):
        m = tiny[1]
        router = FleetRouter([Replica("r0", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        try:
            # a STARTED engine that never warmed cannot prove the
            # gate (warm must run before start) -> refused
            hot = _engine(m)
            hot.start()
            with pytest.raises(RuntimeError, match="warm"):
                router.add_replica(Replica("hot", hot))
            assert [r.name for r in router.replicas] == ["r0"]
            # a fresh engine is warmed by add_replica itself, then
            # admitted routable
            rep = router.add_replica(Replica("r1", _engine(m)))
            assert rep.server._warm_ran is True
            ready, detail = rep.readiness()
            assert ready and detail["warmed"] is True
            assert [r.name for r in router.replicas] == ["r0", "r1"]
            assert router.stats()["replicas_added"] == 1
            with pytest.raises(ValueError, match="duplicate"):
                router.add_replica(Replica("r1", _engine(m)))
            # traffic spans both replicas; removal refuses while
            # sessions could be resident without a drain
            futs = [router.submit(ids, **kw) for ids, kw in WORK]
            outs = [f.result(timeout=300) for f in futs]
            assert len(outs) == len(WORK)
            with pytest.raises(KeyError):
                router.remove_replica("nope")
            router.remove_replica("r1")
            assert [r.name for r in router.replicas] == ["r0"]
            with pytest.raises(ValueError, match="last replica"):
                router.remove_replica("r0")
            assert router.stats()["replicas_removed"] == 1
        finally:
            router.stop()

    def test_stats_autoscale_zeroed_and_reset_coherent(self,
                                                       tiny):
        m = tiny[1]
        router = FleetRouter([Replica("r0", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        try:
            # no autoscaler attached: the zeroed-when-disabled block
            assert router.stats()["autoscale"] == AUTOSCALE_ZERO
            a = Autoscaler(router, AutoscalePolicy())
            a.tick(now=0.0)
            a.tick(now=1.0)
            blk = router.stats()["autoscale"]
            assert blk["enabled"] is True and blk["ticks"] == 2
            assert blk["replica_seconds"] == pytest.approx(1.0)
            assert blk["last_decision"]["action"] == "hold"
            router.reset_stats()  # reset-coherent with the window
            blk = router.stats()["autoscale"]
            assert blk["ticks"] == 0 and blk["decisions"] == 0
            assert blk["replica_seconds"] == 0.0
            assert blk["last_decision"] is None
        finally:
            router.stop()


class TestElasticLifecycle:
    def test_scale_up_then_down_token_identical(self, tiny, baseline):
        """The full elastic loop against live engines: queue pressure
        scales 1->2 (warm-gated), calm drains + retires back to 1 with
        zero-recompute migration, and every session (greedy AND
        fixed-seed sampled) matches the never-scaled run md5-for-md5."""
        m = tiny[1]
        ref = baseline
        router = FleetRouter([Replica("r0", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        spawned = []

        def spawn(name):
            spawned.append(name)
            return _engine(m)  # add_replica warms it pre-start

        p = AutoscalePolicy(min_replicas=1, max_replicas=2,
                            up_headroom_frac=0.0,
                            down_headroom_frac=0.0,
                            up_queue_per_slot=0.5, up_after=1,
                            up_cooldown_s=0.0,
                            down_queue_per_slot=0.0, down_after=2,
                            down_cooldown_s=0.0)
        a = Autoscaler(router, p, spawn=spawn)
        try:
            futs = [router.submit(ids, **kw) for ids, kw in WORK]
            # the queue burst is live pressure -> scale up, actuated
            d = a.tick(now=0.0)[0]
            assert d.action == "scale_up" and spawned == ["auto1"]
            assert [r.name for r in router.replicas] == ["r0", "auto1"]
            new = router.replicas[1]
            assert new.server._warm_ran is True  # the readiness gate
            outs = [f.result(timeout=300) for f in futs]
            # calm after the burst -> drain/migrate/retire back to 1
            down = None
            for i in range(1, 30):
                d = a.tick(now=float(i))[0]
                if d.action == "scale_down":
                    down = d
                    break
            assert down is not None, a.decisions
            assert len(router.replicas) == 1
            assert router.stats()["replicas_removed"] == 1
            # parity: md5-identical to the never-scaled reference
            assert [_md5(o) for o in outs] == ref
            blk = a.stats_block()
            assert blk["scale_ups"] == 1 and blk["scale_downs"] == 1
            assert blk["errors"] == 0
            # the live run's decision journal replays byte-for-byte
            recorded = json.loads(json.dumps(a.recorded))
            assert Autoscaler.replay(p, recorded) == a.decisions
        finally:
            a.stop()
            router.stop()

    def test_chaos_sigkill_mid_drain(self, tiny, baseline):
        """The chaos gate, half 1: the scale-down victim is KILLED
        mid-drain (after set_draining, during the first migration) —
        the remaining moves degrade to journal failover and every
        session still completes md5-token-identical to the
        never-scaled run."""
        m = tiny[1]
        ref = baseline
        router = FleetRouter([Replica("r0", _engine(m)),
                              Replica("r1", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        orig_migrate = router.migrate_session
        killed = []

        def chaos_migrate(rid, target=None):
            if not killed:
                victim = next(r for r in router.replicas
                              if r.name == "r1")
                victim.kill()  # SIGKILL mid-drain
                killed.append(rid)
            return orig_migrate(rid, target=target)

        router.migrate_session = chaos_migrate
        try:
            # long-budget burst so sessions are resident on r1 when
            # the drain starts
            futs = [router.submit(ids, **kw) for ids, kw in WORK]
            res = router.retire_replica("r1")
            assert res["replica"] == "r1"
            assert [r.name for r in router.replicas] == ["r0"]
            outs = [f.result(timeout=300) for f in futs]
            assert [_md5(o) for o in outs] == ref
            assert killed, "chaos seam never fired"
        finally:
            router.migrate_session = orig_migrate
            router.stop()

    def test_chaos_autoscaler_thread_killed_mid_tick(self, tiny,
                                                     baseline):
        """The chaos gate, half 2: the autoscaler THREAD dies between
        journal append and actuation (SystemExit mid-tick). The
        decision is journaled but never actuated, the fleet is
        untouched, sessions complete token-identically, and the
        journal replays byte-for-byte."""
        m = tiny[1]
        ref = baseline
        router = FleetRouter([Replica("r0", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        p = AutoscalePolicy(up_queue_per_slot=0.5, up_after=1,
                            up_cooldown_s=0.0, max_replicas=2)
        a = Autoscaler(router, p, spawn=lambda name: _engine(m),
                       interval_s=0.05)

        def die_mid_tick(decisions):
            raise SystemExit("chaos: thread killed mid-tick")

        a._seam_after_journal = die_mid_tick
        try:
            futs = [router.submit(ids, **kw) for ids, kw in WORK]
            a.start()
            deadline = time.monotonic() + 30
            while not a.decisions and time.monotonic() < deadline:
                time.sleep(0.01)
            a._thread.join(timeout=30)
            assert not a._thread.is_alive()  # died mid-tick
            # journaled, never actuated: the fleet never grew
            assert len(a.decisions) == 1
            assert len(router.replicas) == 1
            assert router.stats()["replicas_added"] == 0
            outs = [f.result(timeout=300) for f in futs]
            assert [_md5(o) for o in outs] == ref
            recorded = json.loads(json.dumps(a.recorded))
            assert Autoscaler.replay(p, recorded) == a.decisions
        finally:
            a.stop()
            router.stop()

    def test_rebalance_actuation_moves_sessions(self, tiny, baseline):
        """A rebalance decision moves resident sessions off the
        pressure-forecast replica over the live migration wire."""
        m = tiny[1]
        router = FleetRouter([Replica("r0", _engine(m)),
                              Replica("r1", _engine(m))], seed=5,
                             probe_interval_s=30.0).start()
        a = Autoscaler(router, AutoscalePolicy(
            rebalance_eta_s=30.0, rebalance_headroom_frac=0.1,
            max_concurrent_migrations=2))
        try:
            futs = [router.submit(ids, **kw) for ids, kw in WORK]
            with router._lock:
                resident = sorted(
                    (s.replica.name if s.replica else None, s.rid)
                    for s in router._sessions.values() if not s.done)
            src = next((name for name, _ in resident
                        if name is not None), None)
            if src is not None:
                tgt = "r1" if src == "r0" else "r0"
                d = ScaleDecision(tick=1, now=0.0,
                                  action="rebalance", replica=src,
                                  target=tgt, reason="test")
                moved = a.apply(d)
                assert moved >= 0
                assert a.stats_block()["migrations"] == moved
            outs = [f.result(timeout=300) for f in futs]
            assert [_md5(o) for o in outs] == baseline
        finally:
            a.stop()
            router.stop()
