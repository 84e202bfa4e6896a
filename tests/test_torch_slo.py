"""The port's SLO burn-rate engine (paddle_tpu_torch/observability/slo.py)
and the paged server's SLO feed on the CPU: twins of tests/test_slo.py.

The engine is host Python with explicit clocks: every scenario runs on
the reference's `SLOEngine` and the port's and must give the same
evaluation, state for state and number for number. The served cases run
the port's PagedGenerationServer on GPT-2 tiny (the reference's float32
weights) with the ops endpoint; the replica-scoped cases hold the
engine's `trace_name` stamp on every SLO observation, and the port's
`FleetRouter` runs the degrade hook over them (TestRouterDegradeHook)."""
import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability import metrics as M  # noqa: E402
from paddle_tpu_torch.observability.slo import (SLO,  # noqa: E402
                                                STATES, SLOEngine,
                                                default_slos)
from paddle_tpu_torch.reliability import FaultPlan  # noqa: E402

REF = importlib.import_module("paddle_tpu.observability.slo")


@pytest.fixture(autouse=True)
def _registry_guard():
    was = M.REGISTRY.enabled
    yield
    M.REGISTRY.enabled = was
    M.REGISTRY.reset()


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


def _server(m, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_prompt_len", 24)
    kw.setdefault("max_new_tokens", 8)
    return PagedGenerationServer(m, device="cpu", **kw)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(fn):
    """fn(slo module) on the reference's module and the port's: the
    results must be equal; returns the port's."""
    import paddle_tpu_torch.observability.slo as port_mod

    want, have = fn(REF), fn(port_mod)
    assert have == want, (have, want)
    return have


def _errors(mod, calls):
    """The exception type and message of each call (None = no raise)."""
    out = []
    for c in calls:
        try:
            c(mod)
            out.append(None)
        except (TypeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


class TestSLOValidation:
    def test_field_validation_names_the_field(self):
        calls = [
            lambda m: m.SLO("latency", 0.9, threshold_s=1.0),
            lambda m: m.SLO("ttft", 1.0, threshold_s=1.0),
            lambda m: m.SLO("ttft", 0.9),
            lambda m: m.SLO("availability", 0.9, threshold_s=1.0),
            lambda m: m.SLO("availability", 0.9, window_s=0),
            lambda m: m.SLO("ttft", 0.9, threshold_s=1.0, window_s=10,
                            fast_window_s=20),
            lambda m: m.SLO("ttft", 0.9, threshold_s=1.0, warn_burn=5.0,
                            page_burn=2.0),
            lambda m: m.SLO("ttft", 0.9, threshold_s=1.0, min_events=0),
        ]
        errs = _both(lambda m: _errors(m, calls))
        for e, field in zip(errs, ("objective", "target", "threshold_s",
                                   "threshold_s", "window_s",
                                   "fast_window_s", "warn_burn",
                                   "min_events")):
            assert e is not None and e[0] == "ValueError" and field in e[1]

    def test_engine_validation(self):
        def dup(m):
            s = m.SLO("ttft", 0.9, threshold_s=1.0, name="dup")
            m.SLOEngine([s, m.SLO("itl", 0.9, threshold_s=1.0,
                                  name="dup")])

        errs = _both(lambda m: _errors(m, [
            lambda m: m.SLOEngine([]), lambda m: m.SLOEngine(["ttft"]),
            dup]))
        assert errs[0][0] == "ValueError" and ">= 1" in errs[0][1]
        assert errs[1][0] == "TypeError" and "SLO" in errs[1][1]
        assert "duplicate" in errs[2][1]
        assert len(SLOEngine(True).slos) == len(default_slos())
        assert [s.name for s in default_slos()] == \
            [s.name for s in REF.default_slos()]

    def test_scope_matching_and_default_name(self):
        def run(m):
            s = m.SLO("ttft", 0.99, threshold_s=0.5, lane="interactive")
            e = m.SLO("availability", 0.99)
            return (s.matches(lane="interactive", tenant="x",
                              replica="r0"), s.matches(lane="batch"),
                    s.name, e.matches(lane=None),
                    e.matches(lane="batch", replica="r9"))

        ok, other, name, e1, e2 = _both(run)
        assert ok and not other and e1 and e2
        assert "ttft" in name and "interactive" in name


def _slo(m, name="t", target=0.9, **kw):
    kw.setdefault("threshold_s", 0.5)
    kw.setdefault("window_s", 60.0)
    kw.setdefault("fast_window_s", 6.0)
    kw.setdefault("min_events", 5)
    return m.SLO("ttft", target, name=name, **kw)


class TestBurnStates:
    def test_ok_warn_page_progression_with_budget_accounting(self):
        def run(m):
            eng = m.SLOEngine([_slo(m)])
            out = []
            for i in range(40):
                eng.observe("ttft", value_s=0.1, now=0.0 + i * 0.25)
            out += eng.evaluate(now=10.0)
            for i in range(40):
                eng.observe("ttft", value_s=(2.0 if i % 3 == 0 else 0.1),
                            now=70.0 + i * 0.25)
            out += eng.evaluate(now=80.0)
            for i in range(40):
                eng.observe("ttft", value_s=2.0, now=150.0 + i * 0.25)
            out += eng.evaluate(now=160.0)
            out += eng.evaluate(now=300.0)
            return out

        ok, warn, page, later = _both(run)
        assert ok["state"] == "ok" and ok["burn_slow"] == 0.0
        assert ok["budget_remaining"] == 1.0
        assert warn["state"] == "warn"
        assert 2.0 <= warn["burn_fast"] <= 5.0
        assert 2.0 <= warn["burn_slow"] <= 5.0
        assert warn["budget_remaining"] < 0
        assert page["state"] == "page"
        assert page["burn_fast"] == pytest.approx(10.0)
        assert page["burn_slow"] == pytest.approx(10.0)
        assert page["budget_remaining"] == pytest.approx(-9.0)
        assert page["page_for_s"] == 0.0
        assert later["state"] == "ok" and later["events_slow"] == 0

    def test_fast_spike_alone_never_pages(self):
        def run(m):
            eng = m.SLOEngine([_slo(m)])
            for i in range(200):
                eng.observe("ttft", value_s=0.1, now=100.0 + i * 0.25)
            for i in range(10):
                eng.observe("ttft", value_s=2.0, now=151.0 + i * 0.3)
            return eng.evaluate(now=154.5)

        (rec,) = _both(run)
        assert rec["burn_fast"] >= 5.0
        assert rec["burn_slow"] < 1.0
        assert rec["state"] == "ok"

    def test_min_events_gates_cold_start(self):
        def run(m):
            eng = m.SLOEngine([_slo(m, min_events=50)])
            for i in range(10):
                eng.observe("ttft", value_s=9.0, now=100.0 + i * 0.1)
            return eng.evaluate(now=101.5)

        (rec,) = _both(run)
        assert rec["state"] == "ok" and rec["events_slow"] == 10

    def test_paging_sustain_and_worst_state(self):
        def run(m):
            eng = m.SLOEngine([_slo(m), m.SLO(
                "availability", 0.9, window_s=60.0, fast_window_s=6.0,
                min_events=5, name="a")])
            for i in range(64):
                eng.observe("ttft", value_s=2.0, now=100.0 + i * 0.25)
                eng.observe("availability", good=True,
                            now=100.0 + i * 0.25)
            return (eng.paging(now=110.0, sustain_s=5.0),
                    eng.paging(now=115.5, sustain_s=5.0),
                    eng.worst_state(now=112.0), eng.report(now=112.0))

        first, sustained, worst, rep = _both(run)
        assert first == set() and sustained == {"t"}
        assert worst == "page"
        assert rep["worst"] == "page" and rep["paging"] == ["t"]
        assert {r["name"]: r["state"] for r in rep["slos"]} == \
            {"t": "page", "a": "ok"}
        assert set(STATES) == {"ok", "warn", "page"}

    def test_observation_validation(self):
        errs = _both(lambda m: _errors(m, [
            lambda m: m.SLOEngine([_slo(m)]).observe("latency",
                                                      value_s=1.0),
            lambda m: m.SLOEngine([_slo(m)]).observe("ttft", good=True,
                                                      now=1.0)]))
        assert "objective" in errs[0][1]
        assert "value_s" in errs[1][1]

    def test_gauges_exported_on_evaluate(self):
        M.REGISTRY.enable()
        eng = SLOEngine([_slo(importlib.import_module(
            "paddle_tpu_torch.observability.slo"), name="gauged")])
        for i in range(20):
            eng.observe("ttft", value_s=2.0, now=50.0 + i * 0.25)
        eng.evaluate(now=56.0)
        snap = M.snapshot()
        burn = {tuple(sorted(s["labels"].items())): s["value"]
                for s in snap["slo_burn_rate"]["series"]}
        assert burn[(("slo", "gauged"), ("window", "fast"))] \
            == pytest.approx(10.0)
        state = {s["labels"]["slo"]: s["value"]
                 for s in snap["slo_state"]["series"]}
        assert state["gauged"] == 2.0
        budget = {s["labels"]["slo"]: s["value"]
                  for s in snap["slo_error_budget_remaining"]["series"]}
        assert budget["gauged"] == pytest.approx(-9.0)


class TestEngineIntegration:
    def test_slo_endpoint_ok_and_stats_block(self, tiny):
        _ref, port = tiny
        srv = _server(port, expose_port=0, slos=[
            SLO("ttft", 0.9, threshold_s=120.0, window_s=30.0,
                min_events=2, name="ttft_generous"),
            SLO("availability", 0.9, window_s=30.0, min_events=2,
                name="avail"),
        ]).start()
        try:
            futs = [srv.submit(np.array([3, 5, 7], np.int32))
                    for _ in range(4)]
            for f in futs:
                f.result(timeout=300)
            code, rep = _get(f"{srv.exporter.url}/slo")
            st = srv.stats()["slo"]
            code404, listing = _get(f"{srv.exporter.url}/nope")
        finally:
            srv.stop()
        assert code == 200 and rep["worst"] == "ok"
        by_name = {s["name"]: s for s in rep["slos"]}
        assert by_name["ttft_generous"]["state"] == "ok"
        assert by_name["ttft_generous"]["events_slow"] == 4
        assert by_name["avail"]["events_slow"] == 4
        assert st["enabled"] and len(st["slos"]) == 2
        assert code404 == 404 and "/slo" in listing["paths"]

    def test_induced_latency_drives_page_and_503(self, tiny):
        """Seeded slow_dispatch faults add real latency; with a 0.1 ms
        TTFT bound every request is bad, and the live /slo pages (503)
        with the error budget overspent."""
        _ref, port = tiny
        plan = FaultPlan([("slow_dispatch", i) for i in range(8)],
                         name="slow", slow_s=0.05)
        srv = _server(port, expose_port=0, fault_plan=plan, slos=[
            SLO("ttft", 0.9, threshold_s=1e-4, window_s=30.0,
                fast_window_s=3.0, min_events=2, name="tight"),
        ]).start()
        try:
            futs = [srv.submit(np.array([3, 5, 7], np.int32))
                    for _ in range(4)]
            for f in futs:
                f.result(timeout=300)
            code, rep = _get(f"{srv.exporter.url}/slo")
            st = srv.stats()
        finally:
            srv.stop()
        assert st["reliability"]["faults_injected"] >= 1
        assert code == 503
        assert rep["worst"] == "page"
        (rec,) = rep["slos"]
        assert rec["state"] == "page"
        assert rec["burn_slow"] == pytest.approx(10.0)
        assert rec["budget_remaining"] == pytest.approx(-9.0)
        assert rep["paging"] == ["tight"]

    def test_disabled_schema_and_no_endpoint(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as RefSrv

        ref, port = tiny
        srv = _server(port, expose_port=0).start()
        try:
            srv.submit(np.array([3, 5], np.int32),
                       max_new_tokens=2).result(timeout=300)
            assert srv.stats()["slo"] == {"enabled": False, "slos": []}
            assert srv.slo_report() == RefSrv(
                ref, max_slots=2, block_size=4, max_prompt_len=24,
                max_new_tokens=8).slo_report()
            code, _listing = _get(f"{srv.exporter.url}/slo")
        finally:
            srv.stop()
        assert code == 404


class TestReplicaScope:
    """The SLO half of the fleet router's degrade hook: replica-scoped
    objectives page on their replica's traffic only (the router that
    reads `paging` to mark a replica not-ready: TestRouterDegradeHook)."""

    def test_replica_scoped_paging_names_only_the_culprit(self):
        def run(m):
            eng = m.SLOEngine([
                m.SLO("ttft", 0.9, threshold_s=0.5, window_s=60.0,
                      fast_window_s=6.0, min_events=5, replica="r0",
                      name="r0_ttft"),
                m.SLO("ttft", 0.9, threshold_s=0.5, window_s=60.0,
                      fast_window_s=6.0, min_events=5, replica="r1",
                      name="r1_ttft"),
                m.SLO("ttft", 0.9, threshold_s=0.5, window_s=60.0,
                      fast_window_s=6.0, min_events=5,
                      name="fleet_ttft")])
            for i in range(40):
                eng.observe("ttft", value_s=9.0, now=100.0 + i * 0.1,
                            replica="r0")
            return (eng.paging(now=104.0, sustain_s=2.0),
                    eng.paging(now=106.5, sustain_s=2.0),
                    {r["name"]: r["state"]
                     for r in eng.report(now=106.5)["slos"]},
                    eng.paging(now=400.0, sustain_s=2.0))

        first, sustained, states, later = _both(run)
        assert first == set()
        assert sustained == {"r0_ttft", "fleet_ttft"}
        assert states == {"r0_ttft": "page", "r1_ttft": "ok",
                          "fleet_ttft": "page"}
        assert later == set()

    def test_engine_feeds_carry_its_replica_name(self, tiny):
        """A server named like a fleet replica feeds TTFT and
        availability under that name: its replica's SLOs see every
        request, another replica's see none."""
        _ref, port = tiny
        srv = _server(port, slos=[
            SLO("ttft", 0.9, threshold_s=120.0, min_events=2,
                replica="r0", name="wide"),
            SLO("availability", 0.9, min_events=2, replica="r0",
                name="av"),
            SLO("availability", 0.9, min_events=2, replica="r1",
                name="other")])
        srv.trace_name = "r0"
        srv.start()
        try:
            futs = [srv.submit(np.array([3, 5, 7], np.int32))
                    for _ in range(3)]
            for f in futs:
                f.result(timeout=300)
            rep = srv.slo_report()
        finally:
            srv.stop()
        by = {r["name"]: r for r in rep["slos"]}
        assert by["wide"]["events_slow"] == 3
        assert by["av"]["events_slow"] == 3
        assert by["other"]["events_slow"] == 0
        assert rep["worst"] == "ok"


class TestRouterDegradeHook:
    def test_sustained_replica_page_marks_not_ready(self, tiny):
        import time

        from paddle_tpu_torch.fleet import FleetRouter, Replica

        _ref, port = tiny
        reps = [Replica(f"r{i}", _server(port, enable_prefix_cache=True))
                for i in range(2)]
        router = FleetRouter(
            reps, probe_interval_s=30.0,
            slos=[SLO("ttft", 0.9, threshold_s=0.5, window_s=60.0,
                      fast_window_s=6.0, min_events=5,
                      replica="r0", name="r0_ttft"),
                  SLO("ttft", 0.9, threshold_s=0.5, window_s=60.0,
                      fast_window_s=6.0, min_events=5,
                      name="fleet_ttft")],
            slo_degrade_sustain_s=2.0)
        router.start()
        try:
            now = time.monotonic()
            for i in range(40):  # r0 burns its budget; r1 unobserved
                router._slo.observe("ttft", value_s=9.0,
                                    now=now + i * 0.1, replica="r0")
            router.check_replicas(now=now + 4.0)   # page_since set
            assert reps[0].health.state != "not_ready"
            router.check_replicas(now=now + 6.5)   # sustained: fires
            assert reps[0].health.state == "not_ready"
            assert reps[1].health.state == "ok"
            assert router.stats()["slo"] == {"enabled": True,
                                             "degraded_replicas": ["r0"]}
            rep = router.slo_report()
            assert rep["degraded_replicas"] == ["r0"]
            # the fleet-wide SLO pages too but degrades nobody
            assert {r["name"] for r in rep["slos"]
                    if r["state"] == "page"} == {"r0_ttft", "fleet_ttft"}
            out = router.submit(np.array([4, 2], np.int32),
                                max_new_tokens=2).result(timeout=300)
            assert out.size == 4
            assert router._sessions and all(
                s.replica is reps[1] for s in router._sessions.values())
            # the burn clears (windows age out): the next pass releases it
            router.check_replicas(now=now + 300.0)
            router.check_replicas(now=now + 330.0)
            assert reps[0].health.state == "ok"
            assert router.stats()["slo"]["degraded_replicas"] == []
        finally:
            router.stop()

    def test_router_feeds_ttft_and_availability(self, tiny):
        from paddle_tpu_torch.fleet import FleetRouter, Replica

        _ref, port = tiny
        router = FleetRouter(
            [Replica("r0", _server(port, enable_prefix_cache=True))],
            probe_interval_s=30.0,
            slos=[SLO("ttft", 0.9, threshold_s=120.0, min_events=2,
                      name="wide"),
                  SLO("availability", 0.9, min_events=2, name="av")])
        router.start()
        try:
            futs = [router.submit(np.array([3, 5, 7], np.int32))
                    for _ in range(3)]
            for f in futs:
                f.result(timeout=300)
            rep = router.slo_report()
        finally:
            router.stop()
        by = {r["name"]: r for r in rep["slos"]}
        assert by["wide"]["events_slow"] == 3
        assert by["av"]["events_slow"] == 3
        assert rep["worst"] == "ok"
