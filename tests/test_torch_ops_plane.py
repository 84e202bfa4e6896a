"""The port's serving operations plane on the CPU: twins of
tests/test_ops_plane.py.

  * The flight recorder's ring and the stall watchdog (driven by a fake
    progress counter; every wait is on a condition, none a fixed sleep).
  * The ops endpoint on 127.0.0.1, port 0: /healthz through an induced
    stall and back, /metrics, /statusz, the split /healthz/live and
    /healthz/ready, and the PADDLE_TPU_METRICS_PORT switch.
  * A dispatch exception auto-dumps the recorder; the structured
    pool-exhaustion info in health and statusz.
  * The capture tracker's window API (`mark`, `count_since`,
    `events_since`, `stats`) through `wrap` over fake programs — on the
    card the captures come from the decode graph caches
    (tests/test_torch_cuda.py).
  * Goodput conservation: decoded = emitted + rolled back + replayed
    (multi-step overrun, speculation rollback, an exact budget).

  * The front door surfaces the ops plane on its facade.

Left for later slices: the sharded cases (ROADMAP §A 11)."""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability import compile_tracker as CT  # noqa: E402
from paddle_tpu_torch.observability.flight_recorder import (  # noqa: E402
    FlightRecorder, StallWatchdog)


@pytest.fixture(autouse=True)
def _registry_guard():
    """expose_port= enables the process metrics registry by design:
    restore the gate and zero the series afterwards."""
    from paddle_tpu_torch.observability import metrics as M

    was = M.REGISTRY.enabled
    yield
    M.REGISTRY.enabled = was
    M.REGISTRY.reset()


def _get(url, timeout=10):
    """(status_code, body); urllib raises on 503, which /healthz uses
    for 'stalled' on purpose."""
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_for(pred, timeout=30.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return False


@pytest.fixture(scope="module")
def tiny():
    from torch_twin_util import reference_tiny_model

    _model, _cfg, port, tcfg = reference_tiny_model(31)
    return port, tcfg


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens", 4)
    return PagedGenerationServer(port, device="cpu", **kw)


class TestFlightRecorderRing:
    def test_bounded_and_ordered(self):
        fr = FlightRecorder(capacity=16, enabled=True)
        for i in range(48):
            fr.record("ev", i=i)
        evs = fr.events()
        assert len(evs) == 16
        assert [e["seq"] for e in evs] == list(range(32, 48))
        assert [e["i"] for e in evs] == list(range(32, 48))
        d = fr.dump()
        assert d["trigger"] == "manual" and d["n_events"] == 16
        assert fr.last_dump is d
        assert fr.stats()["dumps"] == 1
        fr.clear()
        assert fr.events() == []

    def test_disabled_is_noop(self):
        fr = FlightRecorder(capacity=4)  # enabled defaults False
        fr.record("ev")
        assert fr.events() == []
        fr.enable()
        fr.record("ev")
        assert len(fr.events()) == 1

    def test_dump_sink_failure_does_not_cascade(self):
        fr = FlightRecorder(capacity=4, enabled=True)
        fr.record("ev")
        got = []
        d = fr.dump(trigger="stall", sink=got.append)
        assert got == [d]
        fr.dump(sink=lambda _d: 1 / 0)  # logged, not raised
        assert fr.stats()["last_dump_trigger"] == "manual"

    def test_watchdog_requires_pending_work(self):
        """No pending work = never stalled, however long progress sits
        still; pending + frozen progress = stalled; progress clears it.
        The watchdog is driven by a fake counter: each wait is on the
        watchdog's own polls, not on a fixed sleep. Once progress
        resumes it moves on every poll, as a serving engine's does, so a
        slow test thread cannot see a second stall."""
        state = {"progress": 0, "pending": False, "polls": 0,
                 "stalls": 0, "recovers": 0, "moving": False}

        def pending():
            state["polls"] += 1
            return state["pending"]

        def progress():
            if state["moving"]:
                state["progress"] += 1
            return state["progress"]

        wd = StallWatchdog(progress, pending,
                           timeout=0.15, poll=0.03,
                           on_stall=lambda: state.__setitem__(
                               "stalls", state["stalls"] + 1),
                           on_recover=lambda: state.__setitem__(
                               "recovers", state["recovers"] + 1)).start()
        try:
            # idle for many polls spanning well past the timeout
            t0 = time.monotonic()
            assert _wait_for(lambda: state["polls"] >= 12
                             and time.monotonic() - t0 > 0.45)
            assert not wd.stalled
            state["pending"] = True
            # the flag flips before the callback runs: wait for both
            assert _wait_for(lambda: wd.stalled and state["stalls"] == 1)
            assert wd.stalls == 1
            state["moving"] = True
            assert _wait_for(lambda: not wd.stalled
                             and state["recovers"] == 1)
            assert state["stalls"] == 1 and wd.stalls == 1
        finally:
            wd.stop()

    def test_watchdog_validation(self):
        with pytest.raises(ValueError, match="timeout"):
            StallWatchdog(lambda: 0, lambda: False, timeout=0)
        with pytest.raises(ValueError, match="capacity"):
            FlightRecorder(capacity=0)


class TestOpsEndpoint:
    def test_roundtrip_and_stall_transitions(self, tiny):
        """Work submitted to a server whose loop never started is a
        stall: /healthz goes ok -> stalled (503) with a recorder dump
        that names the stalling request; starting the engine drains it
        and health returns to ok; /metrics and /statusz answer."""
        port, _tcfg = tiny
        srv = _server(port, expose_port=0, stall_timeout_s=0.3)
        try:
            url = srv.exporter.url
            assert srv.exporter.port > 0
            code, body = _get(url + "/healthz")
            assert code == 200 and json.loads(body)["status"] == "ok"
            fut = srv.submit([3, 5, 7])
            # health reads the watchdog's flag, which flips before its
            # callback dumps the recorder: wait for both
            assert _wait_for(lambda: _get(url + "/healthz")[0] == 503
                             and srv._recorder.last_dump is not None)
            code, body = _get(url + "/healthz")
            h = json.loads(body)
            assert code == 503 and h["status"] == "stalled"
            assert h["stalls"] >= 1
            dump = srv._recorder.last_dump
            assert dump is not None and dump["trigger"] == "stall"
            sub = [e for e in dump["events"] if e["name"] == "submit"]
            assert len(sub) == 1
            assert sub[0]["request_id"].startswith("p")
            assert sub[0]["prompt_len"] == 3 and sub[0]["budget"] == 4
            assert any(e["name"] == "stall" for e in dump["events"])

            srv.start()
            out = fut.result(timeout=300)
            assert list(out[:3]) == [3, 5, 7]
            assert _wait_for(lambda: json.loads(
                _get(url + "/healthz")[1])["status"] == "ok")

            code, prom = _get(url + "/metrics")
            assert code == 200
            for name in ("serving_xla_compiles_total", "serving_stalls_total",
                         "serving_requests_total",
                         "serving_recoveries_total",
                         "serving_tokens_decoded_total",
                         "serving_health_state", "kv_pool_used_blocks"):
                assert f"# TYPE {name} " in prom, name
            code, body = _get(url + "/statusz")
            sz = json.loads(body)
            assert code == 200 and sz["server"] == "paged"
            assert sz["health"]["status"] == "ok"
            assert sz["last_dump"]["trigger"] == "stall"
            eng = sz["engine"]
            for key in ("goodput", "compiles", "ops", "speculation",
                        "quantization", "reliability", "rounds",
                        "kv_cache", "stop_reasons"):
                assert key in eng, key
            assert eng["ops"]["exporter_port"] == srv.exporter.port
            assert eng["goodput"]["goodput_ratio"] == 1.0
            # no SLO engine: no /slo; the capacity snapshot is always
            # wired
            for path in ("/nope", "/slo"):
                code, body = _get(url + path)
                assert code == 404 and "/statusz" in body
            code, body = _get(url + "/capacity")
            assert code == 200
            assert json.loads(body)["schema_version"] == 1
        finally:
            srv.stop()
        with pytest.raises(Exception):
            urllib.request.urlopen(url + "/healthz", timeout=2)

    def test_env_port_starts_ops_plane(self, tiny, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "0")
        port, _tcfg = tiny
        srv = _server(port)
        try:
            assert srv.exporter is not None
            assert srv._recorder.enabled
            assert _get(srv.exporter.url + "/metrics")[0] == 200
        finally:
            srv.stop()

    def test_flight_recorder_records_the_request_lifecycle(self, tiny):
        port, _tcfg = tiny
        srv = _server(port, flight_recorder=True).start()
        try:
            srv.submit([2, 4, 6]).result(timeout=300)
            d = srv.dump_flight_recorder()
        finally:
            srv.stop()
        assert d["trigger"] == "manual"
        names = {e["name"] for e in d["events"]}
        assert {"submit", "admit", "prefill_chunk", "decode_dispatch",
                "request_done"} <= names
        assert srv.exporter is None  # the recorder alone, no endpoint


class TestFrontDoorOps:
    def test_frontdoor_surfaces_ops(self, tiny):
        """FrontDoor forwards expose_port to the engine and surfaces the
        ops plane on the facade; /statusz carries the lane and tenant
        blocks of the installed scheduler, /slo and /capacity answer."""
        from paddle_tpu_torch.frontend import FrontDoor

        port, _tcfg = tiny
        fd = FrontDoor(port, max_slots=2, block_size=4, max_prompt_len=16,
                       max_new_tokens=4, expose_port=0, slos=True,
                       device="cpu")
        fd.start()
        try:
            assert fd.ops_url
            h = fd.submit([2, 4, 6], lane="interactive")
            assert h.result(timeout=300) is not None
            sz = fd.statusz()
            assert sz["engine"]["frontdoor"]["enabled"] is True
            assert isinstance(sz["engine"]["lane_queue_depth"], dict)
            assert fd.health()[0] in ("ok", "degraded")
            d = fd.dump_flight_recorder()
            assert d["trigger"] == "manual"
            names = {e["name"] for e in d["events"]}
            assert {"submit", "admit", "prefill_chunk",
                    "request_done"} <= names
            for path in ("/slo", "/capacity"):
                code, body = _get(fd.ops_url + path)
                assert code == 200, (path, body)
                assert json.loads(body)
            assert json.loads(_get(fd.ops_url + "/capacity")[1])[
                "schema_version"] == 1
        finally:
            fd.stop()


class TestEngineExceptionDump:
    def test_injected_dispatch_exception_autodumps(self, tiny):
        """A prefill that always raises: the ladder retries, then
        quarantines the request (its error names the failure); the
        recorder dumps with trigger 'engine_exception' and health is
        degraded until reset_stats."""
        port, _tcfg = tiny
        srv = _server(port, expose_port=0, stall_timeout_s=30.0)

        def broken(*a, **kw):
            raise RuntimeError("injected prefill failure")

        srv._decoder.packed_prefill = broken
        srv.start()
        try:
            fut = srv.submit([1, 2, 3])
            with pytest.raises(RuntimeError, match="injected"):
                fut.result(timeout=300)
            assert _wait_for(
                lambda: srv._recorder.last_dump is not None
                and srv._recorder.last_dump["trigger"]
                == "engine_exception")
            exc = [e for e in srv._recorder.last_dump["events"]
                   if e["name"] == "engine_exception"]
            assert exc and "injected" in exc[0]["error"]
            assert exc[0]["where"] == "prefill"
            status, detail = srv.health()
            assert status == "degraded"
            assert "injected" in detail["last_error"]
            srv.reset_stats()
            assert srv.health()[0] == "ok"
        finally:
            srv.stop()


class _FakeProgram:
    """Stands in for a capturing callable with the reference's protocol
    (`_cache_size()`): the first call with a new input 'captures', later
    ones replay."""

    def __init__(self):
        self._seen = set()

    def _cache_size(self):
        return len(self._seen)

    def __call__(self, x):
        self._seen.add(x)
        return x * 2


class TestCaptureTracker:
    @pytest.mark.parametrize("protocol", ["_cache_size", "captures"])
    def test_window_api_through_wrap(self, protocol):
        tracker = CT.CompileTracker()
        live = {"busy": False}

        class Engine:  # probes and listeners are held weakly
            def __init__(self):
                self.seen = []

            def probe(self):
                return live["busy"]

            def on_capture(self, ev):
                self.seen.append(ev)

        eng = Engine()
        tracker.register_in_flight_probe(eng.probe)
        tracker.add_listener(eng.on_capture)
        seen = eng.seen
        prog = (_FakeProgram() if protocol == "_cache_size"
                else _FakeProgramCaptures())
        w = tracker.wrap("multistep", prog)
        assert w is not prog and w.__wrapped__ is prog
        m0 = tracker.mark()
        assert w(1) == 2 and w(1) == 2  # one capture, one replay
        live["busy"] = True
        assert w(2) == 4 and w(2) == 4 and w(1) == 2
        assert tracker.count_since(m0) == 2
        assert tracker.count_since(m0, in_flight=False) == 1
        assert tracker.count_since(m0, in_flight=True) == 1
        evs = tracker.events_since(m0)
        assert [e["in_flight"] for e in evs] == [False, True]
        assert all(e["program"] == "multistep" and e["shard"] == "none"
                   and e["dur_s"] >= 0 for e in evs)
        assert seen == evs
        m1 = tracker.mark()
        w(1)
        w(2)
        assert tracker.count_since(m1) == 0  # replays: capture-clean
        assert tracker.stats() == {"total": 2, "total_in_flight": 1}
        del eng  # a dead server's probe falls away
        assert tracker.in_flight() is False

    def test_non_capturing_callable_is_returned_untouched(self):
        def f(x):
            return x

        assert CT.CompileTracker().wrap("p", f) is f

    def test_record_emits_metric_and_trace_event(self):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import metrics as M
        from paddle_tpu_torch.observability import tracing as T

        obs.enable()
        T.TRACER.reset()
        try:
            mark = CT.mark()
            CT.record("unified_window", 0.5, in_flight=False)
            assert CT.count_since(mark) == 1
            series = M.snapshot()["serving_xla_compiles_total"]["series"]
            assert {"program": "unified_window", "in_flight": "false",
                    "shard": "none"} in [s["labels"] for s in series]
            ev = [e for e in T.events() if e["name"] == "compile"][-1]
            assert ev["program"] == "unified_window" and ev["dur"] == 0.5
        finally:
            obs.disable()
            T.TRACER.reset()

    def test_warm_buckets_on_the_cpu_captures_nothing(self, tiny):
        """Graphs run on the card only: on the CPU warm_buckets has
        nothing to capture, returns 0 and marks the server warmed; it
        refuses a started server."""
        port, _tcfg = tiny
        srv = _server(port, unified_round=True)
        try:
            mark = CT.mark()
            assert srv.readiness()[1]["warmed"] is False
            assert srv.warm_buckets([(False, False), (True, False)]) == 0
            assert CT.count_since(mark) == 0
            assert srv.readiness()[1]["warmed"] is True
            srv.start()
            with pytest.raises(RuntimeError, match="before start"):
                srv.warm_buckets()
            out = srv.submit([1, 2, 3]).result(timeout=300)
            assert out.size == 7
            assert srv.stats()["compiles"] == {"window_total": 0,
                                               "window_in_flight": 0}
        finally:
            srv.stop()


class _FakeProgramCaptures:
    """A `captures` counter and no `_cache_size` (DecodeGraphs')."""

    def __init__(self):
        self._seen = set()
        self.captures = 0

    def __call__(self, x):
        if x not in self._seen:
            self._seen.add(x)
            self.captures += 1
        return x * 2


class TestGoodput:
    def _serve(self, port, prompts, **kw):
        srv = _server(port, **kw)
        futs = [srv.submit(p) for p in prompts]
        srv.start()
        try:
            for f in futs:
                f.result(timeout=300)
            return srv.stats()
        finally:
            srv.stop()

    def test_conservation_multistep_overrun(self, tiny):
        """k = 3 with a 6-token budget: token 0 from the prefill + two
        3-token scans, one token of the second discarded a request."""
        port, tcfg = tiny
        rs = np.random.RandomState(0)
        st = self._serve(port, [rs.randint(1, tcfg.vocab_size, (n,))
                                .astype(np.int32) for n in (3, 7, 5)],
                         steps_per_dispatch=3, max_new_tokens=6)
        g = st["goodput"]
        assert g["decoded_tokens"] == (g["goodput_tokens"]
                                       + g["rolled_back_tokens"]
                                       + g["replayed_tokens"])
        assert g["goodput_tokens"] == 3 * 6
        assert g["replayed_tokens"] == 3
        assert 0 < g["goodput_ratio"] < 1.0

    @pytest.mark.parametrize("mode", ["split", "unified", "async"])
    def test_conservation_with_speculation_rollback(self, tiny, mode):
        port, _tcfg = tiny
        kw = {"speculation": True, "max_new_tokens": 6,
              "max_prompt_len": 24}
        if mode != "split":
            kw.update(unified_round=True, async_rounds=mode == "async")
        st = self._serve(port, [[7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8],
                                [5, 6, 5, 6, 5, 6, 5, 6, 5, 6]], **kw)
        g = st["goodput"]
        assert g["decoded_tokens"] == (g["goodput_tokens"]
                                       + g["rolled_back_tokens"]
                                       + g["replayed_tokens"])
        assert st["speculation"]["proposed_tokens"] > 0
        assert g["goodput_tokens"] == 2 * 6

    def test_conservation_exact_budget_is_lossless(self, tiny):
        port, _tcfg = tiny
        st = self._serve(port, [[2, 3, 4]])
        g = st["goodput"]
        assert g["decoded_tokens"] == g["goodput_tokens"] == 4
        assert g["goodput_ratio"] == 1.0

    def test_conservation_across_a_recovered_fault(self, tiny):
        """A cold resume re-prefills the emitted tokens: replayed work,
        so conservation holds with the ratio below 1."""
        port, _tcfg = tiny
        st = self._serve(port, [[2, 3, 4], [5, 6, 7, 8]],
                         fault_plan="decode:1")
        g = st["goodput"]
        assert g["decoded_tokens"] == (g["goodput_tokens"]
                                       + g["rolled_back_tokens"]
                                       + g["replayed_tokens"])
        assert g["goodput_tokens"] == 8 and g["replayed_tokens"] > 0
        assert st["reliability"]["resumes"] == 2


class TestSplitHealth:
    def test_live_and_ready_endpoints_roundtrip(self, tiny):
        port, _tcfg = tiny
        srv = _server(port, expose_port=0)
        url = srv.exporter.url
        try:
            code, body = _get(url + "/healthz/live")
            assert code == 503 and json.loads(body)["live"] is False
            code, body = _get(url + "/healthz")
            assert code == 200 and json.loads(body)["status"] == "ok"
            srv.start()
            assert _wait_for(lambda: _get(url + "/healthz/live")[0] == 200)
            code, body = _get(url + "/healthz/ready")
            r = json.loads(body)
            assert code == 200 and r["ready"] is True
            assert r["draining"] is False
            srv.set_draining(True)
            code, body = _get(url + "/healthz/ready")
            r = json.loads(body)
            assert code == 503 and r["ready"] is False and r["draining"]
            assert _get(url + "/healthz/live")[0] == 200
            assert _get(url + "/healthz")[0] == 200
            srv.set_draining(False)
            assert _get(url + "/healthz/ready")[0] == 200
            code, body = _get(url + "/nope")
            assert code == 404
            assert "/healthz/live" in body and "/healthz/ready" in body
            sz = json.loads(_get(url + "/statusz")[1])
            assert sz["liveness"]["live"] is True
            assert sz["readiness"]["ready"] is True
        finally:
            srv.stop()
        live, _detail = srv.liveness()
        assert live is False

    def test_statusz_carries_structured_pool_exhaustion(self, tiny):
        from paddle_tpu_torch.inference.kv_cache import BlockPoolExhausted

        port, _tcfg = tiny
        srv = _server(port)
        try:
            e = BlockPoolExhausted("synthetic", needed=7, available=2)
            srv._engine_exception("ensure_many", e, ["p0"])
            status, detail = srv.health()
            assert status == "degraded"
            info = detail["last_error_info"]
            assert info["where"] == "ensure_many"
            assert info["error_type"] == "BlockPoolExhausted"
            assert info["needed"] == 7 and info["available"] == 2
            assert srv.statusz()["health"]["last_error_info"]["needed"] == 7
            srv.reset_stats()
            status, detail = srv.health()
            assert status == "ok" and "last_error_info" not in detail
        finally:
            srv.stop()

    def test_clean_recovery_clears_structured_info(self, tiny):
        from paddle_tpu_torch.reliability import FaultPlan

        port, _tcfg = tiny
        srv = _server(port, fault_plan=FaultPlan([("ensure_many", 0)]))
        srv.start()
        try:
            out = srv.submit([3, 4, 5]).result(timeout=300)
            assert list(out[:3]) == [3, 4, 5]
            assert _wait_for(lambda: srv.health()[0] == "ok")
            assert "last_error_info" not in srv.health()[1]
            assert srv.stats()["reliability"]["recoveries"] >= 1
        finally:
            srv.stop()

    def test_killed_server_is_not_live_and_not_in_flight(self, tiny):
        port, _tcfg = tiny
        srv = _server(port)
        fut = srv.submit([1, 2, 3])  # queued, never started
        assert srv._ops_in_flight() is True
        srv.kill()
        assert not fut.done()  # kill resolves nothing
        assert srv.liveness()[0] is False
        assert srv._ops_in_flight() is False
        with pytest.raises(RuntimeError, match="stopped"):
            srv.submit([1])
        assert srv._thread is None
