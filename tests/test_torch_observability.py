"""The port's runtime telemetry (paddle_tpu_torch/observability) on the
CPU: twins of tests/test_observability.py.

  * The metrics registry: labels, gauges, histograms, the disabled
    no-op, and the Prometheus text — the same operations on the port's
    and the reference's registries give the same text, byte for byte.
  * Tracing: span nesting and order, the disabled no-op, sink rotation,
    `wrap`, and the serving trace assembly over a real paged run of
    the port's server (phases tile the request's wall clock).
  * The pool gauges keep one series per pool; reset_stats clears TTFT;
    the training watchdog's heartbeat gauge.

Left for later slices: the hapi TelemetryCallback (ROADMAP §A 10 e) and
the profiler satellites (§A 14); `attach_device_ops` raises, naming
§A 14."""
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability import metrics as M  # noqa: E402
from paddle_tpu_torch.observability import tracing as T  # noqa: E402


@pytest.fixture
def reg():
    return M.Registry(enabled=True)


@pytest.fixture
def telemetry_on():
    """Enable the port's global stack for one test, fully restored
    after."""
    from paddle_tpu_torch import observability as obs

    obs.enable()
    T.TRACER.reset()
    M.REGISTRY.reset()  # series of earlier tests in this process read 0
    try:
        yield
    finally:
        obs.disable()
        T.TRACER.configure(path=None)
        T.TRACER.reset()
        M.REGISTRY.reset()


def _golden_ops(mod):
    """The reference test's golden-text operations on a fresh registry
    of `mod` (either package's metrics module)."""
    reg = mod.Registry(enabled=True)
    c = reg.counter("scrape_c_total", "a counter", labelnames=("k",))
    c.labels(k='quo"te').inc(3)
    c.labels(k="line\nbreak").inc()
    c.labels(k="back\\slash").inc(2)
    reg.gauge("scrape_g", "a gauge").set(2.5)
    h = reg.histogram("scrape_h_seconds", "a histogram",
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("lat", "latency").observe(0.003)
    reg.gauge("depth", "queue depth", labelnames=("server",)) \
       .labels(server="paged").set(7)
    return reg


class TestRegistry:
    def test_counter_labels_and_get_or_create(self, reg):
        c = reg.counter("reqs_total", "requests", labelnames=("server",))
        c.labels(server="a").inc()
        c.labels(server="a").inc(2)
        c.labels(server="b").inc()
        assert reg.counter("reqs_total", labelnames=("server",)) is c
        snap = reg.snapshot()["reqs_total"]
        assert snap["kind"] == "counter"
        by = {s["labels"]["server"]: s["value"] for s in snap["series"]}
        assert by == {"a": 3.0, "b": 1.0}
        with pytest.raises(ValueError):
            reg.gauge("reqs_total")  # kind mismatch
        with pytest.raises(ValueError):
            c.labels(wrong="x")
        with pytest.raises(ValueError):
            c.labels(server="a").inc(-1)  # counters only go up

    def test_gauge_and_gauge_fn(self, reg):
        g = reg.gauge("depth", "queue depth")
        g.set(4)
        g.dec()
        assert g.value == 3.0
        reg.gauge_fn("age", "pulled", lambda: 42.5)
        assert reg.snapshot()["age"]["series"][0]["value"] == 42.5

    def test_histogram_buckets_and_percentile(self, reg):
        h = reg.histogram("lat", "latency", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 2.0):
            h.observe(v)
        s = reg.snapshot()["lat"]["series"][0]
        assert s["count"] == 4 and s["sum"] == pytest.approx(2.555)
        assert s["buckets"] == {"0.01": 1, "0.1": 1, "1.0": 1, "+Inf": 1}
        assert 0.01 <= h.percentile(0.5) <= 0.1
        with pytest.raises(ValueError):
            reg.histogram("bad", buckets=(1.0, 0.5))  # not increasing

    def test_disabled_is_noop(self):
        r = M.Registry(enabled=False)
        c, g, h = r.counter("n"), r.gauge("g"), r.histogram("h")
        c.inc()
        g.set(9)
        h.observe(1.0)
        assert c.value == 0.0 and g.value == 0.0
        assert r.snapshot()["h"]["series"][0]["count"] == 0
        r.enable()
        c.inc()
        assert c.value == 1.0

    def test_reset_keeps_definitions(self, reg):
        c = reg.counter("n")
        c.inc(5)
        reg.reset()
        assert c.value == 0.0
        assert reg.counter("n") is c

    def test_prometheus_conformance_golden(self):
        """The reference test's golden scrape text, byte for byte."""
        reg = M.Registry(enabled=True)
        c = reg.counter("scrape_c_total", "a counter",
                        labelnames=("k",))
        c.labels(k='quo"te').inc(3)
        c.labels(k="line\nbreak").inc()
        c.labels(k="back\\slash").inc(2)
        g = reg.gauge("scrape_g", "a gauge")
        g.set(2.5)
        h = reg.histogram("scrape_h_seconds", "a histogram",
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        golden = (
            '# HELP scrape_c_total a counter\n'
            '# TYPE scrape_c_total counter\n'
            'scrape_c_total{k="quo\\"te"} 3\n'
            'scrape_c_total{k="line\\nbreak"} 1\n'
            'scrape_c_total{k="back\\\\slash"} 2\n'
            '# HELP scrape_g a gauge\n'
            '# TYPE scrape_g gauge\n'
            'scrape_g 2.5\n'
            '# HELP scrape_h_seconds a histogram\n'
            '# TYPE scrape_h_seconds histogram\n'
            'scrape_h_seconds_bucket{le="0.1"} 1\n'
            'scrape_h_seconds_bucket{le="1"} 2\n'
            'scrape_h_seconds_bucket{le="+Inf"} 3\n'
            'scrape_h_seconds_sum 5.55\n'
            'scrape_h_seconds_count 3\n'
        )
        assert reg.to_prometheus() == golden

    @pytest.mark.parametrize("export", ["to_prometheus", "snapshot"])
    def test_exports_equal_the_reference(self, export):
        from paddle_tpu.observability import metrics as RM

        a = getattr(_golden_ops(M), export)()
        b = getattr(_golden_ops(RM), export)()
        assert a == b


class TestTracing:
    def test_span_nesting_and_order(self, tmp_path):
        """Spans around dispatches: nesting is recorded (parent/depth)
        and timestamps are monotonic in completion order."""
        tr = T.Tracer(enabled=True, path=str(tmp_path / "t.jsonl"))
        x = torch.ones(64)
        with tr.span("outer", request_id="r1"):
            with tr.span("dispatch"):
                (x * 2 + 1).sum()
            with tr.span("dispatch"):
                (x * 2 + 1).sum()
        evs = tr.events()
        names = [e["name"] for e in evs]
        assert names == ["dispatch", "dispatch", "outer"]
        d1, d2, outer = evs
        assert d1["parent"] == d2["parent"] == "outer"
        assert d1["depth"] == 1 and outer["depth"] == 0
        assert d1["ts"] <= d2["ts"] <= outer["ts"] + outer["dur"]
        assert outer["dur"] >= d1["dur"] + d2["dur"] - 1e-9
        tr.close()
        loaded = T.load_events(str(tmp_path / "t.jsonl"))
        assert [e["name"] for e in loaded] == ["trace_start"] + names

    def test_disabled_span_is_noop(self):
        tr = T.Tracer(enabled=False)
        with tr.span("x"):
            pass
        tr.event("y")
        assert tr.events() == []

    def test_sink_rotates_at_max_bytes(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        tr = T.Tracer(enabled=True)
        tr.configure(path=path, max_bytes=2048)
        for i in range(200):
            tr.event("ev", i=i, pad="x" * 40)
        tr.flush()
        assert os.path.getsize(path) <= 2048
        assert os.path.exists(path + ".1")
        assert os.path.getsize(path + ".1") <= 2048
        live = T.load_events(path)
        assert live[0]["name"] == "trace_start"
        assert live[0]["rotation"] >= 1
        assert live[-1]["i"] == 199
        prev = T.load_events(path + ".1")
        assert prev[-1]["i"] == live[1]["i"] - 1
        tr.close()

    def test_wrap_decorates_dispatch(self):
        tr = T.Tracer(enabled=True)
        calls = []
        g = tr.wrap("fn_dispatch", lambda a: calls.append(a) or a + 1)
        assert g(1) == 2
        assert calls == [1]
        assert tr.events()[0]["name"] == "fn_dispatch"

    def test_attach_device_ops_names_the_roadmap_item(self):
        with pytest.raises(NotImplementedError, match="A 14"):
            T.attach_device_ops({}, lambda: None)

    def test_assembly_equals_the_reference_on_one_stream(self):
        """The same synthetic event stream assembles to the same
        per-request records in both packages."""
        from paddle_tpu.observability import tracing as RT

        evs = [
            {"name": "request_submitted", "request_id": "a", "ts": 1.0},
            {"name": "request_admitted", "request_id": "a", "ts": 1.5},
            {"name": "prefill", "request_id": "a", "ts": 2.0, "dur": 1.0,
             "chunks": 2},
            {"name": "decode_dispatch", "request_ids": ["a"], "ts": 3.5,
             "dur": 0.25},
            {"name": "compile", "ts": 3.2, "dur": 0.1,
             "program": "multistep"},
            {"name": "request_done", "request_id": "a", "ts": 5.0,
             "new_tokens": 5, "ttft_s": 2.0},
            {"name": "detokenize", "request_id": "a", "ts": 5.0,
             "dur": 0.5},
        ]
        got = T.assemble_request_traces(list(evs))
        assert got == RT.assemble_request_traces(list(evs))
        assert got["a"]["phases_ms"]["prefill"] == 1000.0
        assert got["a"]["compiles_in_window"] == 1
        assert T.summarize_traces(got) == RT.summarize_traces(got)


@pytest.fixture(scope="module")
def tiny():
    from torch_twin_util import reference_tiny_model

    _model, _cfg, port, tcfg = reference_tiny_model(23)
    return port, tcfg


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, device="cpu", **kw)


class TestServingTrace:
    def test_paged_serving_trace_assembles(self, tiny, tmp_path,
                                           telemetry_on):
        """A short paged run produces a parseable JSONL trace whose
        per-request phase sum is the wall clock (they tile it), with
        TTFT in both the assembled report and stats(); the serving and
        pool metrics land in the registry."""
        port, tcfg = tiny
        path = str(tmp_path / "trace.jsonl")
        T.configure(path=path, truncate=True)
        rs = np.random.RandomState(3)
        srv = _server(port, max_slots=2, block_size=4, max_prompt_len=16,
                      max_new_tokens=4).start()
        try:
            prompts = [rs.randint(1, tcfg.vocab_size, (n,))
                       .astype(np.int32) for n in (3, 7, 5, 9)]
            t0 = time.perf_counter()
            futs = [srv.submit(p) for p in prompts]
            for f in futs:
                f.result(timeout=300)
            drain_ms = (time.perf_counter() - t0) * 1e3
            st = srv.stats()
        finally:
            srv.stop()
        assert 0 < st["ttft_p50_ms"] <= st["ttft_p99_ms"] <= st["p99_ms"]
        T.flush()
        with open(path) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        assert len(lines) == len(T.load_events(path))
        traces = T.assemble_request_traces(path=path)
        assert len(traces) == 4
        for r in traces.values():
            phase_sum = sum(r["phases_ms"].values())
            assert phase_sum == pytest.approx(r["wall_ms"], rel=1e-3)
            assert r["wall_ms"] <= drain_ms * 1.001 + 1.0
            assert set(r["phases_ms"]) == {"queue_wait", "admission",
                                           "prefill", "decode",
                                           "detokenize"}
            assert 0 < r["ttft_ms"] <= r["wall_ms"] * 1.001
            assert r["new_tokens"] == 4
            assert r["decode_dispatches"] >= 1
            assert r["prefill_chunks"] >= 1
        summ = T.summarize_traces(traces)
        assert summ["requests"] == 4 and summ["ttft_p50_ms"] > 0
        snap = M.snapshot()
        done = {s["labels"]["server"]: s["value"]
                for s in snap["serving_requests_total"]["series"]}
        assert done.get("paged") == 4
        pool_series = snap["kv_pool_used_blocks"]["series"]
        assert pool_series
        assert all(s["value"] == 0 for s in pool_series)  # drained
        assert all("pool" in s["labels"] for s in pool_series)
        refills = snap["serving_slot_refills_total"]["series"][0]["value"]
        assert refills == 4  # every admission fills an idle slot
        reasons = {s["labels"]["reason"]: s["value"] for s in
                   snap["serving_stop_reason_total"]["series"]
                   if s["value"]}
        assert reasons == {"budget": 4.0}

    def test_kv_pool_gauges_do_not_alias_across_caches(self,
                                                       telemetry_on):
        """Two live pools land on DISTINCT `pool`-labeled series."""
        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        c1 = PagedKVCache(1, 1, 2, block_size=4, num_blocks=4,
                          device="cpu")
        c2 = PagedKVCache(1, 1, 2, block_size=4, num_blocks=8,
                          device="cpu")
        c1.allocate("a", 4)
        c2.allocate("b", 20)
        assert c1._name != c2._name
        by = {s["labels"]["pool"]: s["value"]
              for s in M.snapshot()["kv_pool_used_blocks"]["series"]}
        assert by[c1._name] == 1.0
        assert by[c2._name] == 5.0

    def test_reset_stats_clears_ttft(self, tiny, telemetry_on):
        port, _tcfg = tiny
        srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                      max_new_tokens=2).start()
        try:
            srv.submit([3, 5, 7]).result(timeout=300)
            assert srv.stats()["ttft_p50_ms"] > 0
            srv.reset_stats()
            st = srv.stats()
            assert st["ttft_p50_ms"] == 0.0 and st["ttft_p99_ms"] == 0.0
        finally:
            srv.stop()

    def test_dense_server_events_and_metrics(self, telemetry_on):
        """The dense GenerationServer emits the reference's events
        (request_submitted / request_admitted / decode_dispatch span /
        request_done) and its `server="dense"` metrics."""
        from paddle_tpu_torch.inference import GenerationServer

        def program(ids, seed, temperature, eos, top_p, pad):
            return np.concatenate(
                [ids, np.full((ids.shape[0], 2), 9, np.int32)], axis=1)

        srv = GenerationServer(program, batch_size=2, prompt_len=4,
                               max_wait_ms=50).start()
        try:
            futs = [srv.submit([1, 2, 3]), srv.submit([4, 5, 6, 7])]
            outs = [f.result(timeout=60) for f in futs]
        finally:
            srv.stop()
        assert [o.tolist()[-2:] for o in outs] == [[9, 9], [9, 9]]
        names = [e["name"] for e in T.events()]
        for n in ("request_submitted", "request_admitted",
                  "decode_dispatch", "request_done"):
            assert n in names, (n, names)
        traces = T.assemble_request_traces()
        assert len(traces) == 2
        assert all(r["new_tokens"] == 2 for r in traces.values())
        snap = M.snapshot()
        done = {s["labels"]["server"]: s["value"]
                for s in snap["serving_requests_total"]["series"]}
        assert done.get("dense") == 2
        lat = {s["labels"]["server"]: s["count"] for s in
               snap["serving_request_latency_seconds"]["series"]}
        assert lat.get("dense") == 2


class TestWatchdogGauge:
    def test_heartbeat_age_gauge(self, telemetry_on):
        from paddle_tpu_torch.utils.watchdog import Watchdog

        wd = Watchdog(timeout=60).start()
        try:
            wd.beat()
            age = M.snapshot()["watchdog_heartbeat_age_seconds"][
                "series"][0]["value"]
            assert 0 <= age < 60
        finally:
            wd.stop()
