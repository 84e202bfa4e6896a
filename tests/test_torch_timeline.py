"""The port's Chrome/Perfetto timeline export (paddle_tpu_torch/
observability/timeline.py and `PagedGenerationServer.export_timeline`)
on the CPU: twins of tests/test_timeline.py.

The event shaping runs on the reference's module and the port's over
the same stream and must give the same trace events. The served cases
run the port's PagedGenerationServer on GPT-2 tiny (the reference's
float32 weights); the fleet cases lay two named port engines out by
hand and through the port's `FleetRouter.export_timeline`."""
import importlib
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability import timeline, tracing  # noqa: E402

REF = importlib.import_module("paddle_tpu.observability.timeline")


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
    from torch_twin_util import reference_tiny_model

    _ref, _cfg, port, _tcfg = reference_tiny_model(100)
    return port


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, max_slots=2, block_size=4,
                                 max_prompt_len=24, max_new_tokens=8,
                                 flight_recorder=True, device="cpu", **kw)


class TestEventShaping:
    def test_spans_points_processes_tracks(self):
        span_events = [
            {"name": "decode_dispatch", "ts": 10.0, "dur": 0.5,
             "replica": "r0", "request_ids": ["a"]},
            {"name": "request_done", "ts": 10.6, "replica": "r0",
             "request_id": "a", "trace_id": "tX", "hop": 0,
             "cause": "admit"},
            {"name": "fleet_place", "ts": 9.9, "request_id": "a"},
            {"name": "trace_start", "ts": 0.0},
        ]
        recorders = {"r0": [{"name": "admit", "ts": 10.1, "seq": 0,
                             "request_id": "a"}]}
        evs, t0 = timeline.chrome_trace_events(
            span_events, recorders, default_name="router")
        assert (evs, t0) == REF.chrome_trace_events(
            span_events, recorders, default_name="router")
        assert t0 == 9.9
        meta = [e for e in evs if e["ph"] == "M"]
        assert {e["args"]["name"] for e in meta
                if e["name"] == "process_name"} == {"r0", "router"}
        tracks = {e["args"]["name"] for e in meta
                  if e["name"] == "thread_name"}
        assert {"dispatch", "requests", "lifecycle", "ring"} <= tracks
        x = [e for e in evs if e["ph"] == "X"]
        assert len(x) == 1 and x[0]["name"] == "decode_dispatch"
        assert x[0]["dur"] == pytest.approx(0.5e6)
        assert x[0]["ts"] == pytest.approx((10.0 - 9.9) * 1e6)
        assert {e["name"] for e in evs if e["ph"] == "i"} == \
            {"request_done", "fleet_place", "admit"}
        done = next(e for e in evs if e["name"] == "request_done")
        assert done["args"]["trace_id"] == "tX"
        assert "trace_start" not in {e["name"] for e in evs}

    def test_write_is_valid_json_with_display_unit(self, tmp_path):
        spans = [{"name": "round", "ts": 1.0, "dur": 0.1,
                  "replica": "r0"}]
        n = timeline.write_chrome_trace(str(tmp_path / "tl.json"),
                                        span_events=spans)
        REF.write_chrome_trace(str(tmp_path / "ref.json"),
                               span_events=spans)
        doc = json.loads((tmp_path / "tl.json").read_text())
        assert doc == json.loads((tmp_path / "ref.json").read_text())
        assert n == 1
        assert doc["displayTimeUnit"] == "ms"
        assert [e for e in doc["traceEvents"] if e["ph"] == "X"]

    def test_empty_stream(self, tmp_path):
        path = tmp_path / "empty.json"
        assert timeline.write_chrome_trace(str(path), span_events=[]) == 0
        assert json.loads(path.read_text())["traceEvents"] == []


class TestServingExport:
    def test_engine_export_timeline(self, tiny, tmp_path):
        srv = _server(tiny).start()
        try:
            srv.submit(np.array([3, 5, 7], np.int32),
                       max_new_tokens=4).result(timeout=300)
        finally:
            srv.stop()
        path = tmp_path / "engine.json"
        n = srv.export_timeline(str(path))
        evs = json.loads(path.read_text())["traceEvents"]
        assert n > 0
        names = {e["name"] for e in evs}
        assert "detokenize" in names      # a span of the sink
        assert "submit" in names          # a flight-recorder entry
        assert "decode_dispatch" in {e["name"] for e in evs
                                     if e["ph"] == "X"}
        procs = {e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert procs == {"engine"}

    def test_named_engines_lay_out_on_their_own_processes(self, tiny,
                                                          tmp_path):
        """Two engines named like fleet replicas stamp their dispatch
        spans with the name; one export of the shared sink and both
        rings gives each its own process."""
        srvs = []
        for i in range(2):
            s = _server(tiny, enable_prefix_cache=True)
            s.trace_name = f"r{i}"
            srvs.append(s.start())
        try:
            futs = [srvs[i % 2].submit(np.array([3 + i, 5, 7], np.int32))
                    for i in range(4)]
            for f in futs:
                f.result(timeout=300)
        finally:
            for s in srvs:
                s.stop()
        path = tmp_path / "fleet.json"
        n = timeline.write_chrome_trace(
            str(path), recorders={s.trace_name: s._recorder.events()
                                  for s in srvs},
            default_name="router")
        doc = json.loads(path.read_text())
        assert n > 0
        pid_of = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"r0", "r1"} <= set(pid_of)
        assert len(set(pid_of.values())) == len(pid_of)
        x_procs = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {pid_of["r0"], pid_of["r1"]} <= x_procs

    def test_fleet_export_lays_replicas_on_own_processes(self, tiny,
                                                         tmp_path):
        from paddle_tpu_torch.fleet import FleetRouter, Replica

        reps = [Replica(f"r{i}", _server(tiny, enable_prefix_cache=True))
                for i in range(2)]
        router = FleetRouter(reps).start()
        try:
            futs = [router.submit(np.array([3 + i, 5, 7], np.int32))
                    for i in range(4)]
            for f in futs:
                f.result(timeout=300)
        finally:
            router.stop()
        path = tmp_path / "fleet.json"
        n = router.export_timeline(str(path))
        doc = json.loads(path.read_text())
        assert n > 0
        procs = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert procs & {"r0", "r1"}
        pid_of = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
                  if e["ph"] == "M" and e["name"] == "process_name"}
        assert len(set(pid_of.values())) == len(pid_of)
