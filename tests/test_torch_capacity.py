"""The port's capacity pressure signals (paddle_tpu_torch/observability/
capacity.py) and the paged server's `/capacity` plane on the CPU: twins
of tests/test_capacity.py.

`PressureSignals` runs on an explicit clock: each host-side scenario
runs on the reference's module and the port's and must give the same
snapshots. The served cases use the port's PagedGenerationServer and
FrontDoor on GPT-2 tiny (the reference's float32 weights); the fleet
case federates two port engines' snapshots and a dead source directly
(the router that does it in production is ROADMAP §A 12)."""
import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability.capacity import (  # noqa: E402
    FLEET_SCHEMA_VERSION, SCHEMA_VERSION, PressureSignals,
    federate_capacity, fleet_aggregate)

REF = importlib.import_module("paddle_tpu.observability.capacity")
PORT = importlib.import_module("paddle_tpu_torch.observability.capacity")


@pytest.fixture(scope="module")
def tiny():
    from torch_twin_util import reference_tiny_model

    ref, cfg, port, _tcfg = reference_tiny_model(29)
    return ref, cfg, port


@pytest.fixture
def metrics_gate_restore():
    from paddle_tpu_torch.observability import metrics as M

    was = M.REGISTRY.enabled
    yield
    M.REGISTRY.enabled = was
    M.REGISTRY.reset()


def _get(url, timeout=10):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _both(fn):
    want, have = fn(REF), fn(PORT)
    assert have == want, (have, want)
    return have


class TestPressureSignals:
    def test_deterministic_replay(self):
        def run(m):
            clk = FakeClock()
            state = {"free": 100}
            ps = m.PressureSignals(
                {"pool": lambda: {"free_blocks": state["free"]}},
                min_interval_s=1.0, clock=clk)
            out = []
            for step in range(10):
                clk.t = step * 0.7
                state["free"] = 100 - 7 * step
                snap = ps.maybe_sample()
                if snap is not None:
                    out.append(json.dumps(snap, sort_keys=True))
            return out

        a = _both(run)
        assert a == run(PORT)
        assert 1 < len(a) < 10

    def test_min_interval_gates(self):
        def run(m):
            clk = FakeClock()
            ps = m.PressureSignals({"pool": lambda: {"free_blocks": 5}},
                                   min_interval_s=1.0, clock=clk)
            out = [ps.maybe_sample() is not None]
            clk.t = 0.5
            out.append(ps.maybe_sample() is not None)
            clk.t = 1.0
            out.append(ps.maybe_sample() is not None)
            return out + [ps.sample() is not None]

        assert _both(run) == [True, False, True, True]

    def test_snapshot_schema_and_counter(self):
        def run(m):
            clk = FakeClock()
            ps = m.PressureSignals({"pool": lambda: {"free_blocks": 5},
                                    "extra": lambda: {"x": 1}}, clock=clk)
            s1 = ps.sample()
            clk.t = 2.0
            return s1, ps.sample(), ps.history_len()

        s1, s2, n = _both(run)
        assert s1["schema_version"] == SCHEMA_VERSION == 1
        assert s1["samples"] == 1 and s2["samples"] == 2
        assert s2["ts"] == 2.0 and s2["extra"] == {"x": 1}
        assert n == 2

    def test_exhaustion_forecast_linear_drain(self):
        def run(m):
            clk = FakeClock()
            free = {"v": 200}
            ps = m.PressureSignals(
                {"pool": lambda: {"free_blocks": free["v"]}}, clock=clk)
            for step in range(5):
                clk.t = float(step)
                free["v"] = 200 - 10 * step
                snap = ps.sample()
            return snap["forecast"]

        fc = _both(run)
        assert fc["free_blocks_slope_per_s"] == pytest.approx(-10.0)
        assert fc["exhaustion_eta_s"] == pytest.approx(16.0)
        assert fc["window_samples"] == 5

    def test_no_eta_when_refilling_or_flat(self):
        def run(m):
            clk = FakeClock()
            free = {"v": 10}
            ps = m.PressureSignals(
                {"pool": lambda: {"free_blocks": free["v"]}}, clock=clk)
            for step in range(4):
                clk.t = float(step)
                free["v"] = 10 + step
                snap = ps.sample()
            return snap["forecast"]["exhaustion_eta_s"]

        assert _both(run) is None

    def test_dead_source_tolerance(self):
        def boom():
            raise RuntimeError("pool gone")

        def run(m):
            return m.PressureSignals(
                {"pool": boom, "queues": lambda: {"queue_depth": 1}},
                clock=FakeClock()).sample()

        snap = _both(run)
        assert "RuntimeError" in snap["pool"]["error"]
        assert snap["queues"] == {"queue_depth": 1}
        assert snap["forecast"]["free_blocks_slope_per_s"] is None

    def test_federate_with_dead_source(self):
        def dead():
            raise RuntimeError("replica killed")

        fed = _both(lambda m: m.federate_capacity(
            {"a": lambda: {"schema_version": 1, "pool": {}}, "b": dead}))
        assert fed["schema_version"] == FLEET_SCHEMA_VERSION == 2
        assert fed["replicas"]["a"]["pool"] == {}
        assert "RuntimeError" in fed["replicas"]["b"]["error"]
        agg = fed["aggregate"]
        assert (agg["replicas_total"], agg["replicas_ok"],
                agg["replicas_error"]) == (2, 1, 1)

    def test_fleet_aggregate_block(self):
        srcs = {
            "a": lambda: {
                "schema_version": 1,
                "pool": {"num_blocks": 100, "free_blocks": 10,
                         "used_blocks": 90},
                "queues": {"queue_depth": 3, "busy_slots": 2,
                           "max_slots": 4},
                "admission": {"sheds": 1, "draining": False},
                "slo": {"enabled": True,
                        "slos": [{"burn_fast": 2.5, "burn_slow": 0.5}]},
                "forecast": {"exhaustion_eta_s": 12.0},
            },
            "b": lambda: {
                "schema_version": 1,
                "pool": {"num_blocks": 100, "free_blocks": 80,
                         "used_blocks": 20},
                "queues": {"queue_depth": 1, "busy_slots": 1,
                           "max_slots": 4},
                "admission": {"sheds": 0, "draining": True},
                "slo": {"enabled": True,
                        "slos": [{"burn_fast": 0.2, "burn_slow": 0.1}]},
                "forecast": {"exhaustion_eta_s": None},
            },
            "legacy": lambda: {"schema_version": 1},
        }
        fed = _both(lambda m: m.federate_capacity(srcs))
        agg = fed["aggregate"]
        assert agg["replicas_total"] == 3 and agg["replicas_ok"] == 3
        assert agg["free_blocks_total"] == 90
        assert agg["used_blocks_total"] == 110
        assert agg["num_blocks_total"] == 200
        assert agg["min_headroom_frac"] == pytest.approx(0.1)
        assert agg["max_burn"] == pytest.approx(2.5)
        assert agg["queue_depth_total"] == 4
        assert agg["busy_slots_total"] == 3
        assert agg["max_slots_total"] == 8
        assert agg["sheds_total"] == 1
        assert agg["draining"] == 1
        assert agg["min_exhaustion_eta_s"] == pytest.approx(12.0)
        assert fleet_aggregate(fed["replicas"]) == agg
        assert json.loads(json.dumps(fed))


def _port_server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, device="cpu", **kw)


class TestEngineCapacity:
    def test_capacity_snapshot_schema(self, tiny):
        """The port's snapshot has the reference's slots and keys, and
        the pool's headroom equals the reference pool's after the same
        request."""
        from paddle_tpu.inference import PagedGenerationServer as RefSrv

        ref, cfg, port = tiny
        kw = dict(max_slots=2, block_size=4, max_prompt_len=16,
                  max_new_tokens=3)
        rs = np.random.RandomState(1)
        p = rs.randint(1, cfg.vocab_size, (6,)).astype(np.int32)
        snaps = []
        for srv in (RefSrv(ref, **kw), _port_server(port, **kw)):
            srv.start()
            try:
                srv.submit(p).result(timeout=300)
                snaps.append(srv.capacity_snapshot())
            finally:
                srv.stop()
        want, snap = snaps
        assert snap["schema_version"] == 1
        assert sorted(snap) == sorted(want)
        for slot in ("pool", "tier", "queues", "admission", "slo"):
            assert sorted(snap[slot]) == sorted(want[slot]), slot
        assert snap["pool"] == want["pool"]
        assert snap["queues"] == want["queues"]
        assert snap["admission"] == want["admission"]
        assert snap["slo"] == want["slo"] == {"enabled": False,
                                               "slos": []}
        pool = snap["pool"]
        assert pool["free_blocks"] + pool["used_blocks"] \
            + pool["retained_blocks"] == pool["num_blocks"]
        assert json.loads(json.dumps(snap))

    def test_capacity_endpoint_and_ring_samples(self, tiny,
                                                metrics_gate_restore):
        _ref, cfg, port = tiny
        srv = _port_server(port, max_slots=2, block_size=4,
                           max_prompt_len=16, max_new_tokens=4,
                           expose_port=0).start()
        try:
            rs = np.random.RandomState(2)
            futs = [srv.submit(rs.randint(1, cfg.vocab_size, (n,))
                               .astype(np.int32)) for n in (3, 7, 5)]
            for f in futs:
                f.result(timeout=300)
            code, body = _get(srv.exporter.url + "/capacity")
            assert code == 200, body
            snap = json.loads(body)
            assert snap["schema_version"] == 1
            assert snap["pool"]["num_blocks"] > 0
            code, body = _get(srv.exporter.url + "/nope")
            assert code == 404 and "/capacity" in body
            dump = srv.dump_flight_recorder()
            caps = [e for e in dump["events"]
                    if e["name"] == "capacity_sample"]
            assert caps, [e["name"] for e in dump["events"]][:20]
            assert caps[0]["free_blocks"] is not None
        finally:
            srv.stop()

    def test_endpoint_404_without_capacity_fn(self):
        from paddle_tpu_torch.observability.exporter import OpsEndpoint

        ep = OpsEndpoint().start(port=0)
        try:
            code, body = _get(ep.url + "/capacity")
            assert code == 404
            assert "/capacity" not in json.loads(body)["paths"]
        finally:
            ep.stop()

    def test_frontdoor_passthrough(self, tiny):
        from paddle_tpu_torch.frontend import FrontDoor

        _ref, _cfg, port = tiny
        fd = FrontDoor(port, max_slots=1, block_size=4, max_prompt_len=16,
                       max_new_tokens=2, device="cpu")
        fd.start()
        try:
            snap = fd.capacity()
            assert snap["schema_version"] == 1
            assert "lanes" in snap["queues"]
        finally:
            fd.stop()


class TestFederatedEngines:
    def test_federation_over_engines_tolerates_a_dead_one(self, tiny):
        """Two port engines' snapshots federate under the fleet schema;
        a source that raises (a dead replica) degrades to its error
        slot while the live one still answers."""
        _ref, cfg, port = tiny
        srvs = [_port_server(port, max_slots=1, block_size=4,
                             max_prompt_len=16, max_new_tokens=2).start()
                for _ in range(2)]
        try:
            rs = np.random.RandomState(4)
            p = rs.randint(1, cfg.vocab_size, (5,)).astype(np.int32)
            srvs[0].submit(p).result(timeout=300)
            fed = federate_capacity({f"r{i}": s.capacity_snapshot
                                     for i, s in enumerate(srvs)})
            assert fed["schema_version"] == FLEET_SCHEMA_VERSION
            assert set(fed["replicas"]) == {"r0", "r1"}
            for snap in fed["replicas"].values():
                assert snap["schema_version"] == 1
            assert fed["aggregate"]["replicas_ok"] == 2
            assert fed["aggregate"]["num_blocks_total"] > 0

            def dead():
                raise RuntimeError("replica r1 is dead")

            fed = federate_capacity({"r0": srvs[0].capacity_snapshot,
                                     "r1": dead})
            assert fed["replicas"]["r0"]["schema_version"] == 1
            assert "dead" in fed["replicas"]["r1"]["error"]
            assert fed["aggregate"]["replicas_error"] == 1
        finally:
            for s in srvs:
                s.stop()
        assert isinstance(PressureSignals({}).sample(), dict)
