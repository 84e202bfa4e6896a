"""The port's multi-process fleet on the CPU: twins of
tests/test_fleet_transport.py. Workers are port subprocesses
(`python -m paddle_tpu_torch.fleet.transport`, `"device": "cpu"`) that
load the reference's `paddle.seed(100)` GPT-2 tiny from an npz through
`from_reference_params`; the parity reference is the reference's
in-process fleet on the reference's model. The composed stack of the
reference test (prefix cache, speculation, W8A16 weights, an int8 KV
pool) runs in every worker, so every wire hop (journal replay,
export/import, the disaggregated handoff) carries int8 codes bit-exactly.

  * the probe surface over HTTP, typed errors across the wire, the warm
    start and the drain route;
  * the wire surface answers the other package's client both ways: one
    greedy and one sampled request give the same tokens, and the probe
    JSON has the same keys;
  * two-process md5 parity with a live migration, the disaggregated
    handoff, FleetLanes, and /capacity federation degrading a SIGSTOPped
    worker to an error slot;
  * the SIGKILL chaos gate, its victim held mid-decode by the worker's
    own fault seam (a `slow_dispatch` stall at its third dispatch that
    outlasts the test) until the kill: no wall-clock margin decides
    whether the victim is still decoding.

Waits are on conditions with generous deadlines; the only elapsed-time
bounds are the federation deadline checks of the reference test."""
import hashlib
import os
import signal
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.fleet import (DisaggRouter, FleetLanes,  # noqa: E402
                                    FleetRouter, RemoteEngine,
                                    RemoteReplica, Replica)
from paddle_tpu_torch.observability.capacity import (  # noqa: E402
    federate_capacity)
from paddle_tpu_torch.sampling import SamplingParams  # noqa: E402

MODEL_CONFIG = {"vocab_size": 512, "hidden_size": 128, "num_layers": 2,
                "num_heads": 4, "max_position": 128, "dropout": 0.0}
# the reference worker's recipe (tests/test_fleet_transport.py)
REF_SPEC = {"kind": "gpt2", "seed": 100, "config": MODEL_CONFIG}
# the composed stack of the reference test
SRV_KW = {"max_slots": 2, "block_size": 4, "max_prompt_len": 24,
          "max_new_tokens": 16, "prefill_chunk_tokens": 16,
          "enable_prefix_cache": True, "speculation": True,
          "quantization": "w8a16", "kv_dtype": "int8"}
# the chaos victim's stall: FaultPlan.from_seed(3, rate 0.5, horizon 3)
# schedules slow_dispatch at occurrence 2 only, i.e. the worker's third
# dispatch (after its first prefill and a decode) sleeps far longer than
# the test runs, until the SIGKILL
STALL_PLAN = "seed=3,rate=0.5,horizon=3,slow=600,seams=slow_dispatch"


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
def models(tmp_path_factory):
    """(reference GPT2, the port's GPT2, the npz of the reference's
    parameters the port workers load)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(REF_SPEC["seed"])
    ref = GPT2(GPT2Config(**MODEL_CONFIG))
    ref.eval()
    params = {k: np.asarray(v)
              for k, v in ref.functional_state()[0].items()}
    path = tmp_path_factory.mktemp("fleet-weights") / "gpt2_tiny.npz"
    np.savez(path, **params)
    port = from_reference_params(TConfig(**MODEL_CONFIG), params,
                                 device="cpu")
    return ref, port, str(path)


def _wconfig(models, **extra):
    cfg = {"model": {"kind": "gpt2", "weights": models[2],
                     "config": MODEL_CONFIG},
           "server": dict(SRV_KW), "device": "cpu"}
    cfg.update(extra)
    return cfg


def _spawn(models, n, prefix, configs=None):
    configs = configs or [_wconfig(models)] * n
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(
            lambda i: RemoteReplica.spawn(f"{prefix}{i}", configs[i],
                                          keep_alive_on_stop=True),
            range(n)))


@pytest.fixture(scope="module")
def workers(models):
    reps = _spawn(models, 2, "wt")
    yield reps
    for r in reps:
        r.terminate()


def _twin_replica(port, name):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return Replica(name, PagedGenerationServer(port, device="cpu",
                                               **SRV_KW))


def _ref_replica(ref, name):
    from paddle_tpu.fleet import Replica as JReplica
    from paddle_tpu.inference import PagedGenerationServer

    return JReplica(name, PagedGenerationServer(ref, **SRV_KW))


def _md5(arr):
    return hashlib.md5(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _journal():
    return tempfile.NamedTemporaryFile(suffix=".journal", delete=False).name


def _sp(pkg, **kw):
    if pkg == "ref":
        from paddle_tpu.sampling import SamplingParams as JSP

        return JSP(**kw)
    return SamplingParams(**kw)


def _work(pkg):
    return [
        (np.array([3, 5, 7, 9], np.int32), {}),
        (np.array([1, 2, 3], np.int32),
         {"sampling": _sp(pkg, temperature=0.8, top_p=0.9, seed=77)}),
        (np.array([8, 8, 1, 4, 2], np.int32), {}),
        (np.array([6, 6, 6], np.int32),
         {"sampling": _sp(pkg, temperature=1.1, top_k=40, seed=123)}),
        (np.array([2, 7, 1, 8], np.int32), {}),
        (np.array([9, 1, 9], np.int32),
         {"sampling": _sp(pkg, temperature=0.7, seed=31)}),
    ]


WORK = _work("port")


def _drive(router, work=WORK, timeout=300):
    futs = [router.submit(ids, **kw) for ids, kw in work]
    return [f.result(timeout=timeout) for f in futs]


def _ref_outputs(ref, work):
    """The reference's in-process 1-replica fleet over `work` (its
    sampling in the reference's type)."""
    from paddle_tpu.fleet import FleetRouter as JRouter

    router = JRouter([_ref_replica(ref, "ref")], journal=_journal())
    router.start()
    try:
        return _drive(router, work)
    finally:
        router.stop()


@pytest.fixture(scope="module")
def ref_hashes(models):
    """Every sampled item carries its seed, so the router's seed
    resolution is inert and the reference is topology-independent."""
    return [_md5(o) for o in _ref_outputs(models[0], _work("ref"))]


class TestWireSurface:
    def test_probe_surface_over_http(self, workers):
        w = workers[0]
        assert w.server.max_new == SRV_KW["max_new_tokens"]
        assert w.server.max_slots == SRV_KW["max_slots"]
        live, detail = w.liveness()
        assert live is True and isinstance(detail, dict)
        ready, rdetail = w.readiness()
        assert ready is True and isinstance(rdetail, dict)
        assert w.load() >= 0
        assert w.queue_depth() >= 0
        assert w.prefix_match_len(np.array([1, 2, 3], np.int32)) >= 0
        assert w.capacity()["schema_version"] == 1
        st = w.server.stats()
        assert isinstance(st, dict)
        assert set(st["kernel_launches"]) >= {"ragged_stream_dense",
                                              "paged_decode_dense"}
        assert "#" in w.metrics_text()

    def test_typed_errors_cross_the_wire(self, workers):
        w = workers[0]
        with pytest.raises(ValueError):
            w.server.submit(np.array([1, 2], np.int32),
                            max_new_tokens=999).result(timeout=60)
        too_long = np.ones(SRV_KW["max_prompt_len"] + 9, np.int32)
        with pytest.raises(ValueError):
            w.server.submit(too_long).result(timeout=60)
        with pytest.raises(KeyError):
            w.server.export_session("no-such-request")

    def test_worker_spawned_warm_by_default(self, workers):
        w = workers[0]
        ready, detail = w.readiness()
        assert ready is True
        assert detail.get("warmed") is True, detail
        assert w.server.info.get("warmed") is True

    def test_warm_start_opt_out_and_drain_route(self, models):
        w = RemoteReplica.spawn("cold0", _wconfig(models, warm_start=False),
                                keep_alive_on_stop=True)
        try:
            ready, detail = w.readiness()
            assert ready is True
            assert detail.get("warmed") is False, detail
            w.server.set_draining(True)
            ready, detail = w.readiness()
            assert ready is False and detail.get("draining") is True
            w.server.set_draining(False)
            ready, detail = w.readiness()
            assert ready is True and detail.get("draining") is False
        finally:
            w.terminate()


def _probe_keys(engine):
    """The key sets of the probe routes' JSON (two levels deep)."""
    out = {}
    for path in ("/info", "/healthz/live", "/healthz/ready", "/load"):
        r = engine._get_json(path)
        out[path] = {k: sorted(v) if isinstance(v, dict) else None
                     for k, v in r.items()}
    out["/capacity"] = sorted(engine._get_json("/capacity"))
    return out


def _two_requests(engine, pkg):
    """One greedy and one sampled request through `engine` (sampling in
    the client package's type)."""
    futs = [engine.submit(np.array([3, 5, 7, 9], np.int32),
                          max_new_tokens=10),
            engine.submit(np.array([1, 2, 3], np.int32), max_new_tokens=10,
                          sampling=_sp(pkg, temperature=0.8, top_p=0.9,
                                       seed=77))]
    return [f.result(timeout=300) for f in futs]


class TestCrossPackageWire:
    def test_each_client_speaks_to_the_other_packages_worker(
            self, models, workers):
        """The port's RemoteEngine against a reference worker and the
        reference's RemoteEngine against a port worker: the same tokens
        as the reference's in-process server, and the same probe keys
        (the port worker's /info, /healthz and /load against the
        reference worker's)."""
        from paddle_tpu.fleet import RemoteEngine as JRemoteEngine
        from paddle_tpu.fleet import RemoteReplica as JRemoteReplica

        want = _ref_outputs(models[0], [
            (np.array([3, 5, 7, 9], np.int32), {"max_new_tokens": 10}),
            (np.array([1, 2, 3], np.int32),
             {"max_new_tokens": 10,
              "sampling": _sp("ref", temperature=0.8, top_p=0.9,
                              seed=77)})])
        jw = JRemoteReplica.spawn(
            "jref0", {"model": REF_SPEC, "server": SRV_KW},
            keep_alive_on_stop=True)
        try:
            on_ref = _two_requests(
                RemoteEngine("127.0.0.1", jw.server.port), "port")
            on_port = _two_requests(
                JRemoteEngine("127.0.0.1", workers[1].server.port), "ref")
            ref_keys = _probe_keys(jw.server)
        finally:
            jw.terminate()
        for got in (on_ref, on_port):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert _probe_keys(workers[1].server) == ref_keys


class TestWireParity:
    def test_two_process_fleet_md5_parity_with_live_migration(
            self, workers, ref_hashes):
        router = FleetRouter(workers, journal=_journal(),
                             probe_interval_s=0.5, seed=5).start()
        try:
            first = threading.Event()
            futs = [router.submit(WORK[0][0],
                                  on_token=lambda t, r: first.set())]
            assert first.wait(timeout=120)
            rid = sorted(router._sessions)[0]
            try:
                moved_to = router.migrate_session(rid)
                assert moved_to in {w.name for w in workers}
            except KeyError:
                pass  # finished before the migration: parity still gates
            futs += [router.submit(ids, **kw) for ids, kw in WORK[1:]]
            outs = [f.result(timeout=300) for f in futs]
            st = router.stats()
        finally:
            router.stop()
        assert [_md5(o) for o in outs] == ref_hashes
        assert st["new_tokens"] > 0
        from paddle_tpu_torch.observability import metrics as M

        text = M.REGISTRY.to_prometheus()
        assert "fleet_wire_requests_total" in text
        assert "fleet_wire_tokens_total" in text


class TestCapacityFederationTimeout:
    def test_hung_source_degrades_to_error_slot(self):
        def hung():
            time.sleep(30)

        t0 = time.monotonic()
        snap = federate_capacity(
            {"ok": lambda: {"schema_version": 1, "free": 3},
             "hung": hung}, timeout_s=0.3)
        assert time.monotonic() - t0 < 5.0
        assert snap["replicas"]["ok"]["free"] == 3
        assert "timeout" in snap["replicas"]["hung"]["error"], snap
        snap = federate_capacity({"ok": lambda: {"v": 1}}, timeout_s=None)
        assert snap["replicas"]["ok"] == {"v": 1}

    def test_sigstopped_worker_degrades_not_stalls(self, workers):
        victim = workers[1]
        os.kill(victim._proc.pid, signal.SIGSTOP)
        try:
            t0 = time.monotonic()
            snap = federate_capacity(
                {w.name: w.capacity for w in workers}, timeout_s=1.5)
            wall = time.monotonic() - t0
        finally:
            os.kill(victim._proc.pid, signal.SIGCONT)
        assert wall < 10.0, wall
        assert snap["replicas"]["wt0"]["schema_version"] == 1
        assert "error" in snap["replicas"]["wt1"], snap


class TestDisaggOverWire:
    def test_prefill_decode_handoff_parity(self, models, workers):
        def work(pkg):
            return [
                (np.array([4, 2, 4, 2, 7], np.int32),
                 {"max_new_tokens": 16}),  # the handoff candidate
                (np.array([5, 5, 1], np.int32), {"max_new_tokens": 6}),
                (np.array([9, 3, 9, 3], np.int32),
                 {"max_new_tokens": 6,
                  "sampling": _sp(pkg, temperature=0.9, seed=11)}),
            ]

        ref_out = [_md5(o) for o in _ref_outputs(models[0], work("ref"))]
        before = workers[1].server.stats()
        drouter = DisaggRouter([workers[0]], [workers[1]],
                               journal=_journal(), handoff_poll_s=0.002,
                               probe_interval_s=0.5, seed=5).start()
        try:
            outs = _drive(drouter, work("port"))
            st = drouter.stats()
        finally:
            drouter.stop()
        assert [_md5(o) for o in outs] == ref_out
        d = st["disagg"]
        assert d["prefill_pool"] == ["wt0"], d
        assert d["decode_pool"] == ["wt1"], d
        assert d["handoffs"] >= 1, d
        assert d["handoffs_failed"] == 0, d
        # the decode worker decoded the handed-off sessions
        after = workers[1].server.stats()
        assert after["decode_steps"] + after["speculation"][
            "verify_dispatches"] > before["decode_steps"] + before[
                "speculation"]["verify_dispatches"]


class TestFleetLanes:
    def test_lane_scheduler_composes_above_placement(self, models):
        from paddle_tpu_torch.frontend import RequestMeta
        from paddle_tpu_torch.frontend.scheduler import LaneScheduler

        reps = [_twin_replica(models[1], f"l{i}") for i in range(2)]
        router = FleetRouter(reps, journal=_journal()).start()
        lanes = FleetLanes(router, LaneScheduler()).start()
        try:
            futs = [lanes.submit(
                ids, meta=RequestMeta(
                    lane="interactive" if i % 2 == 0 else "batch",
                    tenant=("a", "b", "c")[i % 3]), **kw)
                for i, (ids, kw) in enumerate(WORK)]
            outs = [f.result(timeout=300) for f in futs]
            st = lanes.stats()
        finally:
            lanes.stop()
            router.stop()
        assert len(outs) == len(WORK)
        assert all(len(o) > 0 for o in outs)
        assert st["dispatched"] == len(WORK), st
        assert st["depth"] == 0, st
        assert st["inflight"] == 0, st


class TestChaosOverWire:
    def test_sigkill_worker_mid_decode_token_identical_failover(
            self, models, ref_hashes):
        """A real SIGKILL of the worker holding mid-decode sessions: the
        router's journal re-admits them on the survivor and every request
        completes md5-equal to the reference. The victim (ck0, first in
        placement order) stalls at its third dispatch until the kill, so
        its sessions are mid-decode when it dies, whatever the speed of
        the machine."""
        victim_cfg = _wconfig(models)
        victim_cfg["server"]["fault_plan"] = STALL_PLAN
        chaos = _spawn(models, 2, "ck", [victim_cfg, _wconfig(models)])
        victim = chaos[0]
        router = FleetRouter(chaos, journal=_journal(),
                             probe_interval_s=0.1, seed=5).start()
        try:
            futs = [router.submit(ids, **kw) for ids, kw in WORK]

            def held():
                with router._lock:
                    return [s for s in router._sessions.values()
                            if s.replica is victim and s.toks
                            and not s.done]

            deadline = time.monotonic() + 120
            while not held() and time.monotonic() < deadline:
                time.sleep(0.01)
            mid = [(s.rid, len(s.toks), s.budget) for s in held()]
            assert mid, "no session reached the victim's stall"
            victim.kill()  # real SIGKILL, mid-decode
            outs = [f.result(timeout=300) for f in futs]
            st = router.stats()
        finally:
            router.stop()
            for r in chaos:
                r.terminate()
        assert all(0 < n < budget for _rid, n, budget in mid), mid
        assert [_md5(o) for o in outs] == ref_hashes
        assert st["failover_sessions"] >= len(mid), st
        assert sum(1 for r in chaos if r.dead) == 1
