"""The port's serving fleet (paddle_tpu_torch/fleet) on the CPU: twins of
tests/test_fleet.py, each holding the port's fleet on port engines to
the reference's fleet on reference engines with the same weights (GPT-2
tiny, vocab 512, hidden 128, 2 layers, 4 heads: the reference's
`paddle.seed(100)` model carried across by `from_reference_params`).

  * the replica health ladder and /metrics federation: the same
    transitions, weights and pages as the reference's;
  * the KV wire format, dense and int8: a payload serialized by either
    package deserializes in the other to equal arrays, and the two
    packages' bytes for equal pools are equal; the layout-mismatch
    refusal; a side-effect-free `match_prefix_len`;
  * stream rebind, placement, draining, global shed, no routable replica;
  * the chaos gate at 2 and 4 replicas (a seeded `replica_kill` mid-
    stream, and an external kill found by the probe): every session's
    tokens md5-equal to the reference fleet's uninterrupted run, greedy
    and fixed-seed sampled;
  * planned migration with no prefill on the target, the fallback to
    journal replay when the source is dead, and router restart recovery
    from the journal — each token for token the reference's run.

Waits are on conditions with generous deadlines; nothing asserts an
elapsed time below a bound."""
import hashlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.fleet import (FleetRouter, Replica,  # noqa: E402
                                    ReplicaHealth, add_label_to_prom_text,
                                    deserialize_kv_payload,
                                    federate_metrics, serialize_kv_payload)
from paddle_tpu_torch.reliability import (AdmissionShed,  # noqa: E402
                                          FaultPlan, ReplicaUnavailable)
from paddle_tpu_torch.sampling import SamplingParams  # noqa: E402


@pytest.fixture(autouse=True)
def _registry_guard():
    """expose_port= enables the metrics registries by design: restore
    both packages' gates and zero their series afterwards."""
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
    tests/test_fleet.py's model."""
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
    kw.setdefault("enable_prefix_cache", True)
    return kw


def _replica(port, name, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return Replica(name, PagedGenerationServer(port, device="cpu",
                                               **_kw(kw)))


def _ref_replica(ref, name, **kw):
    from paddle_tpu.fleet import Replica as JReplica
    from paddle_tpu.inference import PagedGenerationServer

    return JReplica(name, PagedGenerationServer(ref, **_kw(kw)))


def _fleet(port, n, **router_kw):
    reps = [_replica(port, f"r{i}") for i in range(n)]
    return FleetRouter(reps, **router_kw), reps


def _md5(arr):
    return hashlib.md5(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _sp(pkg, **kw):
    """A SamplingParams of `pkg` ("ref" or "port")."""
    if pkg == "ref":
        from paddle_tpu.sampling import SamplingParams as JSP

        return JSP(**kw)
    return SamplingParams(**kw)


def _work(pkg):
    """tests/test_fleet.py's WORK, its sampling in `pkg`'s type."""
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


def _ref_run(ref, prompt, n, sampling=None, max_new=16):
    """The reference fleet's uninterrupted run of one prompt."""
    from paddle_tpu.fleet import FleetRouter as JRouter

    router = JRouter([_ref_replica(ref, "ref", max_new_tokens=max_new)])
    router.start()
    try:
        return router.submit(prompt, max_new_tokens=n,
                             sampling=sampling).result(timeout=300)
    finally:
        router.stop()


@pytest.fixture(scope="module")
def ref_hashes(tiny):
    """The reference fleet's uninterrupted run of WORK (one replica)."""
    from paddle_tpu.fleet import FleetRouter as JRouter

    router = JRouter([_ref_replica(tiny[0], "ref")])
    router.start()
    try:
        return [_md5(o) for o in _drive(router, _work("ref"))]
    finally:
        router.stop()


# ---- the health ladder --------------------------------------------------

def _ladder(cls):
    """One scripted run through the state machine: (state, weight,
    backoff, failures, episodes) after every step."""
    h = cls(open_after=2, backoff_base_s=1.0, backoff_cap_s=4.0)
    out = []

    def rec(w=None):
        out.append((h.state, w, h.backoff_s(), h.consecutive_failures,
                    h.open_episodes))

    rec(h.routing_weight(0.0))
    for t in (1.0, 2.0):
        h.note_failure(t)
        rec(h.routing_weight(t))
    for t in (2.5, 3.5, 3.6):
        rec(h.routing_weight(t))
    h.note_failure(3.7)
    rec(h.routing_weight(4.0))
    rec(h.routing_weight(6.0))
    h.note_ok(6.1)
    rec(h.routing_weight(6.2))
    h.note_not_ready(7.0, "draining")
    rec(h.routing_weight(7.0))
    h.note_ok(8.0)
    h.mark_dead("killed")
    h.note_ok(9.0)
    rec(h.routing_weight(9.0))
    out.append(sorted(h.stats()))
    return out


class TestReplicaHealth:
    def test_ok_degraded_open_ladder(self):
        h = ReplicaHealth(open_after=3, backoff_base_s=1.0,
                          backoff_cap_s=8.0)
        assert h.state == "ok" and h.routing_weight(0.0) == 1.0
        h.note_failure(1.0)
        assert h.state == "degraded"
        assert h.routing_weight(1.0) == pytest.approx(0.25)
        h.note_ok(2.0)
        assert h.state == "ok" and h.consecutive_failures == 0
        for t in (3.0, 4.0, 5.0):
            h.note_failure(t)
        assert h.state == "open"
        assert h.routing_weight(5.5) == 0.0

    def test_half_open_single_trial_and_backoff_doubling(self):
        h = ReplicaHealth(open_after=1, backoff_base_s=1.0,
                          backoff_cap_s=8.0)
        h.note_failure(0.0)
        assert h.state == "open" and h.backoff_s() == 1.0
        assert not h.probe_due(0.5)
        assert h.probe_due(1.5)
        w1 = h.routing_weight(1.5)
        assert h.state == "half_open" and 0 < w1 < 1
        assert h.routing_weight(1.6) == 0.0
        h.note_failure(1.7)
        assert h.state == "open" and h.backoff_s() == 2.0
        assert h.routing_weight(2.0) == 0.0
        assert 0 < h.routing_weight(3.8) < 1
        h.note_ok(3.9)
        assert h.state == "ok" and h.routing_weight(4.0) == 1.0
        assert h.open_episodes == 0

    def test_backoff_caps(self):
        h = ReplicaHealth(open_after=1, backoff_base_s=1.0,
                          backoff_cap_s=4.0)
        t = 0.0
        for _ in range(5):
            h.note_failure(t)
            t += 100.0
            h.routing_weight(t)
        assert h.backoff_s() == 4.0

    def test_not_ready_and_dead_are_weight_zero(self):
        h = ReplicaHealth()
        h.note_not_ready(0.0, "draining")
        assert h.state == "not_ready" and h.routing_weight(0.0) == 0.0
        h.note_ok(1.0)
        assert h.state == "ok"
        h.mark_dead("killed")
        assert h.routing_weight(2.0) == 0.0
        h.note_ok(3.0)
        assert h.state == "dead"

    def test_validation(self):
        with pytest.raises(ValueError, match="open_after"):
            ReplicaHealth(open_after=0)
        with pytest.raises(ValueError, match="backoff_cap_s"):
            ReplicaHealth(backoff_base_s=2.0, backoff_cap_s=1.0)

    def test_ladder_equals_the_reference(self):
        from paddle_tpu.fleet import ReplicaHealth as JHealth

        assert _ladder(ReplicaHealth) == _ladder(JHealth)


# ---- federation ---------------------------------------------------------

PROM = "\n".join([
    "# HELP m_total help text",
    "# TYPE m_total counter",
    "m_total 3.0",
    'm_labeled{a="b",c="d"} 1.5',
    'hist_bucket{le="+Inf"} 7',
    'odd{v="q\\"x"} 2',
    "",
])


class TestFederation:
    def test_label_injection_all_sample_shapes(self):
        from paddle_tpu.fleet import add_label_to_prom_text as j_add

        out = add_label_to_prom_text(PROM, "replica", "r0")
        lines = out.splitlines()
        assert 'm_total{replica="r0"} 3.0' in lines
        assert 'm_labeled{replica="r0",a="b",c="d"} 1.5' in lines
        assert 'hist_bucket{replica="r0",le="+Inf"} 7' in lines
        assert lines[0] == "# HELP m_total help text"
        for value in ("r0", 'we"ird\\name'):
            assert add_label_to_prom_text(PROM, "replica", value) == \
                j_add(PROM, "replica", value)

    def test_federate_dedupes_comments_and_survives_dead_source(self):
        from paddle_tpu.fleet import federate_metrics as j_fed

        a = "# TYPE x counter\nx 1"
        b = "# TYPE x counter\nx 2"

        def boom():
            raise OSError("connection refused")

        args = ([("r0", a), ("r1", b), ("r2", boom)],)
        kw = {"extra": "# TYPE fleet_y gauge\nfleet_y 9"}
        page = federate_metrics(*args, **kw)
        assert page.count("# TYPE x counter") == 1
        assert 'x{replica="r0"} 1' in page
        assert 'x{replica="r1"} 2' in page
        assert "# replica r2: unreachable" in page
        assert "fleet_y 9" in page
        assert 'fleet_y{replica=' not in page
        assert page == j_fed(*args, **kw)

    def test_router_metrics_endpoint_is_federated(self, tiny):
        router, reps = _fleet(tiny[1], 2, expose_port=0)
        router.start()
        try:
            _drive(router, WORK[:2])
            url = router.exporter.url
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                page = r.read().decode()
            assert 'replica="r0"' in page
            assert 'replica="r1"' in page
            assert "fleet_requests_total" in page
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                h = json.loads(r.read().decode())
            assert h["status"] == "ok"
            assert h["routable"] == 2
        finally:
            router.stop()


# ---- the KV wire format -------------------------------------------------

def _mirrored_payloads(kv_dtype):
    """(reference payload, port payload) of the same 10-token chain (2
    full blocks and a fill-2 tail) in two pools holding the same
    contents."""
    from torch_twin_util import PoolMirror, assert_payloads_equal

    m = PoolMirror(shape=(2, 2, 4), num_blocks=8, block_size=4,
                   kv_dtype=kv_dtype, seed=3)
    ids = np.arange(1, 11, dtype=np.int32)
    m.allocate("s", 10)
    m.write("s", 0)
    m.publish_prefix("s", ids)
    pj, pt = m.ref.export_prefix(ids), m.port.export_prefix(ids)
    assert_payloads_equal(pj, pt)
    return ids, pj, pt


def _leaves(x):
    return (x.codes, x.scales) if hasattr(x, "codes") else (x,)


def _assert_blocks_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if key in ("k", "v"):
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                for u, w in zip(_leaves(x), _leaves(y)):
                    np.testing.assert_array_equal(np.asarray(u),
                                                  np.asarray(w))
        else:
            assert a[key] == b[key], key


class TestKVWireFormat:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_payload_bytes_roundtrip(self, kv_dtype):
        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        a = PagedKVCache(2, 2, 4, block_size=4, num_blocks=8,
                         kv_dtype=kv_dtype, device="cpu")
        b = PagedKVCache(2, 2, 4, block_size=4, num_blocks=8,
                         kv_dtype=kv_dtype, device="cpu")
        ids = np.arange(1, 11, dtype=np.int32)
        a.allocate("s", 10)
        a.publish_prefix("s", ids)
        payload = a.export_prefix(ids)
        wire = serialize_kv_payload(payload)
        assert isinstance(wire, bytes) and len(wire) > 0
        back = deserialize_kv_payload(wire)
        assert back["fills"] == payload["fills"] == [4, 4, 2]
        assert b.import_prefix(back) == 10
        assert b.match_prefix_len(ids) == 9
        assert serialize_kv_payload(None) == b""
        assert deserialize_kv_payload(b"") is None

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_wire_bytes_equal_the_reference(self, kv_dtype):
        """Equal pools serialize to equal bytes in both packages, and
        each package's bytes decode in the other to the arrays its own
        decoder gives: the dense payload's int8 codes and scales, the
        int8 payload bit for bit."""
        from paddle_tpu.fleet import deserialize_kv_payload as j_de
        from paddle_tpu.fleet import serialize_kv_payload as j_ser

        _ids, pj, pt = _mirrored_payloads(kv_dtype)
        wj, wt = j_ser(pj), serialize_kv_payload(pt)
        assert wj == wt
        for wire in (wj, wt):
            _assert_blocks_equal(deserialize_kv_payload(wire), j_de(wire))
        if kv_dtype == "int8":
            _assert_blocks_equal(deserialize_kv_payload(wj), pj)
        raw_j = j_ser(pj, wire_compress=False)
        assert raw_j == serialize_kv_payload(pt, wire_compress=False)
        _assert_blocks_equal(deserialize_kv_payload(raw_j), pt)
        _assert_blocks_equal(j_de(serialize_kv_payload(
            pt, wire_compress=False)), pj)

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_cross_package_import_serves_the_chain(self, kv_dtype):
        """A reference payload imported into the port's pool (and the
        port's into the reference's) registers the same chain with the
        same block contents as the package's own payload."""
        from paddle_tpu.fleet import deserialize_kv_payload as j_de
        from paddle_tpu.fleet import serialize_kv_payload as j_ser
        from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        ids, pj, pt = _mirrored_payloads(kv_dtype)
        tp = PagedKVCache(2, 2, 4, block_size=4, num_blocks=8,
                          kv_dtype=kv_dtype, device="cpu")
        jp = JCache(2, 2, 4, block_size=4, num_blocks=8, kv_dtype=kv_dtype)
        assert tp.import_prefix(deserialize_kv_payload(j_ser(pj))) == 10
        assert jp.import_prefix(j_de(serialize_kv_payload(pt))) == 10
        assert tp.match_prefix_len(ids) == jp.match_prefix_len(ids) == 9
        _assert_blocks_equal(tp.export_prefix(ids), jp.export_prefix(ids))

    def test_import_rejects_layout_mismatch(self):
        from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        a = PagedKVCache(2, 2, 4, block_size=4, num_blocks=8, device="cpu")
        b = PagedKVCache(2, 2, 4, block_size=8, num_blocks=8, device="cpu")
        ids = np.arange(1, 9, dtype=np.int32)
        a.allocate("s", 8)
        a.publish_prefix("s", ids)
        with pytest.raises(ValueError, match="block_size"):
            b.import_prefix(a.export_prefix(ids))
        j = JCache(2, 2, 4, block_size=4, num_blocks=8, kv_dtype="int8")
        j.allocate("s", 8)
        j.publish_prefix("s", ids)
        with pytest.raises(ValueError, match="kv_dtype"):
            a.import_prefix(deserialize_kv_payload(
                serialize_kv_payload(j.export_prefix(ids))))

    def test_match_prefix_len_is_side_effect_free(self):
        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        c = PagedKVCache(2, 2, 4, block_size=4, num_blocks=8, device="cpu")
        ids = np.arange(1, 9, dtype=np.int32)
        c.allocate("s", 8)
        c.publish_prefix("s", ids)
        s0 = c.stats()["prefix_cache"]
        assert c.match_prefix_len(ids) == 7
        assert c.match_prefix_len(np.array([99, 98], np.int32)) == 0
        assert c.stats()["prefix_cache"] == s0


class TestStreamRebind:
    def test_rebind_ignores_stale_future_and_continues(self):
        from concurrent.futures import Future

        from paddle_tpu_torch.frontend.stream import StreamHandle

        h = StreamHandle()
        f1, f2 = Future(), Future()
        h._bind(f1)
        h._on_token(11, None)
        h.rebind(f2)
        f1.set_exception(RuntimeError("replica died"))
        assert not h.done
        h._on_token(12, None)
        h._on_token(13, "budget")
        f2.set_result(np.array([11, 12, 13], np.int32))
        assert h.done and h.stop_reason == "budget"
        assert h.tokens == [11, 12, 13]
        np.testing.assert_array_equal(h.result(timeout=1), [11, 12, 13])

    def test_streamed_session_survives_a_kill(self, tiny):
        """A stream=True session whose replica is killed keeps streaming
        from the survivor: its tokens are the reference's run."""
        prompt = np.array([3, 5, 7, 9], np.int32)
        ref = _ref_run(tiny[0], prompt, 8, max_new=8)
        router, reps = _fleet(tiny[1], 2, probe_interval_s=30.0)
        router.start()
        try:
            first = threading.Event()
            h = router.submit(prompt, stream=True,
                              on_token=lambda t, r: first.set())
            assert first.wait(timeout=120)
            rid = next(iter(router._sessions))
            router._kill_replica(router._sessions[rid].replica)
            out = h.result(timeout=300)
            st = router.stats()
        finally:
            router.stop()
        np.testing.assert_array_equal(out, ref)
        assert st["failover_sessions"] >= 1


# ---- placement ----------------------------------------------------------

class TestPlacement:
    def test_prefix_aware_with_least_loaded_tiebreak(self, tiny):
        router, reps = _fleet(tiny[1], 2)
        router.start()
        try:
            shared = np.array([4, 2, 4, 2, 4, 2, 4, 2, 4], np.int32)
            router.submit(shared).result(timeout=300)
            first = next(r for r in reps if r.prefix_match_len(shared) > 0)
            for _ in range(2):
                rep, match = router._place(shared)
                assert rep is first and match > 0
            assert router.stats()["prefix_routed"] >= 0
            rep, match = router._place(np.array([9, 9, 9], np.int32))
            assert match == 0 and rep is reps[0]
        finally:
            router.stop()

    def test_draining_replica_is_not_routed_sessions_stay(self, tiny):
        router, reps = _fleet(tiny[1], 2, probe_interval_s=30.0)
        router.start()
        try:
            reps[0].server.set_draining(True)
            router.check_replicas()
            assert reps[0].health.state == "not_ready"
            rep, _ = router._place(np.array([1, 2, 3], np.int32))
            assert rep is reps[1]
            out = router.submit(
                np.array([5, 6, 7], np.int32)).result(timeout=300)
            assert list(out[:3]) == [5, 6, 7]
            assert router.stats()["failovers"] == 0
            reps[0].server.set_draining(False)
            router.check_replicas()
            assert reps[0].health.state == "ok"
        finally:
            router.stop()

    def test_global_shed_when_all_replicas_saturated(self, tiny):
        router, reps = _fleet(tiny[1], 2, shed_queue_depth=1)
        for rep in reps:
            for _ in range(2):
                rep.server.submit([1, 2, 3])
        with pytest.raises(AdmissionShed) as ei:
            router._started = True  # submit without engines
            router.submit(np.array([4, 5, 6], np.int32))
        assert ei.value.retry_after_s > 0
        assert router.stats()["sheds"] == 1
        for rep in reps:
            rep.server.stop()

    def test_no_routable_replica_raises(self, tiny):
        router, reps = _fleet(tiny[1], 1)
        router.start()
        try:
            reps[0].kill()
            with pytest.raises(ReplicaUnavailable):
                router.submit(np.array([1, 2], np.int32))
        finally:
            router.stop()


# ---- the chaos gate -----------------------------------------------------

class TestChaosGate:
    @pytest.mark.parametrize("n_replicas", [2, 4])
    def test_mid_stream_replica_kill_survivor_parity(self, tiny,
                                                     ref_hashes,
                                                     n_replicas):
        """Kill at placement n_replicas: the first n placements gave each
        replica a resident, so the victim holds a mid-stream session."""
        plan = FaultPlan([("replica_kill", n_replicas)], name="chaos-kill")
        router, reps = _fleet(tiny[1], n_replicas, fault_plan=plan,
                              probe_interval_s=0.2)
        router.start()
        try:
            outs = _drive(router)
            st = router.stats()
        finally:
            router.stop()
        assert [_md5(o) for o in outs] == ref_hashes
        assert st["replica_kills"] == 1
        assert sum(1 for r in reps if r.dead) == 1
        assert st["failover_sessions"] >= 1
        assert st["failovers"] >= 1

    def test_externally_killed_replica_fails_over_via_probe(self, tiny,
                                                            ref_hashes):
        """No fault plan: the replica dies behind the router's back and
        the probe loop finds it and fails its sessions over."""
        router, reps = _fleet(tiny[1], 2, probe_interval_s=0.05)
        router.start()
        try:
            seen = []
            futs = [router.submit(ids, on_token=(
                lambda t, r: seen.append(t)) if i == 0 else None, **kw)
                for i, (ids, kw) in enumerate(WORK)]
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not seen:
                time.sleep(0.002)
            victim = router._sessions[sorted(router._sessions)[0]].replica
            victim.server.kill()
            outs = [f.result(timeout=300) for f in futs]
            st = router.stats()
        finally:
            router.stop()
        assert [_md5(o) for o in outs] == ref_hashes
        assert st["failover_sessions"] >= 1

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_planned_migration_zero_prefill_recompute(self, tiny,
                                                      kv_dtype):
        prompt = np.array([3, 5, 7, 9, 11, 2], np.int32)
        ref = _ref_run(tiny[0], prompt, 20, max_new=24) \
            if kv_dtype is None else None
        if kv_dtype == "int8":
            from paddle_tpu.fleet import FleetRouter as JRouter

            jr = JRouter([_ref_replica(tiny[0], "ref", max_new_tokens=24,
                                       kv_dtype="int8")]).start()
            try:
                ref = jr.submit(prompt, max_new_tokens=20).result(
                    timeout=300)
            finally:
                jr.stop()
        reps = [_replica(tiny[1], f"r{i}", max_new_tokens=24,
                         kv_dtype=kv_dtype) for i in range(2)]
        router = FleetRouter(reps)
        router.start()
        try:
            first = threading.Event()
            fut = router.submit(prompt, max_new_tokens=20,
                                on_token=lambda t, r: first.set())
            assert first.wait(timeout=120)
            rid = next(iter(router._sessions))
            source = router._sessions[rid].replica
            before = {r.name: r.server.stats()["prefills"] for r in reps}
            target_name = router.migrate_session(rid)
            out = fut.result(timeout=300)
            st = router.stats()
            target = next(r for r in reps if r.name == target_name)
            after = target.server.stats()
        finally:
            router.stop()
        assert target_name != source.name
        np.testing.assert_array_equal(ref, out)
        assert st["migrations"] == 1
        assert after["prefills"] - before[target_name] == 0
        assert after["frontdoor"]["resumes"] >= 1

    def test_migration_fallback_when_source_dead(self, tiny):
        """migrate_session on a dead source falls back to journal replay:
        still the reference's tokens, re-prefilled."""
        prompt = np.array([4, 4, 2, 9], np.int32)
        ref = _ref_run(tiny[0], prompt, 12)
        reps = [_replica(tiny[1], f"r{i}", max_new_tokens=16)
                for i in range(2)]
        router = FleetRouter(reps, probe_interval_s=30.0)
        router.start()
        try:
            first = threading.Event()
            fut = router.submit(prompt, max_new_tokens=12,
                                on_token=lambda t, r: first.set())
            assert first.wait(timeout=120)
            rid = next(iter(router._sessions))
            source = router._sessions[rid].replica
            source.kill()
            target = router.migrate_session(rid)
            out = fut.result(timeout=300)
            st = router.stats()
        finally:
            router.stop()
        assert target != source.name
        np.testing.assert_array_equal(ref, out)
        assert st["migrations"] == 1
        assert st["failover_sessions"] == 1


class TestRouterJournalRecovery:
    def test_router_restart_recovers_sessions_token_identically(
            self, tiny, tmp_path):
        prompt = np.array([3, 5, 7, 9, 11, 2], np.int32)
        ref = _ref_run(tiny[0], prompt, 16, _sp("ref", temperature=0.9,
                                               top_p=0.95, seed=55))
        sp = SamplingParams(temperature=0.9, top_p=0.95, seed=55)
        jp = tmp_path / "fleet.jsonl"
        reps = [_replica(tiny[1], "jr0", max_new_tokens=16)]
        # the dead replica must not be noticed before the router's own
        # "crash" (the router is abandoned unstopped)
        router = FleetRouter(reps, journal=str(jp), probe_interval_s=300.0)
        router.start()
        first = threading.Event()
        fut = router.submit(prompt, max_new_tokens=16, sampling=sp,
                            on_token=lambda t, r: first.set())
        assert first.wait(timeout=120)
        reps[0].kill()
        del fut
        router._stop = True  # silence its probe thread
        jr = FleetRouter([_replica(tiny[1], "n0", max_new_tokens=16),
                          _replica(tiny[1], "n1", max_new_tokens=16)],
                         journal=str(jp))
        jr.start()
        try:
            recovered = jr.recover_from_journal()
            assert len(recovered) == 1
            (out,) = [f.result(timeout=300) for f in recovered.values()]
        finally:
            jr.stop()
        np.testing.assert_array_equal(ref, out)

    def test_reference_router_journal_recovers_on_the_port(self, tiny,
                                                           tmp_path):
        """A journal the reference's router left behind is recovered by
        the port's router into the reference's uninterrupted tokens."""
        from paddle_tpu.fleet import FleetRouter as JRouter

        prompt = np.array([8, 1, 8, 2, 8], np.int32)
        spj = _sp("ref", temperature=0.8, top_k=40, seed=9)
        ref = _ref_run(tiny[0], prompt, 16, spj)
        jp = tmp_path / "ref-fleet.jsonl"
        reps = [_ref_replica(tiny[0], "j0", max_new_tokens=16)]
        router = JRouter(reps, journal=str(jp), probe_interval_s=300.0)
        router.start()
        first = threading.Event()
        router.submit(prompt, max_new_tokens=16, sampling=spj,
                      on_token=lambda t, r: first.set())
        assert first.wait(timeout=120)
        reps[0].kill()
        router._stop = True
        router._journal.flush()
        port = FleetRouter([_replica(tiny[1], "p0", max_new_tokens=16)],
                           journal=str(jp))
        port.start()
        try:
            recovered = port.recover_from_journal()
            assert len(recovered) == 1
            (out,) = [f.result(timeout=300) for f in recovered.values()]
        finally:
            port.stop()
        np.testing.assert_array_equal(ref, out)
