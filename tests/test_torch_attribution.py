"""The port's per-tenant cost attribution (paddle_tpu_torch/observability/
attribution.py, the pool's block ownership and both servers' ledgers) on
the CPU: twins of tests/test_attribution.py.

The ledger is host Python with an explicit integer clock: every
scenario runs on the reference's module and the port's and must give
the same numbers. The served cases hold the port's servers to exact
conservation: per-tenant device-ns equals the engine's busy-ns and
per-tenant block-ns the pool's occupancy integral, with the split, the
unified and the async rounds (the reference's sharded wire case waits
for sharding, ROADMAP §A 11: one engine moves no wire bytes)."""
import importlib
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from paddle_tpu_torch.observability.attribution import (  # noqa: E402
    ResourceLedger, apportion, disabled_attribution_stats)

REF = importlib.import_module("paddle_tpu.observability.attribution")
PORT = importlib.import_module("paddle_tpu_torch.observability.attribution")


@pytest.fixture(scope="module")
def tiny():
    from torch_twin_util import reference_tiny_model

    ref, cfg, port, _tcfg = reference_tiny_model(5)
    return ref, cfg, port


class FakeClock:
    """Explicit integer-ns clock."""

    def __init__(self):
        self.t = 0

    def advance(self, dt_ns):
        self.t += int(dt_ns)

    def __call__(self):
        return self.t


def _both(fn):
    want, have = fn(REF), fn(PORT)
    assert have == want, (have, want)
    return have


class TestApportion:
    def test_conserves_exactly_fuzz(self):
        rs = np.random.RandomState(1217)
        for _ in range(500):
            n = int(rs.randint(1, 9))
            total = int(rs.randint(0, 10**12))
            ws = [int(w) for w in rs.randint(0, 100, n)]
            shares = apportion(total, ws)
            assert shares == REF.apportion(total, ws)
            assert sum(shares) == total, (total, ws, shares)
            assert all(s >= 0 for s in shares)

    def test_proportional_when_divisible(self):
        assert _both(lambda m: (m.apportion(1000, [1, 3]),
                                m.apportion(6, [1, 1, 1]))) == \
            ([250, 750], [2, 2, 2])

    def test_zero_weights_even_split(self):
        assert _both(lambda m: m.apportion(10, [0, 0, 0, 0])) == \
            [3, 3, 2, 2]

    def test_empty_and_deterministic(self):
        assert _both(lambda m: (m.apportion(5, []),
                                m.apportion(7, [2, 1]))) == \
            ([], apportion(7, [2, 1]))


class TestLedgerConservation:
    def test_device_charges_conserve(self):
        def run(m):
            led = m.ResourceLedger(clock_ns=FakeClock())
            rs = np.random.RandomState(7)
            charged = 0
            for i in range(200):
                n = int(rs.randint(1, 5))
                parts = [(f"t{rs.randint(3)}", f"r{i}-{j}",
                          int(rs.randint(0, 50))) for j in range(n)]
                dur = int(rs.randint(1, 10**9))
                led.charge_device(dur, parts)
                charged += dur
            return charged, led.stats()

        charged, st = _both(run)
        assert st["totals"]["busy_ns"] == charged
        assert st["conservation"]["device_residual_ns"] == 0
        assert sum(a["device_ns"] for a in st["tenants"].values()) \
            == charged

    def test_block_seconds_fuzzer_matches_occupancy_integral(self):
        def run(m):
            clk = FakeClock()
            led = m.ResourceLedger(clock_ns=clk)
            rs = np.random.RandomState(42)
            owned = {}
            expected = 0
            for _ in range(400):
                dt = int(rs.randint(0, 10**7))
                expected += sum(owned.values()) * dt
                clk.advance(dt)
                t = f"tenant{rs.randint(4)}"
                if owned.get(t, 0) > 0 and rs.rand() < 0.45:
                    led.block_event(t, None, -1)
                    owned[t] -= 1
                else:
                    led.block_event(t, None, +1)
                    owned[t] = owned.get(t, 0) + 1
            dt = int(rs.randint(1, 10**7))
            expected += sum(owned.values()) * dt
            clk.advance(dt)
            return expected, led.stats()

        expected, st = _both(run)
        assert st["totals"]["occupancy_block_ns"] == expected
        assert st["conservation"]["block_residual_ns"] == 0
        assert sum(a["kv_block_ns"] for a in st["tenants"].values()) \
            == expected

    def test_host_byte_seconds_integrate(self):
        def run(m):
            clk = FakeClock()
            led = m.ResourceLedger(clock_ns=clk)
            led.host_bytes_event("a", 1000)
            clk.advance(5)
            led.host_bytes_event("b", 500)
            clk.advance(10)
            return led.stats()

        st = _both(run)
        assert st["tenants"]["a"]["host_byte_ns"] == 1000 * 15
        assert st["tenants"]["b"]["host_byte_ns"] == 500 * 10
        assert st["conservation"]["host_residual_byte_ns"] == 0

    def test_wire_and_compile_conserve(self):
        def run(m):
            led = m.ResourceLedger(clock_ns=FakeClock())
            parts = [("a", "r1", 3), ("b", "r2", 1)]
            led.charge_wire(1001, parts, kind="collective")
            led.charge_wire(77, parts, kind="migration")
            led.charge_compile(999, parts)
            return led.stats()

        st = _both(run)
        assert st["conservation"]["wire_residual_bytes"] == 0
        assert st["conservation"]["compile_residual_ns"] == 0
        assert st["totals"]["wire_bytes"] == 1001 + 77
        assert st["tenants"]["a"]["wire_bytes"] \
            + st["tenants"]["b"]["wire_bytes"] == 1001
        assert st["tenants"]["a"]["wire_migration_bytes"] \
            + st["tenants"]["b"]["wire_migration_bytes"] == 77

    def test_reset_carries_occupancy_levels_forward(self):
        def run(m):
            clk = FakeClock()
            led = m.ResourceLedger(clock_ns=clk)
            led.block_event("a", None, +1)
            led.block_event("a", None, +1)
            clk.advance(100)
            led.reset()
            s0 = led.stats()
            clk.advance(50)
            return s0, led.stats()

        s0, st = _both(run)
        assert s0["totals"]["occupancy_block_ns"] == 0
        assert s0["tenants"] == {}
        assert st["totals"]["occupancy_block_ns"] == 2 * 50
        assert st["tenants"]["a"]["kv_block_ns"] == 2 * 50
        assert st["conservation"]["block_residual_ns"] == 0

    def test_request_lifecycle_cost_dict_idempotent(self):
        def run(m):
            clk = FakeClock()
            led = m.ResourceLedger(clock_ns=clk)
            led.request_begin("r1", "acme")
            led.block_event("acme", "r1", +1)
            clk.advance(10)
            led.charge_device(1000, [("acme", "r1", 4)])
            cost = led.request_done("r1", new_tokens=4)
            again = led.request_done("r1")
            led.charge_device(500, [("acme", "r1", 1)])
            return cost, again, led.stats()

        cost, again, st = _both(run)
        assert cost["tenant"] == "acme"
        assert cost["device_ns"] == 1000 and cost["block_ns"] == 10
        assert again is None
        assert st["tenants"]["acme"]["device_ns"] == 1500
        assert st["conservation"]["device_residual_ns"] == 0

    def test_prefix_credit_uses_measured_prefill_cost(self):
        def run(m):
            led = m.ResourceLedger(clock_ns=FakeClock())
            led.note_prefill_cost(64_000, 64)
            led.request_begin("r1", "acme")
            led.credit_prefix("acme", "r1", 10)
            return led.stats(), led.request_done("r1")

        st, cost = _both(run)
        assert st["tenants"]["acme"]["prefix_saved_tokens"] == 10
        assert st["totals"]["prefill_cost_ns_per_token"] == 1000.0
        assert cost["prefix_saved_tokens"] == 10
        assert cost["prefix_saved_ns"] == 10_000


class TestStatsCongruence:
    def test_disabled_schema_matches_enabled_schema(self):
        led = ResourceLedger(clock_ns=FakeClock())
        led.charge_device(10, [("a", "r", 1)])
        on, off = led.stats(), disabled_attribution_stats()
        assert off == REF.disabled_attribution_stats()
        assert set(on) == set(off)
        assert set(on["totals"]) == set(off["totals"])
        assert set(on["conservation"]) == set(off["conservation"])
        assert off["enabled"] is False and off["tenants"] == {}
        assert not any(off["totals"].values())

    def test_dense_and_paged_servers_same_schema(self, tiny):
        from paddle_tpu_torch.inference import (GenerationServer,
                                                PagedGenerationServer)

        _ref, cfg, port = tiny

        def prog(ids, seed, temp, eos, top_p, pad):
            return port.generate(
                torch.from_numpy(np.asarray(ids)), 3,
                temperature=float(temp), seed=int(seed),
                eos_token_id=None if int(eos) < 0 else int(eos),
                top_p=float(top_p),
                pad_token_id=None if int(pad) < 0 else int(pad)).numpy()

        rs = np.random.RandomState(3)
        prompt = rs.randint(1, cfg.vocab_size, (6,)).astype(np.int32)
        dense = GenerationServer(prog, batch_size=2, prompt_len=8,
                                 pad_token_id=0, max_wait_ms=1.0,
                                 attribution=True).start()
        paged = PagedGenerationServer(port, max_slots=2, block_size=4,
                                      max_prompt_len=16, max_new_tokens=3,
                                      attribution=True,
                                      device="cpu").start()
        try:
            dense.submit(prompt, tenant="acme").result(timeout=300)
            paged.submit(prompt).result(timeout=300)
            da = dense.stats()["attribution"]
            pa = paged.stats()["attribution"]
            assert set(da) == set(pa) == set(disabled_attribution_stats())
            for blk in ("totals", "conservation"):
                assert set(da[blk]) == set(pa[blk])
            assert da["enabled"] is pa["enabled"] is True
            assert da["tenants"]["acme"]["requests"] == 1
            assert da["totals"]["busy_ns"] \
                == da["tenants"]["acme"]["device_ns"] > 0
            assert pa["tenants"]["default"]["requests"] == 1
            assert pa["tenants"]["default"]["device_ns"] > 0
            assert pa["tenants"]["default"]["kv_block_ns"] > 0
            assert dense.cost_report()["tenants"]["acme"]["requests"] == 1
            dense.reset_stats()
            paged.reset_stats()
            da = dense.stats()["attribution"]
            pa = paged.stats()["attribution"]
            assert da["totals"]["busy_ns"] == 0
            assert pa["totals"]["busy_ns"] == 0
            assert pa["conservation"]["block_residual_ns"] == 0
            off = PagedGenerationServer(port, max_slots=1, block_size=4,
                                        max_prompt_len=16,
                                        max_new_tokens=2, device="cpu")
            assert off.stats()["attribution"] == \
                disabled_attribution_stats()
            assert off.cost_report() is None
        finally:
            dense.stop()
            paged.stop()


def _composed(port, cfg, **kw):
    """Six requests over a shared prefix, three tenants and both lanes
    on a 2-slot front door with prefix caching and attribution: the
    front door's stats and its cost report."""
    from paddle_tpu_torch.frontend import FrontDoor

    rs = np.random.RandomState(17)
    shared = rs.randint(1, cfg.vocab_size, (8,)).astype(np.int32)
    fd = FrontDoor(port, max_slots=2, block_size=4, max_prompt_len=32,
                   max_new_tokens=4, attribution=True, device="cpu", **kw)
    fd.start()
    try:
        handles = []
        for i in range(6):
            tail = rs.randint(1, cfg.vocab_size, (int(rs.randint(2, 6)),))
            ids = np.concatenate([shared, tail.astype(np.int32)])
            handles.append(fd.submit(
                ids, lane="batch" if i % 2 else "interactive",
                tenant=("free", "pro", "enterprise")[i % 3]))
        for h in handles:
            h.result(timeout=300)
        return fd.stats(), fd.cost_report()
    finally:
        fd.stop()


def _assert_conserved(st):
    attr = st["attribution"]
    assert attr["enabled"] is True
    assert set(attr["tenants"]) == {"free", "pro", "enterprise"}
    cons = attr["conservation"]
    assert cons == {"device_residual_ns": 0, "block_residual_ns": 0,
                    "host_residual_byte_ns": 0, "wire_residual_bytes": 0,
                    "compile_residual_ns": 0}, cons
    assert attr["totals"]["busy_ns"] == sum(
        a["device_ns"] for a in attr["tenants"].values()) > 0
    assert attr["totals"]["occupancy_block_ns"] == sum(
        a["kv_block_ns"] for a in attr["tenants"].values()) > 0
    assert attr["totals"]["wire_bytes"] == 0
    for a in attr["tenants"].values():
        assert a["requests"] == 2 and a["device_ns"] > 0


class TestEngineConservation:
    def test_composed_stack_conservation(self, tiny):
        """Prefix cache + speculation + three tenants through the front
        door: exact conservation, credited prefix savings and the billing
        export's round trip."""
        _ref, cfg, port = tiny
        st, rep = _composed(port, cfg, speculation=True)
        _assert_conserved(st)
        attr = st["attribution"]
        assert sum(a["prefix_saved_tokens"]
                   for a in attr["tenants"].values()) > 0
        assert rep["schema_version"] == 1
        back = json.loads(rep.to_json())
        assert set(back["tenants"]) == set(attr["tenants"])
        assert back["tenants"]["pro"]["requests"] == 2

    @pytest.mark.parametrize("engine", ["unified", "async"])
    def test_unified_and_async_rounds_conserve(self, tiny, engine):
        """The async round charges its dispatch and, one round later,
        its wait for the outputs to the rows it planned, even when a
        slot was freed and refilled in between: device-ns over tenants
        still equals busy-ns exactly."""
        _ref, cfg, port = tiny
        kw = ({"unified_round": True} if engine == "unified"
              else {"async_rounds": True})
        st, _rep = _composed(port, cfg, **kw)
        _assert_conserved(st)

    def test_request_done_cost_reaches_trace_assembler(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.observability import tracing as T

        _ref, cfg, port = tiny
        T.TRACER.reset()
        T.enable()
        try:
            srv = PagedGenerationServer(port, max_slots=1, block_size=4,
                                        max_prompt_len=16,
                                        max_new_tokens=3,
                                        attribution=True,
                                        device="cpu").start()
            try:
                rs = np.random.RandomState(9)
                p = rs.randint(1, cfg.vocab_size, (5,)).astype(np.int32)
                srv.submit(p).result(timeout=300)
            finally:
                srv.stop()
            traces = T.assemble_request_traces(T.events())
            assert traces
            rec = next(iter(traces.values()))
            cost = rec.get("cost")
            assert cost is not None, rec
            assert cost["tenant"] == "default"
            assert cost["device_ns"] > 0
        finally:
            T.disable()
            T.TRACER.reset()
