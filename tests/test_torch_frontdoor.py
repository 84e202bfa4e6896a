"""The port's serving front door (paddle_tpu_torch/frontend and the
PagedGenerationServer's scheduler seams) on the CPU: twins of
tests/test_frontdoor.py.

  * The host-side policy (DeltaAssembler, StreamHandle, TokenBucket,
    TenantConfig, LaneScheduler) runs the same scenario in both
    packages under one fake clock and must make the same decisions.
  * The serving cases run the port's FrontDoor on GPT-2 tiny with the
    reference's float32 weights and compare tokens with the reference's
    FrontDoor (or its `generate`) on those weights.
  * Preemption is made deterministic by an on_token callback that holds
    the engine at the victim's second token until the interactive
    request is queued: nothing here leans on a wall-clock margin.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_twin_util import hold_at

torch.set_num_threads(1)

PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _fe(pkg):
    import importlib

    return importlib.import_module(pkg + ".frontend")


@pytest.fixture(scope="module")
def tiny():
    """(reference GPT2, its config, the port's GPT2 with the same float32
    weights)."""
    from torch_twin_util import reference_tiny_model

    ref, cfg, port, _tcfg = reference_tiny_model(11)
    return ref, cfg, port


def _detok(toks):
    """Prefix-stable toy detokenizer: every token renders [id]."""
    return "".join(f"[{int(t)}]" for t in toks)


def _both(fn):
    """fn(frontend module) in both packages: asserts the port's result
    equals the reference's and returns it."""
    want = fn(_fe(PKGS[0]))
    have = fn(_fe(PKGS[1]))
    assert have == want, (have, want)
    return have


# ---- streaming --------------------------------------------------------------

class TestDeltaAssembler:
    def test_deltas_concatenate_to_full_text(self):
        def run(fe):
            asm = fe.DeltaAssembler(_detok, tail_tokens=4)
            toks = [3, 14, 159, 2, 65, 35]
            return ([asm.push(t) for t in toks], asm.finish("budget"))

        deltas, tail = _both(run)
        assert "".join(deltas) + tail == _detok([3, 14, 159, 2, 65, 35])

    def test_holdback_never_releases_stop_prefix(self):
        stop = "[7][8][9]"

        def run(fe):
            asm = fe.DeltaAssembler(_detok, stop_strings=(stop,),
                                    tail_tokens=8)
            return ([asm.push(t) for t in (1, 7, 8, 2, 7, 8)],
                    asm.finish("budget"))

        deltas, tail = _both(run)
        released = ""
        for d in deltas:
            released += d
            for ln in range(1, len(stop)):
                assert not released.endswith(stop[:ln]), released
            assert stop not in released
        assert released + tail == _detok([1, 7, 8, 2, 7, 8])

    def test_completed_stop_string_is_suppressed(self):
        stop = "[8][9]"

        def run(fe):
            asm = fe.DeltaAssembler(_detok, stop_strings=(stop,),
                                    tail_tokens=8)
            return ("".join(asm.push(t) for t in (1, 2, 8, 9))
                    + asm.finish("stop_string"))

        assert _both(run) == _detok([1, 2])

    def test_text_after_stop_match_is_suppressed_too(self):
        def run(fe):
            asm = fe.DeltaAssembler(
                lambda ts: "".join(chr(int(t)) for t in ts),
                stop_strings=("XY",), tail_tokens=8)
            return ("".join(asm.push(t) for t in
                            (ord("a"), ord("X"), ord("Y"), ord("b")))
                    + asm.finish("stop_string"))

        assert _both(run) == "a"


class TestStreamHandle:
    def test_backpressure_coalesces_without_loss(self):
        def run(fe):
            h = fe.StreamHandle(max_buffered=2)
            for t in range(9):
                h._on_token(t, None)
            h._on_token(9, "budget")
            evs = list(h)
            return ([(list(ev.token_ids), ev.done, ev.stop_reason)
                     for ev in evs], h.coalesced, h.stop_reason)

        evs, coalesced, reason = _both(run)
        assert len(evs) <= 2
        assert [t for ids, _, _ in evs for t in ids] == list(range(10))
        assert coalesced == 8
        assert evs[-1][1] and evs[-1][2] == "budget"
        assert reason == "budget"


# ---- tenancy ----------------------------------------------------------------

class TestTenancy:
    def test_token_bucket_is_deterministic(self):
        def run(fe):
            b = fe.TokenBucket(rate=10.0, burst=20.0)
            out = [b.affords(15, now=0.0)]
            b.charge(15, now=0.0)
            out += [b.affords(10, now=0.0), b.affords(10, now=0.5)]
            b.charge(10, now=0.5)
            return out + [b.level]

        assert _both(run) == [True, False, True, 0.0]

    def test_oversized_cost_runs_on_debt_not_starvation(self):
        def run(fe):
            b = fe.TokenBucket(rate=10.0, burst=20.0)
            out = [b.affords(100, now=0.0)]
            b.charge(100, now=0.0)
            return out + [b.level, b.affords(1, now=1.0),
                          b.affords(1, now=8.1)]

        assert _both(run) == [True, -80.0, False, True]

    def test_tenant_config_validation(self):
        def run(fe):
            msgs = []
            for kw in ({"weight": 0}, {"rate_tokens_per_s": -1},
                       {"max_queued": 0}):
                with pytest.raises(ValueError) as ei:
                    fe.TenantConfig(**kw)
                msgs.append(str(ei.value))
            return msgs

        msgs = _both(run)
        for m, key in zip(msgs, ("weight", "rate_tokens_per_s",
                                 "max_queued")):
            assert key in m


# ---- the lane scheduler -------------------------------------------------------

def _fake_req(fe, name, lane="interactive", tenant="default",
              deadline=None, t_submit=0.0, cost=10):
    return SimpleNamespace(
        name=name,
        meta=fe.RequestMeta(lane=lane, tenant=tenant, deadline_s=deadline,
                            cost=cost),
        t_submit=t_submit, ids=np.zeros(4, np.int32), budget=4)


def _names(reqs):
    return [r.name for r in reqs]


class TestLaneScheduler:
    def test_edf_within_interactive_lane(self):
        def run(fe):
            s = fe.LaneScheduler()
            for r in (_fake_req(fe, "late", deadline=9.0, t_submit=0.0),
                      _fake_req(fe, "soon", deadline=1.0, t_submit=0.1,
                                tenant="other"),
                      _fake_req(fe, "undated", t_submit=-1.0,
                                tenant="third")):
                s.on_submit(r, 0.2)
            order = []
            for _ in range(3):
                r = s.next_request(0.2)
                order.append(r.name)
                s.pop(r, 0.2)
            return order

        assert _both(run) == ["soon", "late", "undated"]

    def test_lane_weights_interleave_without_starvation(self):
        def run(fe):
            s = fe.LaneScheduler()  # default 4:1 interactive:batch
            for k in range(10):
                s.on_submit(_fake_req(fe, f"i{k}", lane="interactive",
                                      t_submit=float(k)), 0.0)
                s.on_submit(_fake_req(fe, f"b{k}", lane="batch",
                                      t_submit=float(k)), 0.0)
            order = []
            for _ in range(10):
                r = s.next_request(0.0)
                order.append(r.name)
                s.pop(r, 0.0)
            return order

        order = _both(run)
        assert sum(n.startswith("b") for n in order) == 2
        assert sum(n.startswith("i") for n in order) == 8

    def test_tenant_fair_share_by_weight(self):
        def run(fe):
            s = fe.LaneScheduler([fe.TenantConfig("heavy", weight=2.0),
                                  fe.TenantConfig("light", weight=1.0)],
                                 lane_weights={"interactive": 1,
                                               "batch": 1})
            for k in range(12):
                for t in ("heavy", "light"):
                    s.on_submit(_fake_req(fe, f"{t}{k}", lane="batch",
                                          tenant=t, t_submit=float(k),
                                          cost=10), 0.0)
            served = []
            for _ in range(9):
                r = s.next_request(0.0)
                served.append(r.meta.tenant)
                s.pop(r, 0.0)
            return served

        served = _both(run)
        assert served.count("heavy") == 6
        assert served.count("light") == 3

    def test_rate_limit_delays_and_bounded_queue_rejects(self):
        def run(fe):
            s = fe.LaneScheduler([fe.TenantConfig(
                "t", rate_tokens_per_s=10.0, burst_tokens=10.0,
                max_queued=2)])
            a = _fake_req(fe, "a", tenant="t", cost=10, t_submit=0.0)
            b = _fake_req(fe, "b", tenant="t", cost=10, t_submit=1.0)
            s.on_submit(a, 0.0)
            s.on_submit(b, 0.0)
            with pytest.raises(fe.QueueFull) as ei:
                s.on_submit(_fake_req(fe, "c", tenant="t"), 0.0)
            out = [str(ei.value), s.window_stats()["rejected"],
                   s.next_request(0.0).name]
            s.pop(a, 0.0)
            out += [s.next_request(0.0),
                    s.window_stats()["rate_throttled_skips"], s.depth(),
                    s.next_request(1.0).name]
            return out

        out = _both(run)
        assert out[1:3] == [1, "a"]
        assert out[3] is None          # b throttled: DELAYED
        assert out[4] >= 1
        assert out[5:] == [1, "b"]

    def test_victims_are_batch_only_newest_first(self):
        def run(fe):
            s = fe.LaneScheduler()
            occupied = [
                (0, _fake_req(fe, "o0", lane="batch", t_submit=1.0), 40),
                (1, _fake_req(fe, "o1", lane="interactive",
                              t_submit=2.0), 40),
                (2, _fake_req(fe, "o2", lane="batch", t_submit=3.0), 40)]
            inter = _fake_req(fe, "i", lane="interactive", t_submit=4.0)
            batch = _fake_req(fe, "b", lane="batch", t_submit=4.0)
            s2 = fe.LaneScheduler(preemption=False)
            return (s.victims(inter, occupied, 0.0),
                    s.victims(batch, occupied, 0.0),
                    s2.victims(inter, occupied, 0.0))

        assert _both(run) == ([2, 0], [], [])

    def test_drain_wait_hysteresis(self):
        def run(fe):
            s = fe.LaneScheduler(preempt_wait_tokens=4)
            near = [(0, _fake_req(fe, "n0", lane="batch", t_submit=1.0),
                     40),
                    (1, _fake_req(fe, "n1", lane="interactive",
                                  t_submit=2.0), 3)]
            far = [(0, _fake_req(fe, "f0", lane="batch", t_submit=1.0),
                    40),
                   (1, _fake_req(fe, "f1", lane="interactive",
                                 t_submit=2.0), 30)]
            inter = _fake_req(fe, "i", lane="interactive", t_submit=4.0)
            late = _fake_req(fe, "l", lane="interactive", deadline=0.5,
                             t_submit=4.0)
            s0 = fe.LaneScheduler(preempt_wait_tokens=0)
            with pytest.raises(ValueError) as ei:
                fe.LaneScheduler(preempt_wait_tokens=-1)
            return (s.victims(inter, near, 4.0),
                    s.victims(inter, far, 4.0),
                    s.victims(late, near, 4.4),
                    s.victims(late, near, 4.6),
                    s0.victims(inter, near, 4.0), str(ei.value))

        out = _both(run)
        assert out[:5] == ([], [0], [], [0], [0])
        assert "preempt_wait_tokens" in out[5]

    def test_prefill_plan_caps_interactive_share(self):
        def run(fe):
            s = fe.LaneScheduler(interactive_chunk_share=0.7)

            def slot(name, lane, need, deadline=None):
                return {"req": _fake_req(fe, name, lane=lane,
                                         deadline=deadline),
                        "prompt": np.zeros(need, np.int32), "fed": 0}

            entries = [(0, slot("b", "batch", 100)),
                       (1, slot("i5", "interactive", 80, deadline=5.0)),
                       (2, slot("i1", "interactive", 80, deadline=1.0))]
            return (s.prefill_plan(entries, budget=100),
                    s.prefill_plan(entries[1:], budget=100))

        plan, solo = _both(run)
        assert [i for i, _ in plan] == [2, 1, 0]
        caps = dict(plan)
        assert caps[2] + caps[1] == 70
        assert caps[0] is None
        assert all(c is None for _, c in solo)


class TestLaneSchedulerPeek:
    def test_orders_like_next_request_without_popping(self):
        def run(fe):
            s = fe.LaneScheduler()
            reqs = {r.name: r for r in (
                _fake_req(fe, "late", deadline=9.0, t_submit=0.0),
                _fake_req(fe, "soon", deadline=1.0, t_submit=0.1,
                          tenant="other"),
                _fake_req(fe, "undated", t_submit=0.05),
                _fake_req(fe, "batch", lane="batch", t_submit=0.0))}
            for r in reqs.values():
                s.on_submit(r, 0.2)
            out = [_names(s.peek(0.2, 10)), s.next_request(0.2).name,
                   s.depth(), _names(s.peek(0.2, 10)),
                   _names(s.peek(0.2, 2)), _names(s.peek(0.2, 0))]
            s.pop(reqs["soon"], 0.2)
            out += [_names(s.peek(0.2, 10)), s.next_request(0.2).name]
            return out

        out = _both(run)
        assert out[0] == ["soon", "late", "undated", "batch"]
        assert out[1] == "soon" and out[2] == 4 and out[3] == out[0]
        assert out[4] == ["soon", "late"] and out[5] == []
        assert out[6] == ["batch", "late", "undated"]
        assert out[7] == "batch"

    def test_skips_throttled_tenant_without_charging_or_counting(self):
        def run(fe):
            s = fe.LaneScheduler([fe.TenantConfig(
                "t", rate_tokens_per_s=10.0, burst_tokens=10.0),
                fe.TenantConfig("u")])
            for r in (_fake_req(fe, "a", tenant="t", cost=10,
                                t_submit=0.0),
                      _fake_req(fe, "b", tenant="t", cost=10,
                                t_submit=1.0),
                      _fake_req(fe, "c", tenant="u", cost=1,
                                t_submit=2.0)):
                s.on_submit(r, 0.0)
            s.pop(s.next_request(0.0), 0.0)
            before = s.window_stats()["rate_throttled_skips"]
            level = s.tenant("t").bucket.level
            return [_names(s.peek(0.0, 10)),
                    s.window_stats()["rate_throttled_skips"] - before,
                    s.tenant("t").bucket.level - level,
                    _names(s.peek(1.0, 10))]

        assert _both(run) == [["c"], 0, 0.0, ["b", "c"]]

    def test_empty_and_batch_vtime_order(self):
        def run(fe):
            s = fe.LaneScheduler([fe.TenantConfig("heavy", weight=2.0),
                                  fe.TenantConfig("light", weight=1.0)])
            out = [_names(s.peek(0.0, 4))]
            reqs = {}
            for k in range(2):
                for t in ("heavy", "light"):
                    r = _fake_req(fe, f"{t}{k}", lane="batch", tenant=t,
                                  cost=10, t_submit=float(k))
                    reqs[r.name] = r
                    s.on_submit(r, 0.0)
            out.append(_names(s.peek(0.0, 10)))
            s.pop(reqs["heavy0"], 0.0)
            out.append(_names(s.peek(0.0, 10)))
            return out

        empty, got, after = _both(run)
        assert empty == [] and len(got) == 4
        assert got.index("heavy0") < got.index("heavy1")
        assert got.index("light0") < got.index("light1")
        assert after[0] == "light0"


# ---- serving ----------------------------------------------------------------

def _fd(pkg, model, **kw):
    fe = _fe(pkg)
    if pkg == "paddle_tpu_torch":
        kw["device"] = "cpu"
    return fe.FrontDoor(model, **kw)


def _preempt_run(pkg, model, pv, pi, sp, cache_on, **kw):
    """One batch request preempted by one interactive request on a
    one-slot front door: (victim tokens, interactive tokens, stats)."""
    fd = _fd(pkg, model, max_slots=1, block_size=4, max_prompt_len=16,
             max_new_tokens=24, enable_prefix_cache=cache_on, **kw)
    fd.start()
    try:
        cb, reached, go = hold_at(2)
        hv = fd.submit(pv, lane="batch", sampling=sp, max_new_tokens=24,
                       on_token=cb)
        assert reached.wait(120)
        hi = fd.submit(pi, lane="interactive", max_new_tokens=3)
        go.set()
        out_i = hi.result(timeout=300)
        out_v = hv.result(timeout=300)
        st = fd.stats()
    finally:
        fd.stop()
    return out_v, out_i, st


class TestFrontDoorServing:
    def test_streaming_deltas_and_stop_string_suppression(self, tiny):
        from paddle_tpu_torch.sampling import SamplingParams

        ref, cfg, port = tiny
        rs = np.random.RandomState(21)
        p = rs.randint(1, cfg.vocab_size, (5,)).astype(np.int32)
        want = ref.generate(p[None], 6).numpy()[0]
        gen = [int(t) for t in want[p.size:]]
        j = max(k for k in range(len(gen)) if gen[k] not in gen[:k])
        stop = _detok([gen[j]])
        fd = _fd("paddle_tpu_torch", port, max_slots=1, block_size=4,
                 max_prompt_len=8, max_new_tokens=6,
                 detokenize=_detok).start()
        try:
            h = fd.submit(p, sampling=SamplingParams(stop_strings=(stop,)))
            evs = list(h)
            out = h.result(timeout=300)
        finally:
            fd.stop()
        assert h.stop_reason == "stop_string"
        assert evs[-1].done
        assert h.text() == _detok(gen[:j])
        assert stop not in h.text()
        np.testing.assert_array_equal(out, want[:p.size + j + 1])
        assert [t for ev in evs for t in ev.token_ids] == gen[:j + 1]

    @pytest.mark.parametrize("cache_on", [True, False])
    @pytest.mark.parametrize("mode", ["greedy", "sampled"])
    def test_preempt_then_resume_token_parity(self, tiny, cache_on, mode):
        """A preempted-then-resumed request gives the tokens of an
        uninterrupted run, and the reference's FrontDoor gives the same
        tokens on the same weights and the same preemption."""
        import paddle_tpu.sampling as rsamp

        import paddle_tpu_torch.sampling as tsamp

        ref, cfg, port = tiny
        kw = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.3,
                  seed=77)
        rs = np.random.RandomState(33)
        pv = rs.randint(1, cfg.vocab_size, (7,)).astype(np.int32)
        pi = rs.randint(1, cfg.vocab_size, (4,)).astype(np.int32)
        sp_t = None if mode == "greedy" else tsamp.SamplingParams(**kw)
        sp_r = None if mode == "greedy" else rsamp.SamplingParams(**kw)
        out_v, out_i, st = _preempt_run("paddle_tpu_torch", port, pv, pi,
                                        sp_t, cache_on)
        fr = st["frontdoor"]
        assert fr["preemptions"] >= 1 and fr["resumes"] >= 1
        if cache_on:
            assert fr["preempt_cached_tokens"] > 0
        else:
            assert fr["preempt_cached_tokens"] == 0
        ref_v, ref_i, rst = _preempt_run("paddle_tpu", ref, pv, pi, sp_r,
                                         cache_on)
        assert rst["frontdoor"]["preemptions"] == fr["preemptions"]
        np.testing.assert_array_equal(out_v, ref_v)
        np.testing.assert_array_equal(out_i, ref_i)
        # and an uninterrupted run of the port
        fd = _fd("paddle_tpu_torch", port, max_slots=1, block_size=4,
                 max_prompt_len=16, max_new_tokens=24,
                 enable_prefix_cache=cache_on).start()
        try:
            solo_v = fd.submit(pv, lane="batch", sampling=sp_t,
                               max_new_tokens=24).result(timeout=300)
            assert fd.stats()["frontdoor"]["preemptions"] == 0
        finally:
            fd.stop()
        np.testing.assert_array_equal(out_v, solo_v)

    def test_bounded_queue_rejects_at_submit(self, tiny):
        from paddle_tpu_torch.frontend import QueueFull

        _ref, _cfg, port = tiny
        fd = _fd("paddle_tpu_torch", port, max_slots=1, block_size=4,
                 max_prompt_len=8, max_new_tokens=4, max_queue=1)
        f = fd.submit(np.array([1, 2, 3], np.int32))
        with pytest.raises(QueueFull, match="front-door queue full"):
            fd.submit(np.array([4, 5], np.int32))
        assert fd.stats()["frontdoor"]["rejected"] == 1
        fd.stop()
        with pytest.raises(RuntimeError, match="server stopped"):
            f.result(timeout=10)

    def test_rate_limited_tenant_is_delayed_not_rejected(self, tiny):
        from paddle_tpu_torch.frontend import TenantConfig

        ref, cfg, port = tiny
        # cost = 3 prompt + 2 budget = 5; the burst covers one request.
        # Both are queued before start(), so the first admission pass
        # admits one and is throttled on the other
        fd = _fd("paddle_tpu_torch", port, max_slots=2, block_size=4,
                 max_prompt_len=8, max_new_tokens=2,
                 tenants=[TenantConfig("slow", rate_tokens_per_s=50.0,
                                       burst_tokens=5.0)])
        rs = np.random.RandomState(5)
        ps = [rs.randint(1, cfg.vocab_size, (3,)).astype(np.int32)
              for _ in range(2)]
        hs = [fd.submit(p, tenant="slow") for p in ps]
        fd.start()
        try:
            for h, p in zip(hs, ps):
                np.testing.assert_array_equal(
                    h.result(timeout=300),
                    ref.generate(p[None], 2).numpy()[0])
            st = fd.stats()["frontdoor"]
            assert st["rate_throttled_skips"] >= 1
            assert st["rejected"] == 0
        finally:
            fd.stop()

    def test_deadline_miss_counted_per_lane(self, tiny):
        _ref, _cfg, port = tiny
        fd = _fd("paddle_tpu_torch", port, max_slots=1, block_size=4,
                 max_prompt_len=8, max_new_tokens=2).start()
        try:
            fd.submit(np.array([1, 2, 3], np.int32),
                      deadline_ms=0.01).result(timeout=300)
            st = fd.stats()["frontdoor"]
            assert st["deadline_requests"] == {"interactive": 1}
            assert st["deadline_misses"] == {"interactive": 1}
            assert st["deadline_miss_rate"] == 1.0
            assert st["lanes"]["interactive"]["ttft"]["n"] == 1
            fd.reset_stats()
            st = fd.stats()["frontdoor"]
            assert st["deadline_misses"] == {}
            assert st["preemptions"] == 0
        finally:
            fd.stop()

    def test_unknown_tenant_rejected_with_explicit_roster(self, tiny):
        from paddle_tpu_torch.frontend import TenantConfig

        _ref, _cfg, port = tiny
        fd = _fd("paddle_tpu_torch", port, max_slots=1, block_size=4,
                 max_prompt_len=8, max_new_tokens=2,
                 tenants=[TenantConfig("known")])
        with pytest.raises(ValueError, match="unknown tenant"):
            fd.submit(np.array([1, 2], np.int32), tenant="who")
        fd.stop()


class TestEngineSatellites:
    def test_stats_schema_available_blocks_and_queues(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as RefSrv

        from paddle_tpu_torch.inference import PagedGenerationServer

        ref, _cfg, port = tiny
        kw = dict(max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=2)
        srv = PagedGenerationServer(port, device="cpu", **kw)
        st = srv.stats()
        assert st["available_blocks"] == \
            srv.cache.available_block_count > 0
        assert st["queue_depth"] == 0
        assert st["lane_queue_depth"] == {}
        assert st["tenant_queue_depth"] == {}
        rst = RefSrv(ref, **kw).stats()
        assert st["frontdoor"] == rst["frontdoor"]
        assert st["tier_prefetch"] == rst["tier_prefetch"]
        assert st["frontdoor"]["enabled"] is False
        srv.reset_stats()
        assert srv.stats()["frontdoor"]["preemptions"] == 0
        srv.stop()

    def test_plain_server_on_token_callback_and_fault_isolation(self,
                                                                tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer

        ref, _cfg, port = tiny
        srv = PagedGenerationServer(port, max_slots=1, block_size=4,
                                    max_prompt_len=8, max_new_tokens=3,
                                    device="cpu").start()
        try:
            seen = []

            def cb(tok, reason):
                seen.append((tok, reason))
                raise RuntimeError("boom")

            p = np.array([5, 6, 7], np.int32)
            want = ref.generate(p[None], 3).numpy()[0]
            np.testing.assert_array_equal(
                srv.submit(p, on_token=cb).result(timeout=300), want)
            assert len(seen) == 1 and seen[0][0] == int(want[3])
            np.testing.assert_array_equal(
                srv.submit(p).result(timeout=300), want)
        finally:
            srv.stop()

    def test_warm_buckets_changes_no_state(self, tiny):
        """warm_buckets captures nothing on the CPU (the graphs are the
        card's) and touches neither the pool nor the served tokens; after
        start() it is refused."""
        from paddle_tpu_torch.frontend import FrontDoor

        ref, cfg, port = tiny
        fd = FrontDoor(port, max_slots=2, block_size=4, max_prompt_len=8,
                       max_new_tokens=2, prefill_chunk_tokens=8,
                       device="cpu")
        avail0 = fd.server.cache.available_block_count
        assert fd.warm() == 0
        assert fd.server.cache.available_block_count == avail0
        rs = np.random.RandomState(9)
        ps = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
              for n in (3, 5)]
        fd.start()
        try:
            for p in ps:
                np.testing.assert_array_equal(
                    fd.submit(p).result(timeout=300),
                    ref.generate(p[None], 2).numpy()[0])
            with pytest.raises(RuntimeError, match="before start"):
                fd.warm()
        finally:
            fd.stop()

    def test_swap_out_seq_publishes_live_prefix(self):
        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        cache = PagedKVCache(1, 1, 4, block_size=4, num_blocks=8,
                             device="cpu")
        ids = np.arange(100, 112, dtype=np.int32)
        cache.ensure_many([("s", 10)])
        with pytest.raises(ValueError, match="only .* token ids"):
            cache.swap_out_seq("s", ids[:8])
        assert cache.swap_out_seq("s", ids) == 10
        assert not cache.has_seq("s")
        assert cache.retained_block_count > 0
        assert cache.attach_prefix("s2", ids[:10]) == 9

    def test_preemption_trace_assembles_with_requeue_phase(self):
        from paddle_tpu.observability.tracing import \
            assemble_request_traces as ref_assemble

        from paddle_tpu_torch.observability.tracing import \
            assemble_request_traces

        evs = [
            {"name": "request_submitted", "request_id": "r", "ts": 0.0},
            {"name": "request_admitted", "request_id": "r", "ts": 0.1},
            {"name": "prefill", "request_id": "r", "ts": 0.2,
             "dur": 0.1, "chunks": 1},
            {"name": "preempted", "request_id": "r", "ts": 0.5},
            {"name": "request_admitted", "request_id": "r", "ts": 0.8},
            {"name": "prefill", "request_id": "r", "ts": 0.9,
             "dur": 0.1, "chunks": 2},
            {"name": "request_done", "request_id": "r", "ts": 1.5,
             "new_tokens": 5, "ttft_s": 0.3},
            {"name": "detokenize", "request_id": "r", "ts": 1.5,
             "dur": 0.1},
        ]
        rec = assemble_request_traces(evs)["r"]
        assert rec == ref_assemble(evs)["r"]
        assert rec["preemptions"] == 1
        assert rec["requeue_ms"] == pytest.approx(300.0)
        assert rec["ttft_ms"] == pytest.approx(300.0)
        assert rec["prefill_chunks"] == 3
        assert sum(rec["phases_ms"].values()) == \
            pytest.approx(rec["wall_ms"])

    @pytest.mark.parametrize("engine", ["unified", "async"])
    def test_preemption_on_unified_and_async_rounds(self, tiny, engine):
        """The async round in flight is processed before the swap-out:
        the preempted request's tokens equal the split engine's, and a
        server with no scheduler keeps its tokens and dispatch counts."""
        from paddle_tpu_torch.inference import PagedGenerationServer

        ref, cfg, port = tiny
        rs = np.random.RandomState(33)
        pv = rs.randint(1, cfg.vocab_size, (7,)).astype(np.int32)
        pi = rs.randint(1, cfg.vocab_size, (4,)).astype(np.int32)
        kw = ({"unified_round": True} if engine == "unified"
              else {"async_rounds": True})
        out_v, out_i, st = _preempt_run("paddle_tpu_torch", port, pv, pi,
                                        None, True, **kw)
        assert st["frontdoor"]["preemptions"] >= 1
        np.testing.assert_array_equal(out_v,
                                      ref.generate(pv[None], 24).numpy()[0])
        np.testing.assert_array_equal(out_i,
                                      ref.generate(pi[None], 3).numpy()[0])
        # no scheduler: the FIFO path, its tokens and its dispatches
        runs = []
        for _ in range(2):
            srv = PagedGenerationServer(port, max_slots=1, block_size=4,
                                        max_prompt_len=16,
                                        max_new_tokens=24, device="cpu",
                                        **kw)
            futs = [srv.submit(pv), srv.submit(pi, max_new_tokens=3)]
            srv.start()
            try:
                outs = [f.result(timeout=300) for f in futs]
                s = srv.stats()
            finally:
                srv.stop()
            runs.append((outs, s["rounds"]["rounds"],
                         s["rounds"]["attention_dispatches"],
                         s["frontdoor"]["preemptions"]))
        (o1, r1, d1, p1), (o2, r2, d2, p2) = runs
        for a, b in zip(o1, o2):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(o1[0], out_v)
        assert (r1, d1, p1) == (r2, d2, p2) and p1 == 0


def test_frontdoor_reports_are_callable(tiny):
    """slo_report, capacity, export_timeline and cost_report answer on a
    fronted port server (none of them raises)."""
    import json
    import os
    import tempfile

    _ref, _cfg, port = tiny
    fd = _fd("paddle_tpu_torch", port, max_slots=2, block_size=4,
             max_prompt_len=8, max_new_tokens=3, slos=True,
             attribution=True, flight_recorder=True).start()
    try:
        hs = [fd.submit(np.array([1, 2, 3], np.int32), tenant=t)
              for t in ("a", "b")]
        for h in hs:
            h.result(timeout=300)
        rep = fd.slo_report()
        assert {s["name"] for s in rep["slos"]}
        cap = fd.capacity()
        assert cap["schema_version"] == 1
        assert cap["queues"]["max_slots"] == 2
        cost = fd.cost_report()
        assert set(cost.tenants) >= {"a", "b"}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tl.json")
            n = fd.export_timeline(path)
            assert n > 0
            with open(path) as f:
                assert json.load(f)["traceEvents"]
    finally:
        fd.stop()
