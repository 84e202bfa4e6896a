"""The port's fault-tolerant serving (paddle_tpu_torch/reliability and the
PagedGenerationServer's recovery ladder, journal, timeouts and
shedding) on the CPU: twins of tests/test_reliability.py, plus
cross-engine checks against the reference.

  * The host-side pieces equal the reference's: `FaultPlan.from_seed`
    gives the same schedule for the same seed, `RecoveryPolicy` the
    same backoffs, and either package's `SessionJournal` reads the
    other's file (the same operations write the same bytes).
  * The server under a FaultPlan: a recovered fault leaves every
    request's tokens as the fault-free run's, a persistent one
    quarantines exactly one request, health returns to ok, a killed
    server's journal is recovered token for token.
  * Cross-engine: the port's and the reference's servers under the same
    plan and work give each request the same outcome and tokens; a
    journal the reference's server left at kill() is recovered by the
    port's into the reference's uninterrupted tokens.

GPT-2 tiny (vocab 512, hidden 128, 2 layers, 4 heads) with the same
float32 weights in both packages; greedy token identity is exact.
Nothing here asserts an elapsed time below a bound: waits are on
conditions with generous deadlines."""
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_twin_util import hold_at

torch.set_num_threads(1)

from paddle_tpu_torch.reliability import (ENV_FAULT_PLAN,  # noqa: E402
                                          SEAMS, AdmissionShed, Fault,
                                          FaultPlan, InjectedFault,
                                          QuarantinedRequest,
                                          RecoveryPolicy, RequestTimeout,
                                          SessionJournal,
                                          resolve_fault_plan)


@pytest.fixture(autouse=True)
def _registry_guard():
    """expose_port= enables the process metrics registry by design:
    restore the gate and zero the series afterwards."""
    from paddle_tpu_torch.observability import metrics as M

    was = M.REGISTRY.enabled
    yield
    M.REGISTRY.enabled = was
    M.REGISTRY.reset()


@pytest.fixture(scope="module")
def tiny():
    """(reference GPT2, the port's GPT2 with the same float32 weights):
    the config of tests/test_reliability.py."""
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


def _defaults(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_prompt_len", 24)
    kw.setdefault("max_new_tokens", 6)
    return kw


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    return PagedGenerationServer(port, device="cpu", **_defaults(kw))


def _ref_server(ref, **kw):
    from paddle_tpu.inference import PagedGenerationServer

    return PagedGenerationServer(ref, **_defaults(kw))


def _detok(toks):
    """Deterministic, prefix-stable toy detokenizer (append a token ->
    append characters)."""
    return "".join(chr(97 + (int(t) % 26)) for t in toks)


def _collect(futs, timeout=300):
    """[("ok", tokens) | (ExceptionName, exc)] in submit order."""
    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(timeout=timeout)))
        except Exception as e:  # noqa: BLE001 — collected for asserts
            out.append((type(e).__name__, e))
    return out


def _run(srv, work, timeout=300):
    """Submit every request BEFORE start() (admission order fixed),
    then drain: (results, stats, health)."""
    futs = [srv.submit(ids, **kw) for ids, kw in work]
    srv.start()
    try:
        res = _collect(futs, timeout)
        st, health = srv.stats(), srv.health()
    finally:
        srv.stop()
    return res, st, health


def _run_port(port, work, srv_kw=None):
    return _run(_server(port, **(srv_kw or {})), work)


TWO = [(np.array([1, 2, 3], np.int32), {}),
       (np.array([4, 5, 6, 7], np.int32), {})]


def _same_tokens(want, have):
    assert [k for k, _ in have] == ["ok"] * len(have), have
    for (_, a), (_, b) in zip(want, have):
        np.testing.assert_array_equal(a, b)


def _kill_at(srv, n):
    """An on_token callback that, at its n-th token, waits (up to 60 s)
    until `srv` is stopped: the caller kills the server from its own
    thread once `reached` is set, so the crash lands at a fixed token,
    whatever the speed of the engine. Returns (callback, seen,
    reached)."""
    seen = []
    reached = threading.Event()

    def cb(tok, _reason):
        seen.append(int(tok))
        if len(seen) == n:
            reached.set()
            deadline = time.monotonic() + 60
            while not srv.liveness()[1]["stopped"] \
                    and time.monotonic() < deadline:
                time.sleep(0.001)

    return cb, seen, reached


# ---- the plan, the policy, the journal ---------------------------------------

class TestFaultPlan:
    @pytest.mark.parametrize("seed,rate,horizon,min_per", [
        (7, 0.2, 32, 0), (3, 0.0, 16, 1), (2026, 0.05, 64, 2),
        (0, 0.5, 8, 0)])
    def test_from_seed_equals_the_reference_schedule(self, seed, rate,
                                                     horizon, min_per):
        from paddle_tpu.reliability import FaultPlan as RefPlan

        a = FaultPlan.from_seed(seed, rate=rate, horizon=horizon,
                                min_per_seam=min_per)
        b = RefPlan.from_seed(seed, rate=rate, horizon=horizon,
                              min_per_seam=min_per)
        assert a.total_scheduled == b.total_scheduled
        assert a.describe() == b.describe()
        for seam in SEAMS:
            for _ in range(horizon):
                fa, fb = a.poll(seam), b.poll(seam)
                assert (fa is None) == (fb is None), (seam, fa, fb)
                if fa is not None:
                    assert (fa.seam, fa.index, fa.kind, fa.delay_s) == \
                        (fb.seam, fb.index, fb.kind, fb.delay_s)
        assert a.fired() == b.fired()
        assert a.stats() == b.stats()

    def test_from_seed_is_deterministic(self):
        a = FaultPlan.from_seed(7, rate=0.2, horizon=32)
        b = FaultPlan.from_seed(7, rate=0.2, horizon=32)
        for seam in SEAMS:
            for _ in range(32):
                fa, fb = a.poll(seam), b.poll(seam)
                assert (fa is None) == (fb is None)
                if fa is not None:
                    assert (fa.seam, fa.index, fa.kind) == \
                        (fb.seam, fb.index, fb.kind)

    def test_min_per_seam_guarantees_coverage(self):
        p = FaultPlan.from_seed(3, rate=0.0, horizon=16, min_per_seam=1)
        hit = set()
        for seam in SEAMS:
            for _ in range(16):
                if p.poll(seam) is not None:
                    hit.add(seam)
        assert hit == set(SEAMS)
        assert p.fired() == {s: 1 for s in SEAMS}

    def test_seam_kinds_default_correctly(self):
        p = FaultPlan.parse("ensure_many:0,slow_dispatch:0,decode:0")
        assert p.poll("ensure_many").kind == "exhausted"
        assert p.poll("slow_dispatch").kind == "slow"
        assert p.poll("decode").kind == "raise"

    @pytest.mark.parametrize("spec,match", [
        ("warp_core:0", "unknown fault seam"),
        ("decode", "seam:occurrence"),
        ("rate=0.5", "needs seed="),
        ("seed=1,frequency=2", "unknown fault-plan key"),
        ("  ", "empty")])
    def test_parse_validation(self, spec, match):
        with pytest.raises(ValueError, match=match):
            FaultPlan.parse(spec)

    def test_env_var_resolution(self, monkeypatch):
        monkeypatch.delenv(ENV_FAULT_PLAN, raising=False)
        assert resolve_fault_plan(None) is None
        monkeypatch.setenv(ENV_FAULT_PLAN, "decode:1")
        p = resolve_fault_plan(None)
        assert p is not None and p.poll("decode") is None
        assert p.poll("decode") is not None
        with pytest.raises(TypeError, match="fault_plan"):
            resolve_fault_plan(42)

    def test_reset_counters_replays_the_schedule(self):
        p = FaultPlan([Fault("decode", 0)])
        assert p.poll("decode") is not None
        assert p.poll("decode") is None
        p.reset_counters()
        assert p.poll("decode") is not None

    def test_make_fault_is_an_injected_fault(self):
        p = FaultPlan.parse("prefill:2")
        for _ in range(2):
            assert p.poll("prefill") is None
        e = p.make_fault(p.poll("prefill"))
        assert isinstance(e, InjectedFault)
        assert (e.seam, e.occurrence) == ("prefill", 2)
        assert str(e) == "injected fault at seam 'prefill' (occurrence 2)"


class TestRecoveryPolicy:
    @pytest.mark.parametrize("base,cap,after", [
        (0.1, 0.5, 3), (0.02, 1.0, 1), (0.0, 0.0, 5), (0.25, 4.0, 2)])
    def test_backoff_equals_the_reference(self, base, cap, after):
        from paddle_tpu.reliability import RecoveryPolicy as RefPolicy

        a = RecoveryPolicy(quarantine_after=after, backoff_base_s=base,
                           backoff_cap_s=cap)
        b = RefPolicy(quarantine_after=after, backoff_base_s=base,
                      backoff_cap_s=cap)
        assert [a.backoff_s(k) for k in range(0, 16)] == \
            [b.backoff_s(k) for k in range(0, 16)]

    def test_backoff_is_capped_exponential(self):
        pol = RecoveryPolicy(backoff_base_s=0.1, backoff_cap_s=0.5)
        assert pol.backoff_s(1) == pytest.approx(0.1)
        assert pol.backoff_s(2) == pytest.approx(0.2)
        assert pol.backoff_s(3) == pytest.approx(0.4)
        assert pol.backoff_s(4) == pytest.approx(0.5)  # capped
        assert pol.backoff_s(10) == pytest.approx(0.5)

    def test_validation(self):
        with pytest.raises(ValueError, match="quarantine_after"):
            RecoveryPolicy(quarantine_after=0)
        with pytest.raises(ValueError, match="backoff_cap_s"):
            RecoveryPolicy(backoff_base_s=1.0, backoff_cap_s=0.1)


class _FakeReq:
    def __init__(self, rid, ids, budget=4, seed=9, gen0=(), sampling=None,
                 meta=None, timeout_s=None):
        self.rid, self.ids = rid, np.asarray(ids, np.int32)
        self.budget, self.seed = budget, seed
        self.gen0, self.sampling = tuple(gen0), sampling
        self.meta, self.timeout_s = meta, timeout_s


def _journal_ops(j, sampling):
    j.record_accept(_FakeReq("r1", [1, 2, 3], sampling=sampling,
                             timeout_s=2.5))
    j.record_accept(_FakeReq("r2", [4, 5], gen0=(6,)))
    j.record_token("r1", 7)
    j.record_token("r1", 8)
    j.record_token("r2", 9)
    j.record_accept(_FakeReq("r3", [1]))
    j.record_done("r3", "eos")


class TestSessionJournalUnit:
    def test_accept_tokens_done_roundtrip(self, tmp_path):
        j = SessionJournal(tmp_path / "j.jsonl")
        j.record_accept(_FakeReq("r1", [1, 2, 3]))
        j.record_accept(_FakeReq("r2", [4, 5]))
        j.record_token("r1", 7)
        j.record_token("r1", 8)
        j.record_done("r2", "eos")
        live = j.interrupted()
        assert [e["rid"] for e in live] == ["r1"]
        assert live[0]["ids"] == [1, 2, 3]
        assert live[0]["gen0"] == [7, 8]
        assert j.stats()["accepted"] == 2
        assert j.stats()["finished"] == 1
        j.close()
        j2 = SessionJournal(tmp_path / "j.jsonl")
        assert [e["rid"] for e in j2.interrupted()] == ["r1"]
        assert j2.interrupted()[0]["gen0"] == [7, 8]

    def test_torn_tail_is_skipped(self, tmp_path):
        p = tmp_path / "j.jsonl"
        j = SessionJournal(p)
        j.record_accept(_FakeReq("r1", [1]))
        j.record_token("r1", 3)
        j.close()
        with open(p, "a", encoding="utf-8") as f:
            f.write('{"t":"tok","rid":"r1","to')  # crash mid-write
        j2 = SessionJournal(p)
        assert j2.interrupted()[0]["gen0"] == [3]
        assert j2.stats()["torn_lines"] == 1

    def test_compaction_bounds_the_file_and_keeps_live_state(
            self, tmp_path):
        p = tmp_path / "j.jsonl"
        j = SessionJournal(p, max_bytes=2048)
        j.record_accept(_FakeReq("live", [1, 2]))
        for i in range(40):
            j.record_accept(_FakeReq(f"d{i}", [i]))
            j.record_token(f"d{i}", i)
            j.record_done(f"d{i}", "budget")
            j.record_token("live", 100 + i)
        assert os.path.getsize(p) <= 2048 + 512  # one slack line
        live = j.interrupted()
        assert [e["rid"] for e in live] == ["live"]
        assert live[0]["gen0"] == [100 + i for i in range(40)]
        j.close()

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_cross_read_between_packages(self, tmp_path, writer):
        """The record format is the reference's byte for byte: the same
        operations write the same file, and each package's
        `interrupted()` reads the other's journal into the same
        entries."""
        from paddle_tpu.reliability import SessionJournal as RefJournal
        from paddle_tpu.sampling import SamplingParams as RefSP

        from paddle_tpu_torch.sampling import SamplingParams

        pa, pb = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
        ja, jb = SessionJournal(pa), RefJournal(pb)
        _journal_ops(ja, SamplingParams(temperature=0.8, top_p=0.9,
                                        seed=77, stop_strings=("x",)))
        _journal_ops(jb, RefSP(temperature=0.8, top_p=0.9, seed=77,
                               stop_strings=("x",)))
        ja.close()
        jb.close()
        assert pa.read_bytes() == pb.read_bytes()
        src = pb if writer == "reference" else pa
        reader = SessionJournal if writer == "reference" else RefJournal
        want = (RefJournal if writer == "reference"
                else SessionJournal)(src).interrupted()
        got = reader(src).interrupted()
        assert got == want
        assert [e["rid"] for e in got] == ["r1", "r2"]
        assert got[0]["gen0"] == [7, 8] and got[1]["gen0"] == [6, 9]
        assert got[0]["timeout_s"] == 2.5
        assert got[0]["sampling"]["stop_strings"] == ["x"]


class TestJournalCompactionConcurrency:
    """Compaction racing appends never tears or loses a record."""

    def test_threaded_append_vs_compact_stress(self, tmp_path):
        jp = tmp_path / "stress.jsonl"
        j = SessionJournal(jp, max_bytes=2048)  # tiny: compacts often
        stop = threading.Event()
        truth = {}
        tl = threading.Lock()
        errors = []

        def writer(k):
            try:
                i = 0
                while not stop.is_set():
                    rid = f"w{k}-{i}"
                    j.record_accept(_FakeReq(rid, [1, 2, 3], budget=8,
                                             seed=7))
                    with tl:
                        truth[rid] = []
                    for t in range(5):
                        j.record_token(rid, t)
                        with tl:
                            truth[rid].append(t)
                    if i % 2 == 0:  # half the requests finish
                        j.record_done(rid, "budget")
                        with tl:
                            del truth[rid]
                    i += 1
            except Exception as e:  # noqa: BLE001 — collected
                errors.append(e)

        def compactor():
            try:
                while not stop.is_set():
                    j.compact()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        threads.append(threading.Thread(target=compactor))
        for t in threads:
            t.start()
        # run until the writers produced enough live work (a condition,
        # with a generous deadline)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with tl:
                if len(truth) > 20:
                    break
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        j.close()
        assert not errors, errors
        j2 = SessionJournal(jp)
        assert j2.stats()["torn_lines"] == 0
        live = {e["rid"]: e["gen0"] for e in j2.interrupted()}
        assert live == truth
        assert len(live) > 10
        j2.close()

    def test_forced_compact_while_appending_single_thread(self, tmp_path):
        jp = tmp_path / "fold.jsonl"
        j = SessionJournal(jp)
        j.record_accept(_FakeReq("a", [4, 5], budget=6, seed=3))
        j.record_token("a", 11)
        j.record_token("a", 12)
        j.compact()
        j.record_token("a", 13)
        j.close()
        j2 = SessionJournal(jp)
        (ent,) = j2.interrupted()
        assert ent["gen0"] == [11, 12, 13]
        j2.close()


# ---- the server under faults ---------------------------------------------------

class TestBlastRadius:
    @pytest.mark.parametrize("plan", ["decode:1", "ensure_many:0",
                                      "ensure_many:2,prefill:1"])
    def test_transient_fault_nobody_fails(self, tiny, plan):
        _ref, port = tiny
        ref_res, _, _ = _run_port(port, TWO)
        res, st, health = _run_port(port, TWO,
                                    {"fault_plan": FaultPlan.parse(plan)})
        _same_tokens(ref_res, res)
        rel = st["reliability"]
        assert rel["faults_injected"] == len(plan.split(","))
        assert rel["dispatch_retries"] >= 1
        assert rel["recoveries"] >= 1
        assert rel["quarantined"] == 0
        assert rel["resumes"] >= 1
        assert health[0] == "ok"  # degraded was NOT sticky: recovered
        assert health[1]["last_recovery"]["recovered_from"]

    def test_legacy_blast_radius_spares_unimplicated_coresidents(
            self, tiny):
        """recovery=False: a prefill fault fails ONLY the chunk's
        request; a decode-phase co-resident completes with its
        fault-free tokens."""
        _ref, port = tiny
        srv = _server(port, recovery=False,
                      fault_plan=FaultPlan.parse("prefill:1"))
        seen = []
        srv.start()
        try:
            a = srv.submit([1, 2, 3], on_token=lambda t, r: seen.append(t))
            deadline = time.monotonic() + 60
            while not seen and time.monotonic() < deadline:
                time.sleep(0.005)
            assert seen  # a is decoding: prefill occurrence 0 is spent
            b = srv.submit([4, 5, 6, 7])
            with pytest.raises(InjectedFault):
                b.result(timeout=300)
            out_a = a.result(timeout=300)
        finally:
            srv.stop()
        want, _, _ = _run_port(port, [(np.array([1, 2, 3], np.int32), {})])
        np.testing.assert_array_equal(out_a, want[0][1])

    def test_block_pool_exhausted_carries_pressure_fields(self):
        from paddle_tpu_torch.inference.kv_cache import (BlockPoolExhausted,
                                                         PagedKVCache)

        c = PagedKVCache(1, 1, 2, block_size=4, num_blocks=4, device="cpu")
        with pytest.raises(BlockPoolExhausted) as ei:
            c.allocate("a", 100)
        assert ei.value.needed == 25
        assert ei.value.available == 3


class TestQuarantine:
    def test_persistent_fault_quarantines_exactly_one(self, tiny):
        _ref, port = tiny
        ref_res, _, _ = _run_port(port, TWO)
        res, st, health = _run_port(
            port, TWO, {"fault_plan": FaultPlan.parse(
                "prefill:0,prefill:1,prefill:2")})
        kinds = [r[0] for r in res]
        assert kinds.count("QuarantinedRequest") == 1, kinds
        qi, oi = kinds.index("QuarantinedRequest"), kinds.index("ok")
        q = res[qi][1]
        assert q.seam == "prefill" and q.failures == 3
        assert "injected fault" in str(q)
        np.testing.assert_array_equal(res[oi][1], ref_res[oi][1])
        rel = st["reliability"]
        assert rel["quarantined"] == 1
        assert rel["recoveries"] >= 1
        assert health[0] == "ok"

    @pytest.mark.parametrize("prefix_cache", [True, False])
    def test_persistent_decode_fault_and_the_resume_kind(self, tiny,
                                                         prefix_cache):
        """Three failing decode dispatches in a row. With the prefix
        cache, every retry is a WARM resume straight into the next
        decode dispatch, so the streak reaches quarantine_after and
        exactly one request is quarantined. Without it, each retry
        re-prefills, and that successful prefill is a clean recovery
        that resets the streaks: nobody is quarantined and both finish
        (the reference's ladder does the same; ROADMAP §C 19)."""
        _ref, port = tiny
        kw = {"enable_prefix_cache": prefix_cache}
        ref_res, _, _ = _run_port(port, TWO, kw)
        res, st, health = _run_port(port, TWO, dict(
            kw, fault_plan="decode:0,decode:1,decode:2"))
        kinds = [k for k, _ in res]
        rel = st["reliability"]
        if prefix_cache:
            assert kinds.count("QuarantinedRequest") == 1, kinds
            assert res[kinds.index("QuarantinedRequest")][1].seam == \
                "decode"
            assert rel["warm_resumes"] == rel["resumes"] > 0
        else:
            assert kinds == ["ok", "ok"]
            assert rel["recoveries"] == 3 and rel["warm_resumes"] == 0
        for (_, a), (kind, b) in zip(ref_res, res):
            if kind == "ok":
                np.testing.assert_array_equal(a, b)
        assert health[0] == "ok"

    def test_detokenize_fault_implicates_one_request(self, tiny):
        from paddle_tpu_torch.sampling import SamplingParams

        _ref, port = tiny
        work = [(np.array([1, 2, 3], np.int32),
                 {"sampling": SamplingParams(stop_strings=("zq!",))}),
                (np.array([4, 5, 6, 7], np.int32), {})]
        ref_res, _, _ = _run_port(port, work, {"detokenize": _detok})
        res, st, _ = _run_port(port, work, {
            "detokenize": _detok,
            "fault_plan": FaultPlan.parse("detokenize:0")})
        assert res[0][0] == "QuarantinedRequest"
        assert res[0][1].seam == "detokenize"
        assert res[1][0] == "ok"
        np.testing.assert_array_equal(res[1][1], ref_res[1][1])
        assert st["reliability"]["quarantined"] == 1

    def test_stream_consumer_death_is_isolated(self, tiny):
        _ref, port = tiny
        ids = np.array([1, 2, 3], np.int32)
        ref_res, _, _ = _run_port(port, [(ids, {})])
        got = []
        res, st, health = _run_port(
            port, [(ids, {"on_token": lambda t, r: got.append(t)})],
            {"fault_plan": FaultPlan.parse("stream_consumer:0")})
        _same_tokens(ref_res, res)
        assert got == []  # the stream was dropped at the first token
        assert health[0] == "ok"
        assert st["reliability"]["quarantined"] == 0


class TestHealthTransitions:
    def test_degraded_then_ok_after_clean_recovery(self, tiny):
        _ref, port = tiny
        srv = _server(port, max_slots=1, expose_port=0,
                      fault_plan=FaultPlan.parse(
                          "prefill:0,prefill:1,prefill:2"))

        def healthz():
            try:
                r = urllib.request.urlopen(srv.exporter.url + "/healthz",
                                           timeout=10)
                return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        srv.start()
        try:
            assert healthz()[0] == 200
            assert srv.health()[0] == "ok"
            with pytest.raises(QuarantinedRequest):
                srv.submit([1, 2, 3]).result(timeout=300)
            status, detail = srv.health()
            assert status == "degraded"
            assert "injected fault" in detail["degraded_reason"]
            code1, body1 = healthz()
            assert code1 == 200  # degraded still serves
            assert '"degraded"' in body1
            srv.submit([4, 5, 6]).result(timeout=300)
            status, detail = srv.health()
            assert status == "ok"
            assert "injected fault" in \
                detail["last_recovery"]["recovered_from"]
            assert detail["last_recovery"]["ts"] <= time.time()
            st = srv.stats()["reliability"]
            assert st["recoveries"] == 1
            assert st["last_recovery"]["failures"] >= 1
        finally:
            srv.stop()

    def test_reset_stats_also_clears_degraded(self, tiny):
        _ref, port = tiny
        srv = _server(port, max_slots=1, fault_plan=FaultPlan.parse(
            "prefill:0,prefill:1,prefill:2"))
        srv.start()
        try:
            with pytest.raises(QuarantinedRequest):
                srv.submit([1, 2, 3]).result(timeout=300)
            assert srv.health()[0] == "degraded"
            srv.reset_stats()
            assert srv.health()[0] == "ok"
            assert srv.stats()["reliability"]["quarantined"] == 0
        finally:
            srv.stop()

    def test_slow_dispatch_fault_trips_watchdog_then_recovers(self, tiny):
        _ref, port = tiny
        plan = FaultPlan([Fault("slow_dispatch", 0, "slow", delay_s=1.2)])
        srv = _server(port, expose_port=0, stall_timeout_s=0.25,
                      fault_plan=plan)
        srv.start()
        try:
            out = srv.submit([1, 2, 3]).result(timeout=300)
            assert out.size > 3
            deadline = time.monotonic() + 30
            while srv._watchdog.stalled and time.monotonic() < deadline:
                time.sleep(0.05)
            assert srv._watchdog.stalls >= 1
            assert srv.health()[0] == "ok"
            assert srv.stats()["reliability"]["faults_injected"] == 1
        finally:
            srv.stop()


class TestTimeoutsAndShedding:
    def test_queued_request_times_out(self, tiny):
        _ref, port = tiny
        srv = _server(port, max_slots=1, max_new_tokens=32)
        a = srv.submit([1, 2, 3], max_new_tokens=32)
        b = srv.submit([4, 5, 6], timeout_s=0.005)
        time.sleep(0.02)  # b is overdue before the loop first looks
        srv.start()
        try:
            with pytest.raises(RequestTimeout, match="timed out"):
                b.result(timeout=300)
            assert a.result(timeout=300).size == 35
            st = srv.stats()
            assert st["reliability"]["timeouts"] == 1
            assert st["kv_cache"]["sequences"] == 0
        finally:
            srv.stop()

    def test_resident_request_times_out_and_frees_its_slot(self, tiny):
        """A resident request past its deadline is cancelled mid-decode
        and its blocks go back to the pool. The deadline passes inside
        its own token stream (its callback sleeps past it at the first
        token), so the check does not race the engine's speed."""
        _ref, port = tiny
        srv = _server(port, max_slots=1, max_new_tokens=64,
                      max_prompt_len=32)
        seen = []

        def slow(tok, _reason):
            seen.append(tok)
            if len(seen) == 1:
                time.sleep(1.2)  # past timeout_s: expires next round

        srv.start()
        try:
            fut = srv.submit([1, 2, 3], max_new_tokens=64, timeout_s=1.0,
                             on_token=slow)
            with pytest.raises(RequestTimeout) as ei:
                fut.result(timeout=300)
            assert ei.value.timeout_s == pytest.approx(1.0)
            assert 1 <= len(seen) < 64
            assert srv.stats()["kv_cache"]["sequences"] == 0
            assert srv.stats()["reliability"]["timeouts"] == 1
            assert srv.submit([7, 8], max_new_tokens=2) \
                .result(timeout=300).size == 4
        finally:
            srv.stop()

    def test_admission_shedding_with_retry_hint(self, tiny):
        _ref, port = tiny
        srv = _server(port, shed_queue_depth=2)  # not started
        try:
            srv.submit([1, 2, 3])
            srv.submit([4, 5, 6])
            with pytest.raises(AdmissionShed) as ei:
                srv.submit([7, 8, 9])
            assert ei.value.retry_after_s > 0
            assert ei.value.depth == 2
            assert srv.stats()["reliability"]["shed"] == 1
            assert srv.stats()["queue_depth"] == 2
        finally:
            srv.stop()

    @pytest.mark.parametrize("kw,match", [
        ({"timeout_s": 0.0}, "timeout_s"),
        ({"timeout_s": -1.0}, "timeout_s")])
    def test_submit_validation(self, tiny, kw, match):
        _ref, port = tiny
        srv = _server(port)
        try:
            with pytest.raises(ValueError, match=match):
                srv.submit([1, 2], **kw)
        finally:
            srv.stop()

    @pytest.mark.parametrize("kw,err,match", [
        ({"shed_queue_depth": 0}, ValueError, "shed_queue_depth"),
        ({"recovery": 3}, TypeError, "recovery"),
        ({"journal": 5}, TypeError, "journal"),
        ({"tier_prefetch": True}, ValueError, "tier_prefetch")])
    def test_constructor_validation(self, tiny, kw, err, match):
        _ref, port = tiny
        with pytest.raises(err, match=match):
            _server(port, **kw)


class TestJournalRecovery:
    def test_kill_and_restart_loses_zero_accepted_requests(self, tiny,
                                                           tmp_path):
        """kill() with request 0 done, request 1 mid-decode and request
        2 queued; a fresh server over the same journal re-admits 1 and
        2, and every output equals the run that never crashed (prefix
        cache on)."""
        _ref, port = tiny
        prompts = [np.array([1, 2, 3], np.int32),
                   np.array([9, 8, 7, 6], np.int32),
                   np.array([5, 5, 2], np.int32)]
        kw = {"max_slots": 1, "max_new_tokens": 8,
              "enable_prefix_cache": True}
        ref_res, _, _ = _run_port(port, [(p, {}) for p in prompts], kw)
        jp = tmp_path / "session.jsonl"
        a = _server(port, journal=str(jp), **kw)
        cb, seen, reached = _kill_at(a, 2)
        futs = [a.submit(prompts[0]), a.submit(prompts[1], on_token=cb),
                a.submit(prompts[2])]
        a.start()
        assert reached.wait(120)
        a.kill()
        out0 = futs[0].result(timeout=1)
        assert not futs[1].done() and not futs[2].done()
        j = SessionJournal(jp)
        live = {e["rid"]: e for e in j.interrupted()}
        assert len(live) == 2
        assert sorted(len(e["gen0"]) for e in live.values()) == [0, 2]
        j.close()
        b = _server(port, journal=str(jp), **kw)
        recovered = b.recover_from_journal()
        assert set(recovered) == set(live)
        b.start()
        try:
            outs = {rid: f.result(timeout=300)
                    for rid, f in recovered.items()}
            rel = b.stats()["reliability"]
        finally:
            b.stop()
        assert rel["resumes"] == 1  # request 1; request 2 starts fresh
        rids = sorted(live, key=lambda r: int(r[1:]))
        got = [out0, outs[rids[0]], outs[rids[1]]]
        for (_, want), have in zip(ref_res, got):
            np.testing.assert_array_equal(want, have)
        j2 = SessionJournal(jp)
        assert j2.interrupted() == []
        j2.close()

    def test_recovered_request_keeps_seed_and_sampling(self, tiny,
                                                       tmp_path):
        from paddle_tpu_torch.sampling import SamplingParams

        _ref, port = tiny
        sp = SamplingParams(temperature=0.8, top_p=0.9, seed=77)
        ids = np.array([3, 1, 4, 1, 5], np.int32)
        kw = {"max_slots": 1, "max_new_tokens": 8,
              "enable_prefix_cache": True}
        ref_res, _, _ = _run_port(port, [(ids, {"sampling": sp})], kw)
        jp = tmp_path / "s.jsonl"
        a = _server(port, journal=str(jp), **kw)
        cb, seen, reached = _kill_at(a, 3)
        a.submit(ids, sampling=sp, on_token=cb)
        a.start()
        assert reached.wait(120)
        a.kill()
        b = _server(port, journal=str(jp), **kw)
        recovered = b.recover_from_journal()
        b.start()
        try:
            out = list(recovered.values())[0].result(timeout=300)
        finally:
            b.stop()
        np.testing.assert_array_equal(out, ref_res[0][1])
        np.testing.assert_array_equal(out[ids.size:ids.size + len(seen)],
                                      np.asarray(seen))

    def test_completed_request_with_lost_done_record_resolves(
            self, tiny, tmp_path):
        _ref, port = tiny
        jp = tmp_path / "s.jsonl"
        j = SessionJournal(jp)
        j.record_accept(_FakeReq("p9999", [1, 2], budget=2, seed=5))
        j.record_token("p9999", 11)
        j.record_token("p9999", 12)
        j.close()
        b = _server(port, journal=str(jp))
        recovered = b.recover_from_journal()
        out = recovered["p9999"].result(timeout=5)  # no start() needed
        np.testing.assert_array_equal(out, [1, 2, 11, 12])
        b.stop()

    def test_recover_without_journal_raises(self, tiny):
        _ref, port = tiny
        srv = _server(port)
        with pytest.raises(ValueError, match="no journal"):
            srv.recover_from_journal()
        srv.stop()


class TestJournalRecoveryWithPrefixCache:
    def test_recovery_attaches_published_prefix_mid_block(self, tiny,
                                                          tmp_path):
        """block 4, prompt 10: the warmed index holds 2 full blocks + a
        fill-2 tail, so the recovered admission attaches 9 = 8 + 1
        tokens (the len - 1 cap) and prefills one."""
        _ref, port = tiny
        prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int32)
        kw = {"max_new_tokens": 6, "enable_prefix_cache": True,
              "max_prompt_len": 16}
        ref_res, _, _ = _run_port(port, [(prompt, {})], kw)
        jp = tmp_path / "pfx.jsonl"
        a = _server(port, journal=str(jp), **kw)
        fut = a.submit(prompt)           # never started: queued
        a.kill()                         # crash before any prefill
        assert not fut.done()
        b = _server(port, journal=str(jp), **kw)
        b.start()
        try:
            b.submit(prompt).result(timeout=300)
            pc0 = b.cache.stats()["prefix_cache"]
            pre0 = b.stats()["prefill_dispatches"]
            (out,) = [f.result(timeout=300)
                      for f in b.recover_from_journal().values()]
            pc1 = b.cache.stats()["prefix_cache"]
            pre1 = b.stats()["prefill_dispatches"]
        finally:
            b.stop()
        np.testing.assert_array_equal(ref_res[0][1], out)
        assert pc1["lookups"] == pc0["lookups"] + 1
        assert pc1["hits"] == pc0["hits"] + 1
        assert pc1["hit_tokens"] - pc0["hit_tokens"] == 9
        assert pre1 - pre0 == 1

    def test_recovery_warm_attach_with_generated_tokens(self, tiny,
                                                        tmp_path):
        """A session killed MID-decode is re-admitted warm: the
        restarted server holds the prompt + emitted tokens in its
        prefix index (published here by serving that sequence as a
        prompt), so the resumed request attaches all but its last
        position and rejoins decode with ZERO prefill."""
        _ref, port = tiny
        prompt = np.array([7, 2, 7, 2, 7, 2], np.int32)
        kw = {"max_new_tokens": 8, "enable_prefix_cache": True}
        ref_res, _, _ = _run_port(port, [(prompt, {})], kw)
        jp = tmp_path / "warm.jsonl"
        a = _server(port, journal=str(jp), **kw)
        cb, seen, reached = _kill_at(a, 3)
        fut = a.submit(prompt, on_token=cb)
        a.start()
        assert reached.wait(120)
        a.kill()
        assert not fut.done()
        (ent,) = SessionJournal(jp).interrupted()
        assert ent["gen0"] == seen[:len(ent["gen0"])]
        b = _server(port, **kw)
        b.start()
        try:
            b.submit(np.concatenate([prompt, np.asarray(ent["gen0"],
                                                        np.int32)]),
                     max_new_tokens=1).result(timeout=300)
            pre0 = b.stats()["prefills"]
            out = b.admit_journal_entry(ent).result(timeout=300)
            st = b.stats()
        finally:
            b.stop()
        np.testing.assert_array_equal(ref_res[0][1], out)
        assert st["prefills"] - pre0 == 0  # warm attach: ZERO prefill
        assert st["reliability"]["warm_resumes"] == 1

    @pytest.mark.parametrize("mode", ["split", "async"])
    def test_ladder_resume_is_warm_with_prefix_cache(self, tiny, mode):
        """The recovery ladder publishes a decode-phase request's
        durable prefix at swap-out; its resume attaches it and skips
        the prefill (one prefill for the whole request)."""
        _ref, port = tiny
        kw = {"enable_prefix_cache": True, "max_slots": 1,
              "max_new_tokens": 8}
        if mode == "async":
            kw.update(unified_round=True, async_rounds=True)
        ids = np.array([1, 2, 3, 4, 5], np.int32)
        ref_res, _, _ = _run_port(port, [(ids, {})], kw)
        seam = "unified_round:3" if mode == "async" else "decode:2"
        res, st, health = _run_port(port, [(ids, {})],
                                    dict(kw, fault_plan=seam))
        _same_tokens(ref_res, res)
        assert st["reliability"]["resumes"] == 1
        assert st["reliability"]["warm_resumes"] == 1
        assert st["prefills"] == 1
        assert health[0] == "ok"


class TestChaosParityGate:
    """Every applicable seam fires at least once over the composed
    stack; every request that is not quarantined equals the fault-free
    run."""

    def _work(self):
        from paddle_tpu_torch.sampling import SamplingParams

        sink = []
        return [
            (np.tile(np.array([5, 6, 7], np.int32), 4), {}),
            (np.array([40, 2, 31, 9], np.int32),
             {"on_token": lambda t, r: sink.append(t)}),
            (np.array([8, 8, 1], np.int32),
             {"sampling": SamplingParams(temperature=0.8, top_p=0.9,
                                         seed=77)}),
            (np.array([12, 13], np.int32),
             {"sampling": SamplingParams(stop_strings=("zqz!",))}),
        ]

    def test_split_composed_stack_survivor_parity(self, tiny):
        _ref, port = tiny
        kw = {"enable_prefix_cache": True, "speculation": True,
              "detokenize": _detok, "max_new_tokens": 8, "max_slots": 3}
        ref_res, _, _ = _run_port(port, self._work(), kw)
        plan = FaultPlan.parse(
            "prefill:1,decode:0,verify:0,ensure_many:2,"
            "slow_dispatch:0,detokenize:1,stream_consumer:0")
        res, st, health = _run_port(port, self._work(),
                                    dict(kw, fault_plan=plan))
        fired = plan.fired()
        for seam in ("prefill", "decode", "verify", "ensure_many",
                     "slow_dispatch", "detokenize", "stream_consumer"):
            assert fired.get(seam, 0) >= 1, (seam, fired)
        survivors = 0
        for (_, want), (kind, have) in zip(ref_res, res):
            if kind != "ok":
                assert kind == "QuarantinedRequest", (kind, have)
                continue
            survivors += 1
            np.testing.assert_array_equal(want, have)
        assert survivors >= 3
        assert health[0] == "ok"
        rel = st["reliability"]
        assert rel["faults_injected"] >= 7
        assert rel["recoveries"] >= 1

    def test_unified_async_quantized_stack_survivor_parity(self, tiny):
        _ref, port = tiny
        kw = {"enable_prefix_cache": True, "unified_round": True,
              "async_rounds": True, "quantization": "w8a16",
              "kv_dtype": "int8", "max_new_tokens": 6, "max_slots": 2}
        ref_res, _, _ = _run_port(port, TWO, kw)
        plan = FaultPlan.parse("unified_round:1,ensure_many:3")
        res, st, health = _run_port(port, TWO, dict(kw, fault_plan=plan))
        _same_tokens(ref_res, res)
        assert plan.fired().get("unified_round", 0) >= 1
        assert plan.fired().get("ensure_many", 0) >= 1
        assert st["reliability"]["recoveries"] >= 1
        assert health[0] == "ok"


# ---- cross-engine twins -------------------------------------------------------

class TestAgainstTheReference:
    @pytest.mark.parametrize("plan,srv_kw", [
        ("decode:1", {}),
        ("prefill:0,prefill:1,prefill:2", {}),
        ("ensure_many:0,detokenize:0,decode:3",
         {"detokenize": _detok, "enable_prefix_cache": True}),
        ("decode:0,decode:1,decode:2", {"enable_prefix_cache": True}),
        ("decode:0,decode:1,decode:2", {}),
    ], ids=["transient", "persistent", "composed", "decode-warm",
            "decode-cold"])
    def test_same_plan_same_outcomes(self, tiny, plan, srv_kw):
        """The port's and the reference's servers under the same plan
        and work: each request's outcome (ok, or QuarantinedRequest at
        the same seam after the same failures) and tokens, and the
        ladder's counters, are the reference's."""
        from paddle_tpu.reliability import FaultPlan as RefPlan
        from paddle_tpu.sampling import SamplingParams as RefSP

        from paddle_tpu_torch.sampling import SamplingParams

        ref, port = tiny
        stop = ("zq!",)
        work_p = [(np.array([1, 2, 3], np.int32),
                   {"sampling": SamplingParams(stop_strings=stop)}
                   if "detokenize" in srv_kw else {}),
                  (np.array([4, 5, 6, 7], np.int32), {})]
        work_r = [(ids, {"sampling": RefSP(stop_strings=stop)}
                   if kw else {}) for ids, kw in work_p]
        res_p, st_p, h_p = _run(
            _server(port, fault_plan=FaultPlan.parse(plan), **srv_kw),
            work_p)
        res_r, st_r, h_r = _run(
            _ref_server(ref, fault_plan=RefPlan.parse(plan), **srv_kw),
            work_r)
        assert [k for k, _ in res_p] == [k for k, _ in res_r]
        for (kind, a), (_, b) in zip(res_p, res_r):
            if kind == "ok":
                np.testing.assert_array_equal(a, b)
            else:
                assert (a.seam, a.failures) == (b.seam, b.failures)
                assert str(a.cause) == str(b.cause)
        for key in ("faults_injected", "dispatch_retries", "recoveries",
                    "quarantined"):
            assert st_p["reliability"][key] == st_r["reliability"][key], \
                key
        assert h_p[0] == h_r[0]

    def test_reference_journal_recovers_on_the_port(self, tiny, tmp_path):
        """The reference's server journals 3 requests and is killed
        with request 1 mid-decode; the port's server, over that file,
        completes the interrupted requests with the reference's
        uninterrupted tokens."""
        ref, port = tiny
        prompts = [np.array([1, 2, 3], np.int32),
                   np.array([9, 8, 7, 6], np.int32),
                   np.array([5, 5, 2], np.int32)]
        kw = {"max_slots": 1, "max_new_tokens": 8}
        want, _, _ = _run(_ref_server(ref, **kw),
                          [(p, {}) for p in prompts])
        jp = tmp_path / "ref.jsonl"
        a = _ref_server(ref, journal=str(jp), **kw)
        cb, seen, reached = _kill_at(a, 2)
        futs = [a.submit(prompts[0]), a.submit(prompts[1], on_token=cb),
                a.submit(prompts[2])]
        a.start()
        assert reached.wait(300)
        a.kill()
        out0 = futs[0].result(timeout=1)
        b = _server(port, journal=str(jp), **kw)
        recovered = b.recover_from_journal()
        assert len(recovered) == 2
        b.start()
        try:
            outs = {rid: f.result(timeout=300)
                    for rid, f in recovered.items()}
        finally:
            b.stop()
        rids = sorted(outs, key=lambda r: int(r[1:]))
        for (_, w), have in zip(want, [out0] + [outs[r] for r in rids]):
            np.testing.assert_array_equal(w, have)


# ---- the front door and streams ----------------------------------------------

class TestFrontDoorAndStreams:
    def test_quarantined_stream_reason(self, tiny):
        from paddle_tpu_torch.frontend.stream import StreamHandle

        _ref, port = tiny
        srv = _server(port, max_slots=1, fault_plan=FaultPlan.parse(
            "prefill:0,prefill:1,prefill:2"))
        handle = StreamHandle()
        srv.start()
        try:
            fut = srv.submit([1, 2, 3], on_token=handle._on_token)
            handle._bind(fut)
            events = list(handle)
            assert events and events[-1].done
            assert events[-1].stop_reason == "quarantined"
            assert handle.stop_reason == "quarantined"
            with pytest.raises(QuarantinedRequest):
                fut.result(timeout=10)
        finally:
            srv.stop()

    def test_resident_timeout_terminates_its_stream(self, tiny):
        """The stream half of a resident timeout: the handle ends with
        reason "timeout" and the freed slot keeps serving. The deadline
        passes inside the request's own stream (its callback sleeps past
        it at the first token), so nothing races the engine."""
        from paddle_tpu_torch.frontend.stream import StreamHandle

        _ref, port = tiny
        srv = _server(port, max_slots=1, max_new_tokens=64,
                      max_prompt_len=32)
        handle = StreamHandle()
        seen = []

        def slow(tok, reason):
            handle._on_token(tok, reason)
            seen.append(tok)
            if len(seen) == 1:
                time.sleep(0.3)  # past timeout_s: expires next round

        srv.start()
        try:
            fut = srv.submit([1, 2, 3], max_new_tokens=64, timeout_s=0.2,
                             on_token=slow)
            handle._bind(fut)
            with pytest.raises(RequestTimeout) as ei:
                fut.result(timeout=300)
            assert ei.value.timeout_s == pytest.approx(0.2)
            evs = list(handle)
            assert evs and evs[-1].done
            assert handle.stop_reason == "timeout"
            assert srv.stats()["kv_cache"]["sequences"] == 0
            assert srv.submit([7, 8], max_new_tokens=2) \
                .result(timeout=300).size == 4
        finally:
            srv.stop()

    def test_timeout_scan_covers_scheduler_queues(self, tiny):
        """A request queued in the scheduler's lanes (not the FIFO
        queue) is expired by the engine's timeout scan. It is queued
        while the occupier is held at its first token and released only
        after its deadline."""
        from paddle_tpu_torch.frontend import FrontDoor

        _ref, port = tiny
        fd = FrontDoor(port, max_slots=1, block_size=4, max_prompt_len=24,
                       max_new_tokens=16, device="cpu")
        fd.start()
        try:
            cb, reached, go = hold_at(1)
            a = fd.submit([1, 2, 3], lane="batch", max_new_tokens=16,
                          on_token=cb)
            assert reached.wait(120)
            b = fd.submit([4, 5, 6], lane="batch", timeout_s=0.005)
            time.sleep(0.05)  # b is past its deadline before a resumes
            go.set()
            with pytest.raises(RequestTimeout):
                b.result(timeout=300)
            assert b.stop_reason == "timeout"
            assert a.result(timeout=300).size == 19
            assert fd.stats()["reliability"]["timeouts"] == 1
        finally:
            fd.stop()

    def test_stream_iterator_timeout(self):
        """A dead engine never hangs a consumer: iterating a stream with
        timeout_s raises TimeoutError when no event arrives."""
        from paddle_tpu_torch.frontend.stream import StreamHandle

        handle = StreamHandle(timeout_s=0.15)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="no event"):
            for _ in handle:
                pass
        assert time.monotonic() - t0 < 10
        with pytest.raises(ValueError, match="timeout_s"):
            StreamHandle(timeout_s=0.0)

    def test_frontdoor_preemption_with_faults_survivor_parity(self, tiny):
        """Preemption under injected dispatch faults: both requests give
        the fault-free run's tokens (and the reference's), and the
        ladder recovered. The batch request holds the one slot at its
        first token until the interactive one is queued."""
        from paddle_tpu.frontend import FrontDoor as RefFrontDoor

        from paddle_tpu_torch.frontend import FrontDoor

        ref, port = tiny

        def run(cls, model, fault_plan=None, **kw):
            fd = cls(model, max_slots=1, block_size=4, max_prompt_len=24,
                     max_new_tokens=8, preempt_wait_tokens=0,
                     fault_plan=fault_plan, **kw)
            fd.start()
            try:
                cb, reached, go = hold_at(1)
                hb = fd.submit([4, 5, 6, 7], lane="batch",
                               max_new_tokens=8, on_token=cb)
                assert reached.wait(120)
                hi = fd.submit([1, 2, 3], lane="interactive",
                               max_new_tokens=4)
                go.set()
                outs = [hb.result(timeout=300), hi.result(timeout=300)]
                st = fd.stats()
            finally:
                fd.stop()
            return outs, st

        want, st0 = run(FrontDoor, port, device="cpu")
        out, st = run(FrontDoor, port, FaultPlan.parse("decode:2,prefill:1"),
                      device="cpu")
        for a, b in zip(want, out):
            np.testing.assert_array_equal(a, b)
        assert st0["frontdoor"]["preemptions"] >= 1
        assert st["reliability"]["faults_injected"] == 2
        assert st["reliability"]["recoveries"] >= 1
        ref_out, _ = run(RefFrontDoor, ref)
        for a, b in zip(ref_out, out):
            np.testing.assert_array_equal(a, b)
