"""Disaggregated prefill/decode pools + fleet-level SLO lanes: the
port's copy of `paddle_tpu.fleet.disagg`.

Real serving fleets burst on PREFILL (long prompts arriving together)
while decode throughput stays steady; one mixed pool lets a prefill
burst stall every resident decode stream. `DisaggRouter` splits the
fleet into a PREFILL pool and a DECODE pool so the two phases scale
independently:

  * fresh sessions place on the prefill pool (packed ragged prefill —
    the chunk-plan seam — runs where prompts queue);
  * once a session's first token(s) stream, a dedicated handoff
    thread moves it to the least-loaded decode replica via the
    UNCHANGED `migrate_session` — the session's published K/V
    chain crosses the wire as the int8 codec bytes and
    warm-attaches on the decode side with ZERO prefill recompute;
  * failover, journaling and token parity are inherited untouched: a
    handoff IS a planned migration, so a crash at any point falls
    back to journal replay exactly like the paths.

Placement steering happens entirely ABOVE the router's logic: the
subclass pins each `_dispatch`'s candidate set to the session's phase
pool (no tokens yet -> prefill, streaming -> decode) and degrades to
the whole fleet when the preferred pool has nothing routable — the
journal/failover/migration machinery is the base class's, unmodified.

`FleetLanes` composes the `LaneScheduler` ABOVE placement:
fleet-wide tenant fairness / SLO lanes decide ADMISSION ORDER before
any replica is chosen, so an interactive request admits ahead of a
batch backlog regardless of which replica either would land on.
Requests wait in the lane queues until fleet slot capacity frees;
`AdmissionShed` from the router requeues (front) and retries.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from ..observability import log as _obs_log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..reliability.errors import AdmissionShed
from .router import FleetRouter

_logger = _obs_log.get_logger(__name__)

_m_handoffs = _metrics.counter(
    "disagg_handoffs_total",
    "Prefill->decode session handoffs by outcome",
    labelnames=("outcome",))
_m_handoff_tokens = _metrics.counter(
    "disagg_handoff_kv_tokens_total",
    "KV-chain tokens moved prefill->decode over the migration wire")
_m_pool_size = _metrics.gauge(
    "disagg_pool_replicas", "Replicas per disaggregated pool",
    labelnames=("pool",))


class DisaggRouter(FleetRouter):
    """`FleetRouter` over two pools with phase-steered placement.

    prefill / decode: iterables of `Replica` (in-process or
        `RemoteReplica`) — names must be unique fleet-wide.
    handoff_after_tokens: tokens a session must have streamed before
        it moves to the decode pool (>= 1; the first token proves the
        prefill finished and the K/V chain is publishable).
    handoff_poll_s: handoff thread scan cadence.

    Every other kwarg is `FleetRouter`'s. The base class's journal,
    failover and migration logic run unchanged — this subclass only
    narrows placement candidates and drives planned migrations.
    """

    def __init__(self, prefill, decode, *, handoff_after_tokens=1,
                 handoff_poll_s=0.01, **kw):
        prefill = list(prefill)
        decode = list(decode)
        if not prefill or not decode:
            raise ValueError("DisaggRouter needs >= 1 prefill and "
                             ">= 1 decode replica")
        if int(handoff_after_tokens) < 1:
            raise ValueError(f"handoff_after_tokens must be >= 1, "
                             f"got {handoff_after_tokens}")
        super().__init__(prefill + decode, **kw)
        self.prefill_pool = frozenset(
            r.name for r in self.replicas[:len(prefill)])
        self.decode_pool = frozenset(
            r.name for r in self.replicas[len(prefill):])
        self.handoff_after_tokens = int(handoff_after_tokens)
        self.handoff_poll_s = float(handoff_poll_s)
        self._phase = threading.local()
        self._handed = set()          # rids already handed off
        self._handoffs_ok = 0
        self._handoffs_failed = 0
        self._handoffs_early = 0
        self._handoff_thread = None
        self._handoff_wake = threading.Event()
        if _metrics.enabled():
            _m_pool_size.labels(pool="prefill").set(len(prefill))
            _m_pool_size.labels(pool="decode").set(len(decode))

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        super().start()
        # DEDICATED thread: a handoff exports K/V via run_host_op,
        # which deadlocks from an engine callback — never trigger a
        # migration from on_token
        self._handoff_thread = threading.Thread(
            target=self._handoff_loop, daemon=True,
            name="disagg-handoff")
        self._handoff_thread.start()
        return self

    def stop(self):
        self._stop = True
        self._handoff_wake.set()
        if self._handoff_thread is not None:
            self._handoff_thread.join(timeout=10)
            self._handoff_thread = None
        super().stop()

    # ---- phase-steered placement ---------------------------------------
    def _dispatch(self, sess, first=False):
        # a session with no tokens yet NEEDS a prefill wherever it
        # lands -> prefill pool; a streaming session is decode-phase
        # work (a failover re-prefills from the journal on the decode
        # side — availability over placement purity)
        self._phase.pool = (self.prefill_pool if not sess.toks
                            else self.decode_pool)
        try:
            return super()._dispatch(sess, first=first)
        finally:
            self._phase.pool = None

    def _place(self, ids, exclude=(), now=None):
        pool = getattr(self._phase, "pool", None)
        if pool:
            outside = {r for r in self.replicas if r.name not in pool}
            rep, match = super()._place(
                ids, exclude=set(exclude) | outside, now=now)
            if rep is not None:
                return rep, match
            # preferred pool has nothing routable: degrade to the
            # whole fleet rather than refuse (disagg is a perf
            # topology, not an availability boundary)
        return super()._place(ids, exclude=exclude, now=now)

    # ---- the prefill -> decode handoff ---------------------------------
    def _pick_decode(self, exclude=()):
        now = time.monotonic()
        pool = [r for r in self.replicas
                if r.name in self.decode_pool and r not in exclude
                and not r.dead
                and r.health.routing_weight(now) > 0.0]
        return min(pool, key=lambda r: r.load(), default=None)

    def _handoff_loop(self):
        while not self._stop:
            self._handoff_wake.wait(self.handoff_poll_s)
            self._handoff_wake.clear()
            if self._stop:
                return
            with self._lock:
                cands = [
                    s for s in self._sessions.values()
                    if not s.done and s.replica is not None
                    and s.replica.name in self.prefill_pool
                    and len(s.toks) >= self.handoff_after_tokens
                    and s.rid not in self._handed]
            for sess in cands:
                if self._stop:
                    return
                self._handoff(sess)

    def _handoff(self, sess):
        target = self._pick_decode(exclude={sess.replica})
        if target is None:
            return  # no decode capacity right now: retry next scan
        self._handed.add(sess.rid)
        with self._lock:
            source = sess.replica
            moved_tokens = len(sess.ids) + len(sess.toks)
        try:
            moved_to = self.migrate_session(sess.rid,
                                            target=target.name)
        except KeyError:
            # finished (or failed over) between the scan and now
            with self._lock:
                self._handoffs_early += 1
            if _metrics.enabled():
                _m_handoffs.labels(outcome="finished_early").inc()
            return
        except Exception as e:  # noqa: BLE001 — session still lives:
            # migrate_session's own fallbacks (journal replay,
            # failover) kept it running wherever it is
            with self._lock:
                self._handoffs_failed += 1
            if _metrics.enabled():
                _m_handoffs.labels(outcome="failed").inc()
            _logger.warning("disagg handoff of %s failed (%s)",
                            sess.rid, e)
            return
        with self._lock:
            self._handoffs_ok += 1
        if _metrics.enabled():
            _m_handoffs.labels(outcome="ok").inc()
            _m_handoff_tokens.inc(moved_tokens)
        _tracing.event(
            "disagg_handoff", request_id=sess.rid,
            source=source.name if source is not None else None,
            to=moved_to, kv_tokens=moved_tokens,
            **sess._tr(replica=moved_to))

    # ---- introspection -------------------------------------------------
    def stats(self):
        st = super().stats()
        with self._lock:
            st["disagg"] = {
                "prefill_pool": sorted(self.prefill_pool),
                "decode_pool": sorted(self.decode_pool),
                "handoffs": self._handoffs_ok,
                "handoffs_failed": self._handoffs_failed,
                "handoffs_finished_early": self._handoffs_early,
            }
        return st


class _LaneReq:
    """The light request shape `LaneScheduler` reads (meta, ids,
    budget, t_submit) plus what the dispatcher needs to forward it."""

    __slots__ = ("ids", "budget", "meta", "t_submit", "future",
                 "kwargs", "_fd_charged")

    def __init__(self, ids, budget, meta, kwargs):
        self.ids = ids
        self.budget = int(budget)
        self.meta = meta
        self.t_submit = time.perf_counter()
        self.future = Future()
        self.kwargs = kwargs
        self._fd_charged = False


class FleetLanes:
    """The `LaneScheduler` composed ABOVE fleet placement.

    router: a started `FleetRouter` (or `DisaggRouter`).
    scheduler: a `frontend.LaneScheduler` (tenant configs, lane
        weights, rate buckets — all its policy knobs apply fleet-wide
        here).
    max_inflight: dispatched-but-unfinished cap; None = the fleet's
        total engine slots (sum of `max_slots`). Admission order is
        decided by the lanes while requests WAIT here — once
        dispatched, per-replica scheduling is the engine's own.

    `submit` returns a Future resolving exactly like
    `FleetRouter.submit`'s. Stop the composition (not the router)
    with `stop()`; queued-but-undispatched requests fail with
    RuntimeError.
    """

    def __init__(self, router, scheduler, *, max_inflight=None):
        self.router = router
        self.sched = scheduler
        self._max_inflight = (
            int(max_inflight) if max_inflight is not None
            else sum(r.server.max_slots for r in router.replicas))
        if self._max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._inflight = 0
        self._dispatched = 0
        self._shed_retries = 0
        self._stop = False
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="fleet-lanes")
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            stranded = self.sched.drain()
        for req in stranded:
            req.future.set_exception(
                RuntimeError("fleet lanes stopped"))

    def submit(self, ids, max_new_tokens=None, sampling=None, *,
               meta=None, on_token=None, timeout_s=None,
               trace_ctx=None):
        if self._stop:
            raise RuntimeError("fleet lanes stopped")
        ids = np.asarray(ids, np.int32).reshape(-1)
        budget = max_new_tokens
        if budget is None and sampling is not None:
            budget = sampling.max_new_tokens
        if budget is None:
            budget = self.router.replicas[0].server.max_new
        req = _LaneReq(ids, budget, meta, {
            "max_new_tokens": max_new_tokens, "sampling": sampling,
            "on_token": on_token, "timeout_s": timeout_s,
            "trace_ctx": trace_ctx})
        with self._lock:
            # may raise QueueFull / unknown lane / unknown tenant —
            # eager, like the engine's own front door
            self.sched.on_submit(req, time.perf_counter())
        self._wake.set()
        return req.future

    # ---- dispatcher ----------------------------------------------------
    def _dispatch_loop(self):
        while not self._stop:
            self._wake.wait(0.02)  # rate buckets refill on wall time
            self._wake.clear()
            while not self._stop:
                now = time.perf_counter()
                with self._lock:
                    if self._inflight >= self._max_inflight:
                        break
                    req = self.sched.next_request(now)
                    if req is None:
                        break
                    self.sched.pop(req, now)
                    self._inflight += 1
                if not self._forward(req):
                    break

    def _forward(self, req):
        try:
            fut = self.router.submit(req.ids, meta=req.meta,
                                     **req.kwargs)
        except AdmissionShed:
            # the fleet itself is saturated: requeue at the FRONT
            # (its bucket charge is not repeated) and back off
            with self._lock:
                self._inflight -= 1
                self._shed_retries += 1
                self.sched.requeue(req, time.perf_counter())
            return False
        except BaseException as e:  # noqa: BLE001 — terminal reject
            with self._lock:
                self._inflight -= 1
            req.future.set_exception(e)
            return True
        with self._lock:
            self._dispatched += 1
        fut.add_done_callback(lambda f, r=req: self._done(r, f))
        return True

    def _done(self, req, fut):
        with self._lock:
            self._inflight -= 1
        self._wake.set()
        exc = fut.exception()
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(fut.result())

    def stats(self):
        with self._lock:
            return {
                "depth": self.sched.depth(),
                "lane_depths": self.sched.lane_depths(),
                "inflight": self._inflight,
                "max_inflight": self._max_inflight,
                "dispatched": self._dispatched,
                "shed_retries": self._shed_retries,
                "window": self.sched.window_stats(),
            }
