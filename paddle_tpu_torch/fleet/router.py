"""`FleetRouter` — replicated serving engines behind a failover front
door: the port's copy of `paddle_tpu.fleet.router`.

The tier above one engine: N `PagedGenerationServer` replicas (each
with its own pool, journal and ops plane) behind an async router that
makes replica failure a recoverable, TESTED path instead of a
session-losing one. Four layers:

  * REPLICA STATE MACHINE (`fleet.health`): active liveness/readiness
    probes (the split /healthz views) plus passive dispatch
    outcomes drive ok -> degraded -> circuit-open per replica, with
    capped-backoff half-open probing; routing weight follows state,
    and at most the one implicated replica degrades per failure.
  * FAILOVER WITHOUT TOKEN DIVERGENCE: every accepted request is
    journaled AT THE ROUTER — prompt, RESOLVED seed, sampling,
    budget, then every delivered token (`SessionJournal` semantics,
    reused verbatim). When a replica dies mid-stream, its unfinished
    sessions re-admit on survivors via
    `PagedGenerationServer.admit_journal_entry` — the engine resumes
    at PRNG step len(gen0), so the completed output is
    TOKEN-IDENTICAL to a run that was never interrupted (the
    preempt/resume parity property, now across engines) and the
    stream keeps delivering from the next undelivered token.
  * PLANNED MIGRATION (`migrate_session`): the source engine swap-outs
    and publishes the live session (`export_session`), its K/V blocks
    cross the wire as bytes (`fleet.migration`, int8 codes + scales
    ride along) and re-publish on the target
    (`import_kv_payload`), so the re-admission warm-attaches with
    ZERO prefill recompute; a dead source degrades to journal replay
    automatically.
  * FLEET FRONT DOOR: prefix-aware placement (route to the replica
    whose content-addressed cache holds the longest prefix —
    `PagedKVCache.match_prefix_len`, the signal — least-loaded
    tiebreak), per-request retry across replicas with
    `AdmissionShed.retry_after_s` propagation, global shed when every
    replica is saturated, and /metrics federation over the
    per-replica exporters with a `replica` label
    (`fleet.federation`).

Chaos: `fault_plan=` installs a deterministic plan whose
`replica_kill` seam the router polls once per placement — when it
fires, the chosen replica is hard-killed (`kill()`, no futures
resolved) and its sessions fail over; engine seams point at
individual replicas through their own plans.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time

import numpy as np

from ..observability import log as _obs_log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..observability.slo import SLOEngine
from ..observability.trace_context import TraceContext
from ..reliability import (AdmissionShed, QuarantinedRequest,
                           ReplicaUnavailable, RequestTimeout,
                           SessionJournal, resolve_fault_plan)
from ..sampling import SamplingParams
from .federation import federate_metrics
from .migration import deserialize_kv_payload, serialize_kv_payload
from .replica import Replica

_logger = _obs_log.get_logger(__name__)

_m_requests = _metrics.counter(
    "fleet_requests_total",
    "requests the router placed, by replica (initial placement only; "
    "failover re-placements count in fleet_failover_sessions_total)",
    labelnames=("replica",))
_m_prefix_routed = _metrics.counter(
    "fleet_prefix_routed_total",
    "placements that followed the prefix-cache signal (the chosen "
    "replica already held >= 1 cached token of the prompt)")
_m_failovers = _metrics.counter(
    "fleet_failovers_total",
    "replica-level failover events: a replica died (or was killed) "
    "and its unfinished sessions were re-admitted on survivors")
_m_failover_sessions = _metrics.counter(
    "fleet_failover_sessions_total",
    "sessions re-admitted on a survivor via router-journal replay "
    "(token-identical resume at PRNG step len(gen0))")
_m_migrations = _metrics.counter(
    "fleet_migrations_total",
    "planned session migrations (export_session -> wire -> "
    "import + warm re-admission; journal replay when the source was "
    "already gone)")
_m_kills = _metrics.counter(
    "fleet_replica_kills_total",
    "replicas hard-killed by the router's replica_kill fault seam "
    "(chaos testing — opt-in via fault_plan=)")
_m_sheds = _metrics.counter(
    "fleet_sheds_total",
    "submissions refused because every routable replica was saturated "
    "(global admission shed, retry_after_s propagated)")
_m_retries = _metrics.counter(
    "fleet_submit_retries_total",
    "submissions retried on another replica after the first choice "
    "refused (engine shed / stopped)")
_m_probes = _metrics.counter(
    "fleet_probes_total",
    "active replica probes by outcome (ok | not_ready | dead)",
    labelnames=("replica", "outcome"))
_m_state = _metrics.gauge(
    "fleet_replica_state",
    "replica state machine position (0 ok, 1 degraded, 2 open/"
    "half_open, 3 not_ready, 4 dead)", labelnames=("replica",))
_m_replicas = _metrics.gauge(
    "fleet_replicas",
    "current routing-set size (dynamic membership)")
_m_added = _metrics.counter(
    "fleet_replicas_added_total",
    "replicas admitted at runtime via add_replica (warm-gated "
    "scale-up actuation)")
_m_removed = _metrics.counter(
    "fleet_replicas_removed_total",
    "replicas retired at runtime via remove_replica (post-drain "
    "scale-down actuation)")

_STATE_CODE = {"ok": 0.0, "degraded": 1.0, "open": 2.0,
               "half_open": 2.0, "not_ready": 3.0, "dead": 4.0}

#: the `stats()["autoscale"]` shape with no autoscaler attached —
#: zeroed-when-disabled, same keys `Autoscaler.stats_block` fills
AUTOSCALE_ZERO = {
    "enabled": False, "ticks": 0, "decisions": 0, "scale_ups": 0,
    "scale_downs": 0, "rebalances": 0, "holds": 0, "errors": 0,
    "migrations": 0, "replica_seconds": 0.0, "last_decision": None,
}

_rids = itertools.count()


class _Session:
    """Router-side record of one accepted request. Attribute names
    mirror the engine `_Req` fields `SessionJournal.entry_for` reads,
    so the same serialization serves journaling, failover and
    migration."""

    __slots__ = ("rid", "ids", "budget", "seed", "sampling", "meta",
                 "timeout_s", "future", "on_token", "toks", "done",
                 "stop_reason", "replica", "epoch", "failovers",
                 "t_submit", "t_first", "trace")

    def __init__(self, rid, ids, budget, seed, sampling, meta,
                 timeout_s, on_token, trace=None):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.seed = seed
        self.sampling = sampling
        self.meta = meta
        self.timeout_s = timeout_s
        from concurrent.futures import Future

        self.future = Future()       # the client-facing future
        self.on_token = on_token
        self.toks: list[int] = []    # tokens delivered so far
        self.done = False
        self.stop_reason = None
        self.replica = None
        self.epoch = 0               # bumped on failover/migration:
        self.failovers = 0           # stale replica callbacks no-op
        self.t_submit = time.perf_counter()
        self.t_first = None
        # causal tracing: minted HERE — the router's
        # context wins over any replica-minted one, so every hop of
        # the session shares one trace_id; bumped with cause
        # "failover"/"migration" as the session moves
        self.trace = trace if trace is not None else TraceContext.mint()

    @property
    def gen0(self):
        return tuple(self.toks)

    def _tr(self, replica=None):
        return self.trace.attrs(replica=replica) \
            if self.trace is not None else {}


class FleetRouter:
    """Failover router over N serving-engine replicas.

    replicas: iterable of `fleet.Replica` (or bare not-yet-started
        `PagedGenerationServer`s, wrapped as replica0..N-1). Build the
        engines with `enable_prefix_cache=True` to get prefix-aware
        placement AND zero-recompute migration; journal-per-replica is
        optional (the ROUTER journal is what failover replays).
    journal: router-level `SessionJournal` (path or instance) — the
        failover source of truth. None disables failover persistence
        (sessions on a dead replica are then re-admitted from the
        router's in-memory mirror, which is the same data — the
        journal adds router-crash recovery via
        `recover_from_journal`).
    seed: fleet seed for auto-derived per-request PRNG seeds (resolved
        AT THE ROUTER so a replayed session samples identically on
        any replica).
    probe_interval_s: active probe cadence (the probe thread also
        notices externally-died replicas and fails their sessions
        over).
    shed_queue_depth: PER-REPLICA queue depth past which — on EVERY
        routable replica — a submit raises `AdmissionShed` with a
        retry hint (global shed). None = never.
    submit_retries: extra replicas to try when the chosen one refuses
        a submit (its own shed, stopping, ...).
    fault_plan: deterministic chaos plan; the router polls its
        `replica_kill` seam once per placement decision. Give the
        router its OWN plan (occurrence counters are plan state).
    detokenize: tokenizer for streamed text deltas (stream=True).
    expose_port: fleet ops endpoint — /metrics serves the FEDERATED
        per-replica page (replica label), /statusz the fleet view,
        /healthz ok|degraded|stalled (stalled = nothing routable),
        /slo the fleet burn-rate report when `slos=` is given.
    slos: iterable of `observability.SLO` (or True for
        `default_slos()`) — the FLEET-level burn-rate engine, fed from router-observed TTFT and session outcomes
        (tagged per lane/tenant/replica). Evaluated every probe pass;
        a replica-scoped SLO in sustained `page`
        (>= slo_degrade_sustain_s of continuous page burn) degrades
        that replica to not_ready via the state machine — the
        "stop routing new work at a latency-burning replica" hook.
    slo_degrade_sustain_s: how long a replica-scoped SLO must page
        continuously before the degrade hook fires.
    capacity_timeout_s: /capacity federation deadline per replica —
        a hung remote replica degrades to an `{"error": ...}` slot
        instead of stalling the snapshot (None = synchronous).
    """

    def __init__(self, replicas, *, journal=None, seed=0,
                 probe_interval_s=1.0, shed_queue_depth=None,
                 submit_retries=2, fault_plan=None, detokenize=None,
                 stream_buffer=256, expose_port=None, slos=None,
                 slo_degrade_sustain_s=2.0, capacity_timeout_s=2.0):
        reps = []
        for i, r in enumerate(replicas):
            if isinstance(r, Replica):
                reps.append(r)
            else:
                reps.append(Replica(f"replica{i}", r))
        if not reps:
            raise ValueError("FleetRouter needs >= 1 replica")
        names = [r.name for r in reps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas = reps
        if isinstance(journal, (str, os.PathLike)):
            journal = SessionJournal(journal)
        elif journal is not None and not isinstance(journal,
                                                    SessionJournal):
            raise TypeError(f"journal must be a SessionJournal or a "
                            f"path, got {type(journal).__name__}")
        self._journal = journal
        self._seed0 = int(seed) & 0xFFFFFFFF
        self._auto_seeds = itertools.count()
        self.probe_interval_s = float(probe_interval_s)
        if shed_queue_depth is not None and int(shed_queue_depth) < 1:
            raise ValueError(f"shed_queue_depth must be >= 1, "
                             f"got {shed_queue_depth}")
        self._shed_depth = (None if shed_queue_depth is None
                            else int(shed_queue_depth))
        self.submit_retries = max(0, int(submit_retries))
        self._faults = resolve_fault_plan(fault_plan)
        self._detok = detokenize
        self._stream_buffer = int(stream_buffer)
        # SLO burn-rate engine: None = every feed site is
        # one `is None` branch (the telemetry discipline)
        if slos is None or slos is False:
            self._slo = None
        elif isinstance(slos, SLOEngine):
            self._slo = slos
        else:
            self._slo = SLOEngine(slos)
        self.slo_degrade_sustain_s = float(slo_degrade_sustain_s)
        # /capacity federation deadline: a HUNG replica (wedged
        # subprocess) degrades to an error slot instead of stalling
        # the snapshot; None = synchronous (never for remote fleets)
        self.capacity_timeout_s = (
            None if capacity_timeout_s is None
            else float(capacity_timeout_s))
        self._slo_degraded: dict[str, float] = {}  # replica -> since
        self._lock = threading.RLock()
        self._sessions: dict[str, _Session] = {}
        self._stop = False
        self._started = False
        self._probe_thread = None
        self._probe_wake = threading.Event()
        # window counters (reset_stats-coherent)
        self._t0 = None
        self._ttft: list[float] = []
        self._tokens_out = 0
        self._requests_done = 0
        self._failovers = 0
        self._failover_sessions = 0
        self._migrations = 0
        self._replica_kills = 0
        self._sheds = 0
        self._retries = 0
        self._prefix_routed = 0
        self._placements = 0
        # dynamic membership: auto-name counter for bare
        # engines admitted at runtime, window counters, and the
        # autoscaler hook (fleet.autoscale.Autoscaler attaches itself
        # so stats()["autoscale"] is live; None = zeroed block)
        self._rep_ids = itertools.count(len(reps))
        self._replicas_added = 0
        self._replicas_removed = 0
        self._autoscaler = None
        self.exporter = None
        self._expose_port = expose_port

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        if self._started:
            return self
        if self._stop:
            raise RuntimeError("router stopped; build a new one")
        self._t0 = time.perf_counter()
        for rep in self.replicas:
            rep.start()
        _m_replicas.set(float(len(self.replicas)))
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="paddle-tpu-fleet-probe")
        self._probe_thread.start()
        self._started = True
        if self._expose_port is not None:
            from ..observability.exporter import OpsEndpoint

            _metrics.REGISTRY.enable()
            self.exporter = OpsEndpoint(
                statusz_fn=self.statusz, healthz_fn=self.health,
                metrics_fn=self.metrics_text,
                slo_fn=(self.slo_report if self._slo is not None
                        else None),
                capacity_fn=self.capacity).start(
                    port=self._expose_port)
        return self

    def stop(self):
        self._stop = True
        self._probe_wake.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
            self._probe_thread = None
        for rep in self.replicas:
            rep.stop()
        with self._lock:
            for sess in self._sessions.values():
                if not sess.done:
                    sess.done = True
                    sess.future.set_exception(
                        RuntimeError("router stopped"))
        if self.exporter is not None:
            self.exporter.stop()
        if self._journal is not None:
            self._journal.flush()

    # ---- placement -----------------------------------------------------
    def _routable(self, now):
        return [r for r in self.replicas
                if not r.dead and r.health.routing_weight(now) > 0.0]

    def _place(self, ids, exclude=(), now=None):
        """Prefix-aware placement: the routable replica holding the
        longest cached prefix of `ids` wins; least-loaded, then
        first-listed, breaks ties. Returns (replica, match_len) or
        (None, 0)."""
        now = time.monotonic() if now is None else now
        best = None
        best_key = None
        best_match = 0
        for idx, rep in enumerate(self.replicas):
            if rep in exclude or rep.dead:
                continue
            if rep.health.routing_weight(now) <= 0.0:
                continue
            match = rep.prefix_match_len(ids)
            key = (match, -rep.load(), -idx)
            if best_key is None or key > best_key:
                best, best_key, best_match = rep, key, match
        return best, best_match

    def _poll_kill_seam(self):
        """The router-level chaos seam: one poll per placement
        decision; a scheduled fault hard-kills the replica just
        chosen and fails its sessions over — the forced mid-stream
        replica death the chaos gate and the bench axis exercise."""
        if self._faults is None:
            return False
        return self._faults.poll("replica_kill") is not None

    def _kill_replica(self, rep, why="injected replica_kill"):
        with self._lock:
            self._replica_kills += 1
        _m_kills.inc()
        _tracing.event("replica_kill", replica=rep.name, why=why)
        _logger.warning("killing replica %s (%s)", rep.name, why)
        rep.kill()
        self._failover_replica(rep, why=why)

    # ---- client API ----------------------------------------------------
    def submit(self, ids, max_new_tokens=None, sampling=None, *,
               meta=None, on_token=None, timeout_s=None,
               stream=False, stream_timeout_s=None, trace_ctx=None):
        """Route one prompt onto the fleet. Returns the session's
        Future (resolving to the full [prompt + generated] int32
        array regardless of how many replicas it crossed), or a
        `frontend.StreamHandle` when stream=True.

        The per-request PRNG seed is RESOLVED HERE (explicit
        `sampling.seed` wins, else derived from the fleet seed) and
        journaled with the accept, so a failover replay on any
        survivor samples token-identically. `AdmissionShed` is raised
        with a retry hint when every routable replica is saturated
        (global shed) or every tried replica shed locally."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, "
                            f"got {type(sampling).__name__}")
        # resolve the seed at the ROUTER: replicas must never
        # auto-derive (their counters differ — a replay would
        # diverge); greedy requests get one too (harmless, and the
        # journal entry is then self-contained either way)
        if sampling is not None and sampling.seed is not None:
            seed = int(sampling.seed)
        else:
            seed = (self._seed0 + 0x9E3779B9
                    * (1 + next(self._auto_seeds))) & 0xFFFFFFFF
            if sampling is not None:
                sampling = dataclasses.replace(sampling, seed=seed)
        budget = max_new_tokens
        if budget is None and sampling is not None:
            budget = sampling.max_new_tokens
        if budget is None:
            budget = self.replicas[0].server.max_new
        sess = _Session(f"f{next(_rids)}", ids, int(budget), seed,
                        sampling, meta, timeout_s, on_token,
                        trace=trace_ctx)
        handle = None
        if stream:
            from ..frontend.stream import StreamHandle

            stops = sampling.stop_strings if sampling is not None else ()
            handle = StreamHandle(
                detokenize=self._detok, stop_strings=stops,
                tail_tokens=16, max_buffered=self._stream_buffer,
                timeout_s=stream_timeout_s)
            user_cb = on_token
            if user_cb is None:
                sess.on_token = handle._on_token
            else:
                def chained(tok, reason, _h=handle._on_token,
                            _u=user_cb):
                    _h(tok, reason)
                    _u(tok, reason)
                sess.on_token = chained
            handle._bind(sess.future)
        with self._lock:
            if self._stop:
                raise RuntimeError("router stopped")
            self._shed_check_locked()
            self._sessions[sess.rid] = sess
        if self._journal is not None:
            # journal the accept BEFORE the replica sees it: a crash
            # (router or replica) between here and the first token
            # still recovers the session
            self._journal.record_accept(sess)
        try:
            self._dispatch(sess, first=True)
        except BaseException:
            with self._lock:
                sess.done = True
                self._sessions.pop(sess.rid, None)
            if self._journal is not None:
                self._journal.record_done(sess.rid, "rejected")
            raise
        return handle if stream else sess.future

    def _shed_check_locked(self):
        if self._shed_depth is None:
            return
        now = time.monotonic()
        routable = self._routable(now)
        if not routable:
            return  # nothing routable is a placement error, not shed
        depths = [r.queue_depth() for r in routable]
        if min(depths) >= self._shed_depth:
            self._sheds += 1
            _m_sheds.inc()
            slots = sum(r.server.max_slots for r in routable)
            waves = -(-min(depths) // max(1, slots))
            hint = max(0.05, 0.25 * waves)
            raise AdmissionShed(min(depths), self._shed_depth, hint)

    def _dispatch(self, sess, first=False):
        """Place `sess` (fresh or resume state) on a replica, retrying
        across candidates; raises on a fresh submit, fails the session
        future on a re-placement."""
        route_ids = (np.concatenate(
            [sess.ids, np.asarray(sess.toks, np.int32)])
            if sess.toks else sess.ids)
        tried = set()
        sheds = []
        last_exc = None
        for _attempt in range(self.submit_retries + 1):
            rep, match = self._place(route_ids, exclude=tried)
            if rep is None:
                break
            if self._poll_kill_seam():
                self._kill_replica(rep)
                tried.add(rep)
                rep, match = self._place(route_ids, exclude=tried)
                if rep is None:
                    break
            with self._lock:
                self._placements += 1
                if match > 0:
                    self._prefix_routed += 1
            if match > 0:
                _m_prefix_routed.inc()
            epoch = sess.epoch
            cb = self._make_token_cb(sess, epoch)
            try:
                if first and not sess.toks:
                    fut = rep.server.submit(
                        sess.ids, max_new_tokens=sess.budget,
                        sampling=sess.sampling, meta=sess.meta,
                        on_token=cb, timeout_s=sess.timeout_s,
                        rid=sess.rid, trace_ctx=sess.trace)
                else:
                    fut = rep.server.admit_journal_entry(
                        SessionJournal.entry_for(sess), on_token=cb)
            except AdmissionShed as e:
                sheds.append(e)
                tried.add(rep)
                last_exc = e
                with self._lock:
                    self._retries += 1
                _m_retries.inc()
                continue
            except Exception as e:  # noqa: BLE001 — replica refused
                rep.health.note_failure(time.monotonic(),
                                        f"submit: {type(e).__name__}")
                tried.add(rep)
                last_exc = e
                with self._lock:
                    self._retries += 1
                _m_retries.inc()
                continue
            with self._lock:
                sess.replica = rep
            if first:
                _m_requests.labels(replica=rep.name).inc()
            fut.add_done_callback(
                lambda f, s=sess, r=rep, g=epoch:
                self._on_replica_done(s, r, g, f))
            _tracing.event("fleet_place", request_id=sess.rid,
                           prefix_match=int(match),
                           resume=bool(sess.toks),
                           **sess._tr(replica=rep.name))
            return
        if sheds:
            # every candidate shed: propagate the largest retry hint
            err = max(sheds, key=lambda e: e.retry_after_s)
        else:
            err = ReplicaUnavailable(
                sess.rid,
                f"tried {len(tried)} replica(s); last error: "
                f"{last_exc!r}" if tried else "no routable replica")
        if first:
            raise err
        # a re-placement (failover) runs inside engine callbacks:
        # never raise — fail the session's client-facing future. The
        # JOURNAL entry deliberately stays live: a healed fleet's
        # recover_from_journal still completes it token-identically
        # (the ReplicaUnavailable contract).
        with self._lock:
            sess.done = True
        sess.future.set_exception(err)

    # ---- token + completion plumbing -----------------------------------
    def _make_token_cb(self, sess, epoch):
        def cb(tok, reason):
            first = False
            with self._lock:
                if sess.done or epoch != sess.epoch:
                    return  # stale replica still flushing: ignore
                sess.toks.append(int(tok))
                if sess.t_first is None:
                    sess.t_first = time.perf_counter()
                    self._ttft.append(sess.t_first - sess.t_submit)
                    first = True
                self._tokens_out += 1
                if reason is not None:
                    sess.stop_reason = reason
            if first and self._slo is not None:
                # router-observed TTFT: spans queueing, placement,
                # any failover requeue gap — the client's number
                self._slo_observe_latency(
                    "ttft", sess.t_first - sess.t_submit, sess)
            if self._journal is not None:
                self._journal.record_token(sess.rid, tok)
                if reason is not None:
                    self._journal.record_done(sess.rid, reason)
            fwd = sess.on_token
            if fwd is not None:
                fwd(tok, reason)
        return cb

    def _on_replica_done(self, sess, rep, epoch, fut):
        exc = fut.exception()
        with self._lock:
            if sess.done or epoch != sess.epoch:
                return
            if exc is None or isinstance(
                    exc, (QuarantinedRequest, RequestTimeout)):
                sess.done = True
                self._requests_done += 1
        now = time.monotonic()
        if exc is None:
            rep.health.note_ok(now)
            self._slo_observe_avail(sess, True, rep)
            if self._journal is not None and sess.stop_reason is None:
                # terminal token never streamed (e.g. an immediate
                # journal-terminal resolution): close the entry
                self._journal.record_done(sess.rid, "done")
            sess.future.set_result(fut.result())
            return
        if isinstance(exc, (QuarantinedRequest, RequestTimeout)):
            # the request's OWN failure — by design it costs exactly
            # itself, never a failover
            reason = ("quarantined"
                      if isinstance(exc, QuarantinedRequest)
                      else "timeout")
            if self._journal is not None:
                self._journal.record_done(sess.rid, reason)
            self._slo_observe_avail(sess, False, rep)
            sess.future.set_exception(exc)
            return
        if self._stop:
            with self._lock:
                sess.done = True
            sess.future.set_exception(exc)
            return
        # the replica gave up on the session (engine death, stop, an
        # unrecovered dispatch error): passive health signal + re-admit
        # on a survivor from the journaled state
        rep.health.note_failure(now, f"{type(exc).__name__}: {exc}")
        _logger.warning("replica %s failed session %s (%s); failing "
                        "over", rep.name, sess.rid, exc)
        self._failover_session(sess, exclude={rep})

    # ---- SLO burn-rate engine -------------------------------
    def _slo_observe_latency(self, kind, value_s, sess):
        """Feed one router-observed latency (caller checked _slo)."""
        meta = sess.meta
        rep = sess.replica
        self._slo.observe(
            kind, value_s=value_s,
            lane=meta.lane if meta is not None else None,
            tenant=meta.tenant if meta is not None else None,
            replica=rep.name if rep is not None else None)

    def _slo_observe_avail(self, sess, ok, rep=None):
        """Feed one session outcome (finished vs terminally failed)."""
        if self._slo is None:
            return
        if rep is None:
            rep = sess.replica
        meta = sess.meta
        self._slo.observe(
            "availability", good=ok,
            lane=meta.lane if meta is not None else None,
            tenant=meta.tenant if meta is not None else None,
            replica=rep.name if rep is not None else None)

    def _slo_degrade_check(self, now):
        """The degrade hook: a replica-scoped SLO in SUSTAINED page
        burn (>= slo_degrade_sustain_s continuous) marks its replica
        not_ready in the state machine — residents keep decoding,
        new placements go elsewhere until the burn clears."""
        if self._slo is None:
            return
        paging = self._slo.paging(now, self.slo_degrade_sustain_s)
        for rep in self.replicas:
            hit = sorted(n for n in paging
                         for s in self._slo.slos
                         if s.name == n and s.replica == rep.name)
            if not hit:
                self._slo_degraded.pop(rep.name, None)
                continue
            if rep.dead:
                continue
            if rep.name not in self._slo_degraded:
                self._slo_degraded[rep.name] = now
                _tracing.event("slo_degrade", replica=rep.name,
                               slos=hit)
                _logger.warning(
                    "replica %s degraded to not_ready: sustained SLO "
                    "page burn (%s)", rep.name, ", ".join(hit))
            rep.health.note_not_ready(
                now, f"slo page burn: {', '.join(hit)}")
            _m_state.labels(replica=rep.name).set(
                _STATE_CODE["not_ready"])

    def capacity(self):
        """The fleet /capacity endpoint payload: every
        replica's versioned pressure snapshot federated under its
        name, dead replicas contributing `{"error": ...}` instead of
        failing the page — the fleet-level Autoscaler input."""
        from ..observability.capacity import federate_capacity

        return federate_capacity(
            {rep.name: rep.capacity for rep in self.replicas},
            timeout_s=self.capacity_timeout_s)

    def slo_report(self):
        """The fleet /slo endpoint payload."""
        if self._slo is None:
            return {"slos": [], "worst": "ok", "paging": []}
        report = self._slo.report()
        report["degraded_replicas"] = sorted(self._slo_degraded)
        return report

    # ---- timeline export ------------------------------------
    def export_timeline(self, path):
        """Write the FLEET Chrome/Perfetto timeline: the shared span
        sink laid out per replica (events are stamped with `replica`
        by the engines) plus every replica's flight-recorder ring on
        its own track, and the router's own events on a `router`
        process. Open in chrome://tracing or ui.perfetto.dev. Returns
        the event count."""
        from ..observability import timeline as _timeline

        recorders = {}
        for rep in self.replicas:
            try:
                recorders[rep.name] = rep.server._recorder.events()
            except Exception:  # noqa: BLE001 — a dead replica's ring
                continue      # is best-effort
        return _timeline.write_chrome_trace(
            path, recorders=recorders, default_name="router")

    # ---- failover ------------------------------------------------------
    def _failover_session(self, sess, exclude=frozenset()):
        with self._lock:
            if sess.done:
                return
            sess.epoch += 1
            sess.failovers += 1
            self._failover_sessions += 1
            if sess.trace is not None:
                # causal tracing: the re-admission on a survivor is a
                # new hop of the same trace, cause "failover"
                sess.trace = sess.trace.child("failover")
        _m_failover_sessions.inc()
        _tracing.event("fleet_failover_session", request_id=sess.rid,
                       tokens_done=len(sess.toks), **sess._tr())
        self._dispatch(sess, first=False)

    def _failover_replica(self, rep, why=""):
        """Re-admit every unfinished session resident on `rep` onto
        survivors, in accept order. Idempotent: sessions already moved
        (or finished) are skipped."""
        with self._lock:
            victims = [s for s in self._sessions.values()
                       if s.replica is rep and not s.done]
            if victims:
                self._failovers += 1
        if not victims:
            return
        _m_failovers.inc()
        _logger.warning("failing over %d session(s) from replica %s "
                        "(%s)", len(victims), rep.name, why)
        for sess in victims:
            self._failover_session(sess, exclude={rep})

    # ---- planned migration ---------------------------------------------
    def migrate_session(self, rid, target=None):
        """Move one LIVE session to another replica with zero prefill
        recompute: the source preempt-publishes and exports its K/V
        chain, the payload crosses the wire as bytes, the target
        imports and warm-attaches, and the stream keeps delivering
        from the next token. Falls back to plain journal replay when
        the source is already dead or the target pool cannot hold the
        chain. Returns the target replica's name. Raises KeyError for
        an unknown/finished rid and ReplicaUnavailable when there is
        nowhere to move to."""
        with self._lock:
            sess = self._sessions.get(rid)
            if sess is None or sess.done:
                raise KeyError(f"unknown or finished session {rid!r}")
            source = sess.replica
        if isinstance(target, str):
            by_name = {r.name: r for r in self.replicas}
            if target not in by_name:
                raise KeyError(f"unknown replica {target!r}")
            target = by_name[target]
        if source is None or source.dead:
            # source already gone: the fallback IS the failover path
            with self._lock:
                self._migrations += 1
            _m_migrations.inc()
            self._failover_session(
                sess, exclude={source} if source else frozenset())
            with self._lock:
                moved = sess.replica
            if moved is None:
                raise ReplicaUnavailable(rid, "migration fallback "
                                              "found no survivor")
            return moved.name
        ent, payload = source.server.export_session(rid)
        with self._lock:
            sess.epoch += 1          # stale source callbacks no-op
            epoch = sess.epoch
            if sess.trace is not None:
                # causal tracing: the warm re-admission on the target
                # is a new hop, cause "migration" (the engine's
                # migrate_out event on the source closes the old hop)
                sess.trace = sess.trace.child("migration")
                ent["trace"] = sess.trace.to_dict()
        wire = serialize_kv_payload(payload)
        payload = deserialize_kv_payload(wire)  # the wire round-trip
        if target is None or target is source:
            resume = (np.asarray(ent["ids"] + ent["gen0"], np.int32)
                      if ent["gen0"] else np.asarray(ent["ids"],
                                                     np.int32))
            target, _ = self._place(resume, exclude={source})
        if target is None:
            target = source if not source.dead else None
        if target is None:
            with self._lock:
                sess.done = True
            err = ReplicaUnavailable(rid, "no migration target")
            sess.future.set_exception(err)
            raise err
        imported = 0
        if payload is not None:
            try:
                tenant = (ent.get("meta") or {}).get("tenant",
                                                     "default")
                imported = target.server.import_kv_payload(
                    payload, owner=(tenant, rid))
            except Exception as e:  # noqa: BLE001 — pool pressure on
                # the target: journal replay still completes the
                # session, just without the zero-recompute warm attach
                _logger.warning("migration of %s: target %s could not "
                                "import KV (%s); replaying", rid,
                                target.name, e)
                imported = 0
        cb = self._make_token_cb(sess, epoch)
        fut = target.server.admit_journal_entry(ent, on_token=cb)
        with self._lock:
            sess.replica = target
            self._migrations += 1
        _m_migrations.inc()
        fut.add_done_callback(
            lambda f, s=sess, r=target, g=epoch:
            self._on_replica_done(s, r, g, f))
        _tracing.event("fleet_migrate", request_id=rid,
                       source=source.name, to=target.name,
                       kv_tokens=int(imported),
                       wire_bytes=len(wire),
                       **sess._tr(replica=target.name))
        return target.name

    # ---- dynamic membership ---------------------------------
    def add_replica(self, replica, *, require_warm=True):
        """Admit one replica into the live routing set (the
        autoscaler's scale-up actuation; callable directly). Accepts
        a `fleet.Replica` (incl. a spawned `RemoteReplica`) or a bare
        not-yet-started `PagedGenerationServer`.

        Readiness gate: with `require_warm=True` (default) the
        replica is only admitted once its engine PROVES
        `warm_buckets()` ran (the `warmed` readiness detail), so a
        fresh replica never pays a CUDA graph capture inside a
        request window. A not-yet-started in-process engine that skipped the
        warm is warmed HERE (before start — the engine loop owns the
        cache arrays after); a remote replica must have been spawned
        warm (`warm_start`, the spawn default) or admission is
        refused. Returns the admitted `Replica`."""
        rep = (replica if isinstance(replica, Replica)
               else Replica(f"replica{next(self._rep_ids)}", replica))
        with self._lock:
            if self._stop:
                raise RuntimeError("router stopped")
            if any(r.name == rep.name for r in self.replicas):
                raise ValueError(f"duplicate replica name: "
                                 f"{rep.name!r}")
        if require_warm:
            srv = rep.server
            if (hasattr(srv, "warm_buckets")
                    and not getattr(srv, "_warm_ran", False)
                    and getattr(srv, "_thread", None) is None):
                srv.warm_buckets()
        if self._started:
            rep.start()
        if require_warm:
            _ready, detail = rep.readiness()
            if not detail.get("warmed", False):
                rep.stop()
                raise RuntimeError(
                    f"replica {rep.name} failed the warm readiness "
                    f"gate (no proof warm_buckets ran); spawn with "
                    f"warm_start=True or pass require_warm=False")
        with self._lock:
            # copy-on-write: placement/probe iterations hold a
            # consistent snapshot, never a half-mutated list
            self.replicas = self.replicas + [rep]
            self._replicas_added += 1
            total = len(self.replicas)
        _m_added.inc()
        _m_replicas.set(float(total))
        _tracing.event("fleet_add_replica", replica=rep.name,
                       total=total)
        _logger.info("replica %s admitted (fleet size %d)", rep.name,
                     total)
        return rep

    def remove_replica(self, name, *, force=False):
        """Remove one replica from the routing set and stop it.
        Refuses (unless `force=True`) while unfinished sessions are
        resident on a live replica — `retire_replica` runs the full
        drain-first state machine. Residents still present at removal
        (force, or a dead replica) fail over to survivors via the
        router journal. Returns the removed `Replica`."""
        with self._lock:
            rep = next((r for r in self.replicas if r.name == name),
                       None)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if len(self.replicas) == 1:
                raise ValueError("cannot remove the last replica")
            residents = [s for s in self._sessions.values()
                         if s.replica is rep and not s.done]
            if residents and not force and not rep.dead:
                raise RuntimeError(
                    f"replica {name} has {len(residents)} resident "
                    f"session(s); retire_replica drains first "
                    f"(or pass force=True)")
            self.replicas = [r for r in self.replicas if r is not rep]
            self._replicas_removed += 1
            total = len(self.replicas)
        _m_removed.inc()
        _m_replicas.set(float(total))
        _tracing.event("fleet_remove_replica", replica=rep.name,
                       total=total)
        # anything still resident moves NOW, before the engine stops
        self._failover_replica(rep, why="removed from fleet")
        rep.stop()
        _logger.info("replica %s removed (fleet size %d)", name, total)
        return rep

    def retire_replica(self, name, *, now=None):
        """Scale-down actuation, as one deterministic state machine:

        1. DRAIN — `set_draining(True)` on the engine and not_ready
           in the health machine: residents keep decoding, placement
           weight drops to 0 immediately.
        2. MIGRATE — every resident session moves to best-prefix/
           least-loaded survivors over the migration wire in accept
           order (zero prefill recompute); a SIGKILL mid-drain
           degrades the remaining moves to the journal failover,
           token-identically.
        3. RETIRE — `remove_replica` drops and stops the engine.

        Returns {"replica", "migrated", "failed_over"}."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rep = next((r for r in self.replicas if r.name == name),
                       None)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if len(self.replicas) == 1:
                raise ValueError("cannot retire the last replica")
        _tracing.event("fleet_retire_replica", replica=rep.name)
        try:
            rep.set_draining(True)
        except Exception:  # noqa: BLE001 — a replica dying mid-call
            pass           # drains by failover below
        rep.health.note_not_ready(now, "draining (retire)")
        _m_state.labels(replica=rep.name).set(
            _STATE_CODE["not_ready"])
        migrated = 0
        failed_over = 0
        # bounded sweep: weight 0 stops new placements, but a submit
        # racing the drain flip can land one more resident
        for _round in range(8):
            with self._lock:
                residents = sorted(
                    (s for s in self._sessions.values()
                     if s.replica is rep and not s.done),
                    key=lambda s: s.rid)
            if not residents:
                break
            progress = False
            for sess in residents:
                try:
                    was_dead = rep.dead
                    target = self.migrate_session(sess.rid)
                    if target != rep.name:
                        progress = True
                        if was_dead:
                            failed_over += 1
                        else:
                            migrated += 1
                except KeyError:
                    progress = True  # finished while we looked
                except Exception as e:  # noqa: BLE001 — no survivor
                    # for this session: leave it to remove_replica's
                    # failover (which fails the future if the fleet
                    # truly has nowhere to put it)
                    _logger.warning("retire %s: moving %s failed "
                                    "(%s)", rep.name, sess.rid, e)
            if not progress:
                break
        self.remove_replica(name, force=True)
        return {"replica": name, "migrated": migrated,
                "failed_over": failed_over}

    # ---- probes --------------------------------------------------------
    def _probe_loop(self):
        while not self._stop:
            try:
                self.check_replicas()
            except Exception:  # noqa: BLE001 — the probe loop must
                _logger.exception("fleet probe pass failed")
            self._probe_wake.wait(timeout=self.probe_interval_s)
            self._probe_wake.clear()

    def check_replicas(self, now=None):
        """One active probe pass (the probe thread calls this on the
        interval; tests call it directly with an explicit now).
        Liveness false => the replica is DEAD: mark it and fail its
        sessions over. Ready false => weight 0, sessions stay.
        Circuit-open replicas are only probed when their capped
        backoff has elapsed, and a healthy probe alone never closes
        an open circuit — only trial traffic does."""
        now = time.monotonic() if now is None else now
        for rep in self.replicas:
            if rep.dead:
                # externally killed/died: make sure nothing is left
                self._failover_replica(rep, why="dead replica")
                _m_state.labels(replica=rep.name).set(
                    _STATE_CODE["dead"])
                continue
            h = rep.health
            if not h.probe_due(now):
                continue
            live, _detail = rep.liveness()
            if not live and self._started:
                _m_probes.labels(replica=rep.name,
                                 outcome="dead").inc()
                h.mark_dead("liveness probe failed")
                self._failover_replica(rep, why="liveness probe "
                                                "failed")
                _m_state.labels(replica=rep.name).set(
                    _STATE_CODE["dead"])
                continue
            ready, _detail = rep.readiness()
            if ready:
                _m_probes.labels(replica=rep.name, outcome="ok").inc()
                if h.state in ("ok", "degraded", "not_ready"):
                    # a bare probe never closes an OPEN circuit: the
                    # failures were real traffic; only trial traffic
                    # (half-open weight) may close it
                    h.note_ok(now)
            else:
                _m_probes.labels(replica=rep.name,
                                 outcome="not_ready").inc()
                h.note_not_ready(now, "readiness probe false")
            _m_state.labels(replica=rep.name).set(
                _STATE_CODE.get(h.state, 4.0))
        # SLO degrade hook: AFTER the probes, so a healthy
        # readiness probe cannot mask a sustained page burn this pass
        self._slo_degrade_check(now)

    # ---- recovery ------------------------------------------------------
    def recover_from_journal(self, journal=None):
        """Re-admit every accepted-but-unfinished session in the
        ROUTER journal onto the current fleet — the router-crash half
        of the takeover story (replica failover replays the same
        entries while the router lives). Returns {rid: Future}."""
        j = journal if journal is not None else self._journal
        if j is None:
            raise ValueError("no journal: pass one or build the "
                             "router with journal=")
        out = {}
        for ent in j.interrupted():
            sampling = None
            if ent.get("sampling"):
                sampling = SamplingParams(
                    **{k: tuple(v) if isinstance(v, list) else v
                       for k, v in ent["sampling"].items()})
            meta = None
            if ent.get("meta"):
                from ..inference.serving import RequestMeta

                m = ent["meta"]
                meta = RequestMeta(
                    lane=m.get("lane", "interactive"),
                    tenant=m.get("tenant", "default"),
                    deadline_s=m.get("deadline_s"),
                    cost=int(m.get("cost", 0)))
            trace = (TraceContext.from_dict(ent["trace"])
                     .child("failover")
                     if ent.get("trace") else None)
            sess = _Session(ent["rid"],
                            np.asarray(ent["ids"], np.int32),
                            int(ent["budget"]), int(ent["seed"]),
                            sampling, meta, ent.get("timeout_s"),
                            None, trace=trace)
            sess.toks = [int(t) for t in ent.get("gen0", [])]
            with self._lock:
                self._sessions[sess.rid] = sess
            self._dispatch(sess, first=False)
            out[sess.rid] = sess.future
        return out

    # ---- introspection -------------------------------------------------
    def health(self):
        """(status, detail) for the fleet /healthz: ok = every replica
        routable, degraded = some are not but >= 1 is, stalled =
        nothing routable (503 — drain the fleet)."""
        now = time.monotonic()
        routable = self._routable(now)
        states = {r.name: r.health.state for r in self.replicas}
        detail = {"replicas": states,
                  "routable": len(routable),
                  "total": len(self.replicas)}
        if not routable:
            return "stalled", detail
        if len(routable) < len(self.replicas):
            return "degraded", detail
        return "ok", detail

    def statusz(self):
        with self._lock:
            live = [s.rid for s in self._sessions.values()
                    if not s.done]
        status, detail = self.health()
        return {
            "server": "fleet",
            "health": {"status": status, **detail},
            "replicas": [r.stats() for r in self.replicas],
            "live_sessions": live,
            "stats": self.stats(),
        }

    def metrics_text(self):
        """The federated /metrics page: every replica's exposition
        with a `replica` label injected, fleet-level `fleet_*` series
        appended once (fleet.federation)."""
        def _metric_of(line):
            s = line.strip()
            if s.startswith("# HELP ") or s.startswith("# TYPE "):
                parts = s.split(" ", 3)
                return parts[2] if len(parts) > 2 else ""
            if not s or s.startswith("#"):
                return ""
            cut = len(s)
            for ch in ("{", " "):
                i = s.find(ch)
                if i != -1:
                    cut = min(cut, i)
            return s[:cut]

        def _split(text):
            rep_lines, fleet_lines = [], []
            for line in text.splitlines():
                (fleet_lines if _metric_of(line).startswith("fleet_")
                 else rep_lines).append(line)
            return "\n".join(rep_lines), "\n".join(fleet_lines)

        sources = []
        fleet_extra = ""
        for rep in self.replicas:
            rep_text, fleet_text = _split(rep.metrics_text())
            sources.append((rep.name, rep_text))
            if fleet_text:
                fleet_extra = fleet_text  # same process registry:
                # fleet series are identical across in-process
                # replicas — keep one copy, unrelabeled
        return federate_metrics(sources, extra=fleet_extra)

    def reset_stats(self):
        with self._lock:
            self._ttft.clear()
            self._tokens_out = 0
            self._requests_done = 0
            self._failovers = 0
            self._failover_sessions = 0
            self._migrations = 0
            self._replica_kills = 0
            self._sheds = 0
            self._retries = 0
            self._prefix_routed = 0
            self._placements = 0
            self._replicas_added = 0
            self._replicas_removed = 0
            self._t0 = time.perf_counter()
        # reset-coherent with the attached autoscaler's window
        if self._autoscaler is not None:
            self._autoscaler.reset_stats()

    def stats(self):
        with self._lock:
            ttft = sorted(self._ttft)
            n = len(ttft)
            pct = (lambda p: ttft[min(n - 1, int(p * n))] * 1e3
                   if n else 0.0)
            dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
            live = sum(1 for s in self._sessions.values()
                       if not s.done)
            return {
                "replicas": {r.name: r.stats() for r in self.replicas},
                "live_sessions": live,
                "requests_done": self._requests_done,
                "new_tokens": self._tokens_out,
                "tokens_per_sec": (self._tokens_out / dt
                                   if dt else 0.0),
                "ttft_p50_ms": pct(0.50),
                "ttft_p99_ms": pct(0.99),
                "placements": self._placements,
                "prefix_routed": self._prefix_routed,
                "failovers": self._failovers,
                "failover_sessions": self._failover_sessions,
                "migrations": self._migrations,
                "replicas_added": self._replicas_added,
                "replicas_removed": self._replicas_removed,
                "replica_kills": self._replica_kills,
                "sheds": self._sheds,
                "submit_retries": self._retries,
                "fault_plan": (self._faults.describe()
                               if self._faults is not None else None),
                "journal": (self._journal.stats()
                            if self._journal is not None else None),
                "wall_s": dt,
                "slo": {
                    "enabled": self._slo is not None,
                    "degraded_replicas": sorted(self._slo_degraded),
                },
                "autoscale": (self._autoscaler.stats_block()
                              if self._autoscaler is not None
                              else dict(AUTOSCALE_ZERO)),
            }
