"""Deterministic SLO-driven autoscaler: the port's copy of
`paddle_tpu.fleet.autoscale`.

The actuation side of the capacity bus: an `Autoscaler` control
loop on an EXPLICIT clock — the `TokenBucket`/`PressureSignals`
discipline — that each tick consumes ONE federated
`FleetRouter.capacity()` snapshot (pool headroom, blocks-exhaustion
ETA, queue depths, shed pressure, SLO burn rates, pre-aggregated in
the snapshot's `aggregate` block) and emits typed `ScaleDecision`s:

  * SCALE-UP   — spawn a replica (in-process or `RemoteReplica.spawn`)
    and `FleetRouter.add_replica()` it; the warm readiness gate means
    it is only routable once `warm_buckets()` provably ran, so a new
    replica never pays a CUDA graph capture inside a request window.
  * SCALE-DOWN — pick the least-loaded replica FROM THE SNAPSHOT and
    `FleetRouter.retire_replica()` it: drain, migrate residents to
    best-prefix/least-loaded survivors over the existing migration
    wire (zero prefill recompute), retire. SIGKILL mid-drain degrades
    to the journal failover token-identically.
  * REBALANCE  — KV/prefix-aware pressure relief: when a replica's
    blocks-exhaustion ETA (the forecast) drops under the policy
    threshold, move up to `max_concurrent_migrations` of its resident
    sessions to the highest-headroom survivor BEFORE it sheds.

DETERMINISM is the load-bearing property: `decide()` is a pure
function of (policy, snapshot, internal hysteresis state) — it never
reads the router — so the same clock values + the same snapshots
reproduce the decision stream BYTE-IDENTICALLY (`Autoscaler.replay`
re-derives it from a recorded tick log with zero live engines). Every
tick records its `(now, snapshot)` input in `recorded` and every
decision appends one canonical JSON line to `decisions` (the decision
journal); actuation happens strictly AFTER journaling, so a crash
mid-tick loses at most actuations, never journal entries.

Policy is declarative (`AutoscalePolicy`): min/max replicas, headroom
and burn bands with separate up/down hysteresis tick counts and
cooldowns, a queue-per-slot trigger, and the rebalance ETA threshold.
What is NOT actuated here: per-lane admission (frontdoor), KV tier
demotion (kv_tier), disaggregated pool sizing — the reference's docs/FLEET.md
"Elastic fleets".
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

from ..observability import log as _obs_log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..observability.capacity import fleet_aggregate
from .replica import Replica

_logger = _obs_log.get_logger(__name__)

_m_ticks = _metrics.counter(
    "autoscale_ticks_total",
    "autoscaler control-loop ticks (one capacity snapshot consumed "
    "per tick)")
_m_decisions = _metrics.counter(
    "autoscale_decisions_total",
    "autoscale decisions by action (hold included — the journal is "
    "the full stream)", labelnames=("action",))
_m_errors = _metrics.counter(
    "autoscale_errors_total",
    "decisions whose ACTUATION failed (the decision itself is "
    "journaled first and replays identically)")
_m_replicas = _metrics.gauge(
    "autoscale_replicas",
    "live replica count the last consumed snapshot reported")
_m_replica_seconds = _metrics.counter(
    "autoscale_replica_seconds_total",
    "replica-seconds metered from consumed snapshots (live replicas "
    "x tick interval — the bench's cost denominator)")
_m_migrations = _metrics.counter(
    "autoscale_migrations_total",
    "sessions moved by rebalance actuations (pressure-forecast "
    "relief, zero prefill recompute)")


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Declarative scaling policy. All thresholds read the snapshot's
    fleet `aggregate` block; hysteresis (`*_after` consecutive ticks)
    and per-direction cooldowns damp flapping.

    min_replicas / max_replicas: the fleet size band.
    up_headroom_frac: pressure when the worst replica's free-block
        fraction is <= this.
    up_burn: pressure when the worst SLO burn rate is >= this
        (budget-neutral burn is 1.0).
    up_queue_per_slot: pressure when summed queue depth / summed
        decode slots is >= this.
    down_headroom_frac / down_queue_per_slot: calm requires the worst
        headroom >= / queue pressure <= these (and no up-pressure).
    up_after / down_after: consecutive pressure/calm ticks before a
        scale decision fires.
    up_cooldown_s / down_cooldown_s: minimum spacing between same-
        direction decisions, on the loop's explicit clock.
    rebalance_eta_s: move sessions off a replica whose blocks-
        exhaustion ETA (forecast) is <= this; None disables
        rebalancing.
    rebalance_headroom_frac: a rebalance target must have at least
        this free-block fraction.
    max_concurrent_migrations: session moves per rebalance actuation.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    up_headroom_frac: float = 0.15
    up_burn: float = 2.0
    up_queue_per_slot: float = 1.0
    down_headroom_frac: float = 0.5
    down_queue_per_slot: float = 0.1
    up_after: int = 2
    down_after: int = 5
    up_cooldown_s: float = 10.0
    down_cooldown_s: float = 30.0
    rebalance_eta_s: float | None = None
    rebalance_headroom_frac: float = 0.3
    max_concurrent_migrations: int = 2

    def __post_init__(self):
        if int(self.min_replicas) < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError(
                f"max_replicas must be >= min_replicas "
                f"({self.min_replicas}), got {self.max_replicas}")
        for fld in ("up_headroom_frac", "down_headroom_frac",
                    "rebalance_headroom_frac"):
            v = getattr(self, fld)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{fld} must be in [0, 1], got {v}")
        if float(self.down_headroom_frac) \
                < float(self.up_headroom_frac):
            raise ValueError(
                f"down_headroom_frac ({self.down_headroom_frac}) must "
                f"be >= up_headroom_frac ({self.up_headroom_frac}) — "
                f"the calm band may not overlap the pressure band")
        for fld in ("up_burn", "up_queue_per_slot",
                    "down_queue_per_slot"):
            if float(getattr(self, fld)) < 0.0:
                raise ValueError(f"{fld} must be >= 0, got "
                                 f"{getattr(self, fld)}")
        for fld in ("up_after", "down_after"):
            if int(getattr(self, fld)) < 1:
                raise ValueError(f"{fld} must be >= 1, got "
                                 f"{getattr(self, fld)}")
        for fld in ("up_cooldown_s", "down_cooldown_s"):
            if float(getattr(self, fld)) < 0.0:
                raise ValueError(f"{fld} must be >= 0, got "
                                 f"{getattr(self, fld)}")
        if self.rebalance_eta_s is not None \
                and float(self.rebalance_eta_s) <= 0.0:
            raise ValueError(f"rebalance_eta_s must be > 0 or None, "
                             f"got {self.rebalance_eta_s}")
        if int(self.max_concurrent_migrations) < 1:
            raise ValueError(
                f"max_concurrent_migrations must be >= 1, got "
                f"{self.max_concurrent_migrations}")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One typed autoscale decision. `to_line()` is the CANONICAL
    journal encoding (sorted keys, fixed separators) — byte equality
    of lines is the replay-identity contract."""

    tick: int
    now: float
    action: str            # scale_up | scale_down | rebalance | hold
    replica: str | None    # spawned name / retire victim / source
    target: str | None     # rebalance destination
    reason: str

    def to_dict(self):
        return {"tick": self.tick, "now": self.now,
                "action": self.action, "replica": self.replica,
                "target": self.target, "reason": self.reason}

    def to_line(self):
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))


class Autoscaler:
    """The control loop. `router` may be None for pure replay (no
    actuation possible then).

    policy: an `AutoscalePolicy`.
    spawn: `spawn(name) -> Replica | engine` — builds the replica a
        scale-up admits (e.g. a `RemoteReplica.spawn` closure, or a
        fresh warmed in-process engine). None journals scale-up
        decisions but fails their actuation.
    clock: explicit injectable clock (default `time.monotonic`) —
        feed a fake clock for deterministic tests/replay.
    interval_s: the background thread's tick cadence (`start()`);
        `tick()` is the direct drive the benches/tests use.
    journal_path: optional file; every decision line is appended
        (the in-memory `decisions` list is always kept).
    """

    def __init__(self, router, policy=None, *, spawn=None, clock=None,
                 interval_s=1.0, journal_path=None):
        if policy is None:
            policy = AutoscalePolicy()
        if not isinstance(policy, AutoscalePolicy):
            raise TypeError(f"policy must be an AutoscalePolicy, got "
                            f"{type(policy).__name__}")
        if float(interval_s) <= 0.0:
            raise ValueError(f"interval_s must be > 0, "
                             f"got {interval_s}")
        self.router = router
        self.policy = policy
        self._spawn = spawn
        self._clock = clock or time.monotonic
        self.interval_s = float(interval_s)
        self._journal_path = journal_path
        self._lock = threading.RLock()
        # decision/control state (decide() is a pure function of this
        # + policy + snapshot; survives reset_stats)
        self._tick = 0
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_up_t = None
        self._last_down_t = None
        self._last_rebalance_t = None
        self._auto_ids = 0           # deterministic spawned names
        self._last_now = None        # replica-seconds integration
        #: recorded (now, snapshot) tick inputs — the replay feed
        self.recorded: list = []
        #: canonical decision journal lines, in emission order
        self.decisions: list = []
        # window counters (reset_stats-coherent)
        self._w_ticks = 0
        self._w_decisions = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._rebalances = 0
        self._holds = 0
        self._errors = 0
        self._migrations = 0
        self._replica_seconds = 0.0
        self._last_decision = None
        # test seam: called between journal append and actuation (the
        # chaos gate kills the loop here — journaled, not actuated)
        self._seam_after_journal = None
        self._thread = None
        self._stop = False
        self._wake = threading.Event()
        if router is not None:
            router._autoscaler = self  # stats()["autoscale"] goes live

    # ---- control loop ---------------------------------------------------
    def start(self):
        """Run ticks on a background thread every `interval_s` (real
        deployments; tests and benches drive `tick()` explicitly)."""
        with self._lock:
            if self._thread is not None:
                return self
            if self._stop:
                raise RuntimeError("autoscaler stopped; build a new "
                                   "one")
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="paddle-tpu-autoscale")
            self._thread.start()
        return self

    def stop(self):
        self._stop = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None

    def _loop(self):
        while not self._stop:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                _logger.exception("autoscale tick failed")
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()

    # ---- one tick --------------------------------------------------------
    def tick(self, now=None, snapshot=None):
        """Consume one capacity snapshot, journal the decisions, then
        actuate them. Returns the list of `ScaleDecision`s."""
        if self.router is None and snapshot is None:
            raise RuntimeError("no router: pass snapshot= explicitly")
        now = self._clock() if now is None else float(now)
        if snapshot is None:
            snapshot = self.router.capacity()
        with self._lock:
            self.recorded.append((now, snapshot))
            decisions = self._decide_locked(snapshot, now)
            for d in decisions:
                self.decisions.append(d.to_line())
            self._last_decision = decisions[-1].to_dict() \
                if decisions else None
        if self._journal_path is not None:
            with open(self._journal_path, "a") as f:
                for d in decisions:
                    f.write(d.to_line() + "\n")
        if _metrics.enabled():
            _m_ticks.inc()
            for d in decisions:
                _m_decisions.labels(action=d.action).inc()
        for d in decisions:
            _tracing.event("autoscale_decision", tick=d.tick,
                           action=d.action, replica=d.replica,
                           target=d.target, reason=d.reason)
        seam = self._seam_after_journal
        if seam is not None:
            seam(decisions)
        for d in decisions:
            if d.action == "hold":
                continue
            try:
                self.apply(d)
            except Exception as e:  # noqa: BLE001 — actuation failure
                # must not kill the loop; the journal already has the
                # decision and the next snapshot reflects reality
                with self._lock:
                    self._errors += 1
                if _metrics.enabled():
                    _m_errors.inc()
                _logger.warning("autoscale actuation %s failed: %s",
                                d.action, e)
        return decisions

    # ---- pure decision function ------------------------------------------
    def _decide_locked(self, snapshot, now):
        """Pure: (policy, snapshot, hysteresis state) -> decisions.
        Never reads the router — the replay-identity contract."""
        p = self.policy
        self._tick += 1
        self._w_ticks += 1
        replicas = snapshot.get("replicas") or {}
        agg = snapshot.get("aggregate")
        if agg is None:  # old-shape (schema v1) snapshot tolerance
            agg = fleet_aggregate(replicas)
        n = int(agg.get("replicas_ok") or 0)
        # replica-seconds metering: live replicas x elapsed
        if self._last_now is not None and now > self._last_now:
            dt = now - self._last_now
            self._replica_seconds += n * dt
            if _metrics.enabled():
                _m_replica_seconds.inc(n * dt)
        self._last_now = now
        if _metrics.enabled():
            _m_replicas.set(float(n))

        headroom = agg.get("min_headroom_frac")
        burn = agg.get("max_burn")
        q = int(agg.get("queue_depth_total") or 0)
        slots = int(agg.get("max_slots_total") or 0)
        qps = (q / slots) if slots > 0 else 0.0
        reasons = []
        if headroom is not None and headroom <= p.up_headroom_frac:
            reasons.append(f"headroom {headroom:.3f} "
                           f"<= {p.up_headroom_frac:g}")
        if burn is not None and burn >= p.up_burn:
            reasons.append(f"burn {burn:.3f} >= {p.up_burn:g}")
        if slots > 0 and qps >= p.up_queue_per_slot:
            reasons.append(f"queue/slot {qps:.3f} "
                           f">= {p.up_queue_per_slot:g}")
        pressure = bool(reasons)
        calm = (not pressure
                and (headroom is None
                     or headroom >= p.down_headroom_frac)
                and qps <= p.down_queue_per_slot)
        if pressure:
            self._up_ticks += 1
            self._down_ticks = 0
        elif calm:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = 0
            self._down_ticks = 0

        mk = lambda **kw: ScaleDecision(tick=self._tick, now=now, **kw)  # noqa: E731
        if (pressure and self._up_ticks >= p.up_after
                and n < p.max_replicas
                and (self._last_up_t is None
                     or now - self._last_up_t >= p.up_cooldown_s)):
            self._auto_ids += 1
            self._last_up_t = now
            self._up_ticks = 0
            d = mk(action="scale_up",
                   replica=f"auto{self._auto_ids}", target=None,
                   reason="; ".join(reasons))
            self._count_locked(d)
            return [d]
        if (calm and self._down_ticks >= p.down_after
                and n > p.min_replicas
                and (self._last_down_t is None
                     or now - self._last_down_t >= p.down_cooldown_s)):
            victim = self._pick_victim(replicas)
            if victim is not None:
                self._last_down_t = now
                self._down_ticks = 0
                d = mk(action="scale_down", replica=victim,
                       target=None,
                       reason=f"calm x{p.down_after}; headroom="
                              f"{'-' if headroom is None else round(headroom, 3)}"
                              f" queue/slot={round(qps, 3)}")
                self._count_locked(d)
                return [d]
        if p.rebalance_eta_s is not None:
            d = self._maybe_rebalance(replicas, now, mk)
            if d is not None:
                self._count_locked(d)
                return [d]
        d = mk(action="hold", replica=None, target=None,
               reason=(f"pressure x{self._up_ticks}" if pressure else
                       f"calm x{self._down_ticks}" if calm
                       else "neutral"))
        self._count_locked(d)
        return [d]

    @staticmethod
    def _snap_load(snap):
        """A replica's load as the SNAPSHOT reports it (busy slots +
        queue depth) — the victim/target ordering key."""
        queues = snap.get("queues")
        if not isinstance(queues, dict):
            return 0
        load = 0
        for k in ("busy_slots", "queue_depth"):
            v = queues.get(k)
            if isinstance(v, (int, float)):
                load += int(v)
        return load

    @staticmethod
    def _snap_headroom(snap):
        pool = snap.get("pool")
        if not isinstance(pool, dict):
            return None
        free, num = pool.get("free_blocks"), pool.get("num_blocks")
        if isinstance(free, (int, float)) \
                and isinstance(num, (int, float)) and num > 0:
            return free / num
        return None

    def _pick_victim(self, replicas):
        """Deterministic scale-down victim: the least-loaded live
        replica, name-ordered tiebreak — all from the snapshot."""
        live = [(self._snap_load(s), name)
                for name, s in sorted(replicas.items())
                if isinstance(s, dict) and "error" not in s]
        if not live:
            return None
        return min(live)[1]

    def _maybe_rebalance(self, replicas, now, mk):
        """KV/prefix-aware pressure relief: the live replica with the
        SOONEST blocks-exhaustion ETA under the threshold sheds
        sessions to the highest-headroom survivor."""
        p = self.policy
        if (self._last_rebalance_t is not None
                and now - self._last_rebalance_t < p.up_cooldown_s):
            return None
        worst = None  # (eta, name)
        for name, s in sorted(replicas.items()):
            if not isinstance(s, dict) or "error" in s:
                continue
            fc = s.get("forecast")
            eta = fc.get("exhaustion_eta_s") \
                if isinstance(fc, dict) else None
            if isinstance(eta, (int, float)) \
                    and eta <= p.rebalance_eta_s:
                if worst is None or (eta, name) < worst:
                    worst = (eta, name)
        if worst is None:
            return None
        source = worst[1]
        best = None  # (-headroom, load, name)
        for name, s in sorted(replicas.items()):
            if name == source or not isinstance(s, dict) \
                    or "error" in s:
                continue
            h = self._snap_headroom(s)
            if h is None or h < p.rebalance_headroom_frac:
                continue
            key = (-h, self._snap_load(s), name)
            if best is None or key < best:
                best = key
        if best is None:
            return None
        self._last_rebalance_t = now
        return mk(action="rebalance", replica=source, target=best[2],
                  reason=f"exhaustion eta {worst[0]:.3f}s "
                         f"<= {p.rebalance_eta_s:g}s")

    def _count_locked(self, d):
        self._w_decisions += 1
        if d.action == "scale_up":
            self._scale_ups += 1
        elif d.action == "scale_down":
            self._scale_downs += 1
        elif d.action == "rebalance":
            self._rebalances += 1
        else:
            self._holds += 1

    # ---- actuation --------------------------------------------------------
    def apply(self, decision):
        """Actuate one decision against the live router. Raises on
        failure (tick() converts that into the error counter)."""
        if self.router is None:
            raise RuntimeError("no router attached (replay-only "
                               "autoscaler)")
        act = decision.action
        if act == "scale_up":
            if self._spawn is None:
                raise RuntimeError("no spawn= callable: cannot "
                                   "actuate scale_up")
            built = self._spawn(decision.replica)
            rep = (built if isinstance(built, Replica)
                   else Replica(decision.replica, built))
            self.router.add_replica(rep)
            return rep
        if act == "scale_down":
            return self.router.retire_replica(decision.replica)
        if act == "rebalance":
            moved = 0
            with self.router._lock:
                residents = sorted(
                    s.rid for s in self.router._sessions.values()
                    if s.replica is not None
                    and s.replica.name == decision.replica
                    and not s.done)
            for rid in residents[:self.policy
                                 .max_concurrent_migrations]:
                try:
                    self.router.migrate_session(
                        rid, target=decision.target)
                    moved += 1
                except KeyError:
                    continue  # finished while we looked
            with self._lock:
                self._migrations += moved
            if _metrics.enabled() and moved:
                _m_migrations.inc(moved)
            return moved
        if act == "hold":
            return None
        raise ValueError(f"unknown decision action {act!r}")

    # ---- replay ----------------------------------------------------------
    @classmethod
    def replay(cls, policy, ticks):
        """Re-derive the decision stream from recorded `(now,
        snapshot)` tick inputs with ZERO live engines. Returns the
        canonical journal lines — byte-equal to the live run's
        `decisions` when the inputs match."""
        a = cls(None, policy)
        for now, snap in ticks:
            with a._lock:
                a.recorded.append((now, snap))
                for d in a._decide_locked(snap, now):
                    a.decisions.append(d.to_line())
        return list(a.decisions)

    # ---- introspection ---------------------------------------------------
    def reset_stats(self):
        """Zero the METERING window (stats_block). Control state —
        hysteresis counters, cooldown marks, the tick index, the
        journal — is deliberately kept: resetting stats must not
        change the decision stream."""
        with self._lock:
            self._w_ticks = 0
            self._w_decisions = 0
            self._scale_ups = 0
            self._scale_downs = 0
            self._rebalances = 0
            self._holds = 0
            self._errors = 0
            self._migrations = 0
            self._replica_seconds = 0.0
            self._last_decision = None

    def stats_block(self):
        """The router's `stats()["autoscale"]` block (keys mirror
        `router.AUTOSCALE_ZERO`, the zeroed-when-disabled shape)."""
        with self._lock:
            return {
                "enabled": True,
                "ticks": self._w_ticks,
                "decisions": self._w_decisions,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "rebalances": self._rebalances,
                "holds": self._holds,
                "errors": self._errors,
                "migrations": self._migrations,
                "replica_seconds": self._replica_seconds,
                "last_decision": (dict(self._last_decision)
                                  if self._last_decision else None),
            }
