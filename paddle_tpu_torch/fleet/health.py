"""Replica health state machine: the port's copy of
`paddle_tpu.fleet.health`.

One `ReplicaHealth` per replica, driven by two signal classes:

  * ACTIVE probes — the router's probe loop calls the replica's split
    health surface (`liveness()` / `readiness()`, the /healthz
    views) on an interval and feeds the outcome in;
  * PASSIVE dispatch outcomes — every routed request's completion or
    failure (`note_ok` / `note_failure`) updates the same state, so a
    replica that probes healthy but fails real traffic still opens.

States and routing weight:

    ok         weight 1.0      route normally
    degraded   weight w_d      >= 1 recent failure, not yet open —
                               route, but deprioritized
    open       weight 0.0      `open_after` consecutive failures —
                               circuit OPEN; after a capped-exponential
                               backoff the next `routable()` read
                               half-opens it
    half_open  weight eps      exactly ONE trial placement (or probe)
                               is allowed through; success -> ok,
                               failure -> open with doubled backoff
    not_ready  weight 0.0      the replica is alive but draining or
                               stalled (readiness false): route
                               nothing NEW, fail nothing over
    dead       weight 0.0      liveness failed / killed — terminal;
                               the router fails its sessions over

All transitions take an explicit `now` so the machine is deterministic
and unit-testable without sleeping; the router passes
`time.monotonic()`.
"""
from __future__ import annotations

import threading

STATES = ("ok", "degraded", "open", "half_open", "not_ready", "dead")


class ReplicaHealth:
    """Per-replica circuit breaker + routing weight.

    open_after: consecutive failures (probe or dispatch) that OPEN the
        circuit (>= 1).
    backoff_base_s / backoff_cap_s: capped exponential half-open probe
        schedule — open episode k waits min(cap, base * 2**(k-1))
        before allowing one trial.
    degraded_weight: routing weight while degraded (failures seen but
        the circuit has not opened).
    """

    def __init__(self, *, open_after=3, backoff_base_s=0.5,
                 backoff_cap_s=30.0, degraded_weight=0.25):
        if int(open_after) < 1:
            raise ValueError(f"open_after must be >= 1, "
                             f"got {open_after}")
        if float(backoff_base_s) <= 0:
            raise ValueError(f"backoff_base_s must be > 0, "
                             f"got {backoff_base_s}")
        if float(backoff_cap_s) < float(backoff_base_s):
            raise ValueError(
                f"backoff_cap_s ({backoff_cap_s}) must be >= "
                f"backoff_base_s ({backoff_base_s})")
        if not 0.0 < float(degraded_weight) <= 1.0:
            raise ValueError(f"degraded_weight must be in (0, 1], "
                             f"got {degraded_weight}")
        self.open_after = int(open_after)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.degraded_weight = float(degraded_weight)
        self._lock = threading.Lock()
        self._state = "ok"
        self._consecutive_failures = 0
        self._open_episodes = 0   # total times the circuit opened
        self._opened_at = None    # when the current open began
        self._trial_inflight = False
        self._transitions = 0
        self._last_failure = None  # short reason string

    # ---- introspection -------------------------------------------------
    @property
    def state(self):
        return self._state

    @property
    def consecutive_failures(self):
        return self._consecutive_failures

    @property
    def open_episodes(self):
        return self._open_episodes

    def _set(self, state):
        if state != self._state:
            self._state = state
            self._transitions += 1

    def backoff_s(self):
        """The current open episode's half-open wait."""
        k = max(1, self._open_episodes)
        return min(self.backoff_cap_s,
                   self.backoff_base_s * 2.0 ** (k - 1))

    # ---- signals -------------------------------------------------------
    def note_ok(self, now):
        """A successful dispatch or healthy+ready probe."""
        with self._lock:
            if self._state == "dead":
                return
            if self._state in ("half_open", "open"):
                # the trial (or a late success) closes the circuit
                self._open_episodes = 0
                self._opened_at = None
            self._trial_inflight = False
            self._consecutive_failures = 0
            self._last_failure = None
            self._set("ok")

    def note_failure(self, now, reason=""):
        """A failed dispatch, unreachable probe, or trial failure."""
        with self._lock:
            if self._state == "dead":
                return
            self._consecutive_failures += 1
            self._last_failure = str(reason) or None
            self._trial_inflight = False
            if self._state == "half_open" \
                    or self._consecutive_failures >= self.open_after:
                # re-open (doubling the backoff) or first open
                self._open_episodes += 1
                self._opened_at = float(now)
                self._set("open")
            else:
                self._set("degraded")

    def note_not_ready(self, now, reason=""):
        """An alive-but-not-accepting probe (draining / stalled):
        weight 0 without touching the failure streak or the circuit —
        when readiness returns, the prior state resumes via the next
        ok/failure signal."""
        with self._lock:
            if self._state in ("dead", "open", "half_open"):
                return
            self._last_failure = str(reason) or None
            self._set("not_ready")

    def mark_dead(self, reason=""):
        with self._lock:
            self._last_failure = str(reason) or self._last_failure
            self._set("dead")

    # ---- routing -------------------------------------------------------
    def routing_weight(self, now):
        """The router's placement weight RIGHT NOW. Reading this can
        half-open an open circuit whose backoff has elapsed: the next
        read returns a small trial weight exactly once — the single
        in-flight trial the half-open contract allows."""
        with self._lock:
            if self._state in ("dead", "not_ready"):
                return 0.0
            if self._state == "ok":
                return 1.0
            if self._state == "degraded":
                return self.degraded_weight
            if self._state == "open":
                if float(now) - self._opened_at >= self.backoff_s():
                    self._set("half_open")
                else:
                    return 0.0
            # half_open: one trial at a time
            if self._trial_inflight:
                return 0.0
            self._trial_inflight = True
            return 1e-3

    def probe_due(self, now):
        """Whether an ACTIVE probe should run now: always, except
        while the circuit is open and the backoff has not elapsed
        (capped-backoff half-open probing — the router's probe loop
        asks this before touching an open replica)."""
        with self._lock:
            if self._state == "dead":
                return False
            if self._state == "open":
                return float(now) - self._opened_at >= self.backoff_s()
            return True

    def stats(self):
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "open_episodes": self._open_episodes,
                "backoff_s": (self.backoff_s()
                              if self._open_episodes else 0.0),
                "transitions": self._transitions,
                "last_failure": self._last_failure,
            }
