"""Declarative SLOs with multi-window burn rates: the port's copy of
`paddle_tpu.observability.slo`.

The metrics registry's fixed-bucket histograms are CUMULATIVE — they answer
"what was the TTFT distribution since reset", never "are we meeting the
latency objective RIGHT NOW". This module adds the missing production
layer:

  * `SLO` — one declarative objective: "`target` fraction of
    `objective` events must be good over `window_s`", where an event is
    good by latency threshold (ttft / itl under `threshold_s`) or by
    outcome (availability: the request finished; goodput: the decoded
    token reached a client). Scope by `lane` / `tenant` / `replica`
    (None = match everything — the fleet-wide objective).
  * sliding-window reservoirs — each SLO accumulates good/bad counts in
    coarse time buckets pruned past the window, so observation is O(1)
    and memory is O(window / bucket), never O(events).
  * multi-window burn rates — burn = (bad fraction) / (1 - target),
    i.e. how many times faster than budget the error budget is being
    spent. Evaluated over a FAST window (default window/12) and the
    SLOW window; state is

        page   burn >= page_burn on BOTH windows (the sustained-AND
               discipline of multiwindow burn alerts: the fast window
               proves it is still happening, the slow one that enough
               budget actually burned)
        warn   burn >= warn_burn on both windows
        ok     otherwise (including "not enough data": fewer than
               min_events in the slow window never alarms)

  * exports — `slo_burn_rate{slo,window}`, `slo_error_budget_remaining
    {slo}` and `slo_state{slo}` gauges on every `evaluate()`, plus the
    JSON report the `/slo` ops endpoint serves.
  * degrade hook — `paging(now, sustain_s)` names the SLOs that have
    been in `page` continuously for `sustain_s`; the fleet router feeds
    replica-scoped sustained pages into its replica state machine
    (`ReplicaHealth.note_not_ready`) so a latency-burning replica stops
    taking new placements.

All clocks are explicit (`now=` everywhere, `time.monotonic()` by
default) so the state machine is deterministic and unit-testable
without sleeping.
"""
from __future__ import annotations

import collections
import math
import threading
import time

from . import metrics as _metrics

OBJECTIVES = ("ttft", "itl", "availability", "goodput")
LATENCY_OBJECTIVES = ("ttft", "itl")
STATES = ("ok", "warn", "page")
STATE_CODES = {"ok": 0.0, "warn": 1.0, "page": 2.0}

_m_burn = _metrics.gauge(
    "slo_burn_rate",
    "error-budget burn rate per SLO and evaluation window (1.0 = "
    "spending exactly the budget; page/warn thresholds are per-SLO "
    "config)", labelnames=("slo", "window"))
_m_budget = _metrics.gauge(
    "slo_error_budget_remaining",
    "fraction of the SLO's error budget left over its slow window "
    "(1 - burn; negative = budget overspent)", labelnames=("slo",))
_m_state = _metrics.gauge(
    "slo_state",
    "SLO burn state: 0 ok, 1 warn, 2 page", labelnames=("slo",))


class SLO:
    """One declarative objective.

    objective: `ttft` | `itl` (latency: good = value <= threshold_s) or
        `availability` | `goodput` (outcome: good/bad fed directly).
    target: required good fraction over the window, in (0, 1)
        (e.g. 0.99 = "99% of first tokens under the threshold"). The
        error budget is 1 - target.
    threshold_s: the latency bound (required for ttft/itl, forbidden
        otherwise).
    window_s: the slow evaluation window. fast_window_s defaults to
        window_s / 12 (the classic 5m-of-1h ratio).
    lane / tenant / replica: scope filters; None matches every
        observation (the fleet-/server-wide objective).
    warn_burn / page_burn: burn-rate thresholds (both windows must
        cross — see module docstring).
    min_events: fewer observations than this in the slow window never
        alarms (cold start / idle server).
    """

    __slots__ = ("name", "objective", "target", "threshold_s",
                 "window_s", "fast_window_s", "lane", "tenant",
                 "replica", "warn_burn", "page_burn", "min_events")

    def __init__(self, objective, target, *, threshold_s=None,
                 window_s=300.0, fast_window_s=None, name=None,
                 lane=None, tenant=None, replica=None, warn_burn=2.0,
                 page_burn=10.0, min_events=10):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(objectives: {OBJECTIVES})")
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if objective in LATENCY_OBJECTIVES:
            if threshold_s is None or float(threshold_s) <= 0:
                raise ValueError(
                    f"objective {objective!r} needs threshold_s > 0, "
                    f"got {threshold_s}")
        elif threshold_s is not None:
            raise ValueError(f"objective {objective!r} takes no "
                             f"threshold_s (got {threshold_s})")
        if float(window_s) <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if fast_window_s is None:
            fast_window_s = float(window_s) / 12.0
        if not 0 < float(fast_window_s) <= float(window_s):
            raise ValueError(
                f"fast_window_s must be in (0, window_s], "
                f"got {fast_window_s}")
        if float(warn_burn) <= 0 or float(page_burn) < float(warn_burn):
            raise ValueError(
                f"need 0 < warn_burn <= page_burn, got "
                f"warn_burn={warn_burn} page_burn={page_burn}")
        if int(min_events) < 1:
            raise ValueError(f"min_events must be >= 1, "
                             f"got {min_events}")
        self.objective = objective
        self.target = float(target)
        self.threshold_s = (None if threshold_s is None
                            else float(threshold_s))
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s)
        self.lane = lane
        self.tenant = tenant
        self.replica = replica
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.min_events = int(min_events)
        if name is None:
            scope = "/".join(str(s) for s in (lane, tenant, replica)
                             if s is not None) or "all"
            thr = (f"<{self.threshold_s * 1e3:g}ms"
                   if self.threshold_s is not None else "")
            name = f"{objective}{thr}@{self.target:g}[{scope}]"
        self.name = str(name)

    @property
    def budget(self):
        return 1.0 - self.target

    def matches(self, lane=None, tenant=None, replica=None):
        return ((self.lane is None or self.lane == lane)
                and (self.tenant is None or self.tenant == tenant)
                and (self.replica is None or self.replica == replica))

    def describe(self):
        return {
            "name": self.name, "objective": self.objective,
            "target": self.target, "threshold_s": self.threshold_s,
            "window_s": self.window_s,
            "fast_window_s": self.fast_window_s,
            "lane": self.lane, "tenant": self.tenant,
            "replica": self.replica, "warn_burn": self.warn_burn,
            "page_burn": self.page_burn,
        }


def default_slos():
    """A reasonable server-wide starter set (`slos=True`): interactive
    TTFT, steady ITL, availability, goodput."""
    return [
        SLO("ttft", 0.99, threshold_s=2.0, window_s=300.0,
            name="ttft_p99_2s"),
        SLO("itl", 0.99, threshold_s=0.5, window_s=300.0,
            name="itl_p99_500ms"),
        SLO("availability", 0.999, window_s=300.0,
            name="availability_999"),
        SLO("goodput", 0.90, window_s=300.0, name="goodput_90"),
    ]


class _BucketWindow:
    """Good/bad counts in coarse time buckets, pruned past window_s —
    the sliding-window reservoir behind one SLO."""

    __slots__ = ("window_s", "bucket_s", "_buckets")

    def __init__(self, window_s, fast_window_s):
        self.window_s = float(window_s)
        # fast-window reads need several buckets of resolution
        self.bucket_s = max(float(fast_window_s) / 6.0, 0.01)
        self._buckets = collections.deque()  # [bucket_idx, good, bad]

    def add(self, now, good, n=1):
        b = math.floor(now / self.bucket_s)
        if self._buckets and self._buckets[-1][0] == b:
            rec = self._buckets[-1]
        else:
            self._prune(now)
            rec = [b, 0, 0]
            self._buckets.append(rec)
        rec[1 if good else 2] += int(n)

    def _prune(self, now):
        cutoff = math.floor((now - self.window_s) / self.bucket_s)
        while self._buckets and self._buckets[0][0] <= cutoff:
            self._buckets.popleft()

    def counts(self, now, horizon_s):
        """(good, bad) over the trailing horizon_s."""
        self._prune(now)
        cutoff = math.floor((now - horizon_s) / self.bucket_s)
        g = b = 0
        for idx, good, bad in self._buckets:
            if idx > cutoff:
                g += good
                b += bad
        return g, b


class SLOEngine:
    """Evaluates a set of SLOs over a live observation stream.

    slos: iterable of `SLO` (or True for `default_slos()`).
    Thread-safe; every method takes an explicit `now=` (monotonic
    seconds) for determinism, defaulting to time.monotonic().
    """

    def __init__(self, slos=True):
        if slos is True:
            slos = default_slos()
        slos = list(slos)
        if not slos:
            raise ValueError("SLOEngine needs >= 1 SLO")
        names = []
        for s in slos:
            if not isinstance(s, SLO):
                raise TypeError(f"slos must be SLO instances, "
                                f"got {type(s).__name__}")
            names.append(s.name)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = slos
        self._lock = threading.Lock()
        self._win = {s.name: _BucketWindow(s.window_s, s.fast_window_s)
                     for s in slos}
        self._page_since: dict[str, float] = {}
        self._last_eval: list | None = None

    # ---- observation ---------------------------------------------------
    def observe(self, objective, *, value_s=None, good=None, n=1,
                now=None, lane=None, tenant=None, replica=None):
        """Feed one (or `n` identical) observations. Latency
        objectives take `value_s` (good = under each matching SLO's
        threshold); outcome objectives take `good=`."""
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}")
        if now is None:
            now = time.monotonic()
        with self._lock:
            for s in self.slos:
                if s.objective != objective:
                    continue
                if not s.matches(lane=lane, tenant=tenant,
                                 replica=replica):
                    continue
                if s.threshold_s is not None:
                    if value_s is None:
                        raise ValueError(
                            f"objective {objective!r} needs value_s")
                    ok = float(value_s) <= s.threshold_s
                else:
                    if good is None:
                        raise ValueError(
                            f"objective {objective!r} needs good=")
                    ok = bool(good)
                self._win[s.name].add(now, ok, n)

    def observe_counts(self, objective, good_n, bad_n, *, now=None,
                       lane=None, tenant=None, replica=None):
        """Bulk outcome feed (goodput deltas per engine round)."""
        if good_n:
            self.observe(objective, good=True, n=good_n, now=now,
                         lane=lane, tenant=tenant, replica=replica)
        if bad_n:
            self.observe(objective, good=False, n=bad_n, now=now,
                         lane=lane, tenant=tenant, replica=replica)

    # ---- evaluation ----------------------------------------------------
    def evaluate(self, now=None):
        """Evaluate every SLO now; updates the slo_* gauges and the
        page-since timestamps, returns the per-SLO report list."""
        if now is None:
            now = time.monotonic()
        out = []
        with self._lock:
            for s in self.slos:
                win = self._win[s.name]
                fg, fb = win.counts(now, s.fast_window_s)
                sg, sb = win.counts(now, s.window_s)
                fast_n, slow_n = fg + fb, sg + sb
                burn_fast = ((fb / fast_n) / s.budget) if fast_n else 0.0
                burn_slow = ((sb / slow_n) / s.budget) if slow_n else 0.0
                if slow_n < s.min_events:
                    state = "ok"
                elif (burn_fast >= s.page_burn
                        and burn_slow >= s.page_burn):
                    state = "page"
                elif (burn_fast >= s.warn_burn
                        and burn_slow >= s.warn_burn):
                    state = "warn"
                else:
                    state = "ok"
                if state == "page":
                    self._page_since.setdefault(s.name, now)
                else:
                    self._page_since.pop(s.name, None)
                budget_remaining = 1.0 - burn_slow
                rec = {
                    "name": s.name,
                    "objective": s.objective,
                    "target": s.target,
                    "threshold_s": s.threshold_s,
                    "state": state,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "budget_remaining": round(budget_remaining, 4),
                    "events_fast": fast_n,
                    "events_slow": slow_n,
                    "bad_slow": sb,
                    "page_for_s": (round(now - self._page_since[s.name],
                                         3)
                                   if s.name in self._page_since
                                   else 0.0),
                    "scope": {"lane": s.lane, "tenant": s.tenant,
                              "replica": s.replica},
                }
                out.append(rec)
                _m_burn.labels(slo=s.name, window="fast").set(burn_fast)
                _m_burn.labels(slo=s.name, window="slow").set(burn_slow)
                _m_budget.labels(slo=s.name).set(budget_remaining)
                _m_state.labels(slo=s.name).set(STATE_CODES[state])
            self._last_eval = out
        return out

    def state(self, name, now=None):
        """One SLO's current state string."""
        for rec in self.evaluate(now):
            if rec["name"] == name:
                return rec["state"]
        raise KeyError(f"unknown SLO {name!r}")

    def worst_state(self, now=None):
        order = {s: i for i, s in enumerate(STATES)}
        return max((r["state"] for r in self.evaluate(now)),
                   key=order.__getitem__, default="ok")

    def paging(self, now=None, sustain_s=0.0):
        """Names of SLOs in `page` continuously for >= sustain_s — the
        replica-degrade hook the fleet router polls."""
        if now is None:
            now = time.monotonic()
        self.evaluate(now)
        with self._lock:
            return {name for name, t0 in self._page_since.items()
                    if now - t0 >= float(sustain_s)}

    def report(self, now=None):
        """The JSON document the /slo ops endpoint serves."""
        slos = self.evaluate(now)
        return {"slos": slos,
                "worst": max((r["state"] for r in slos),
                             key=lambda s: STATE_CODES[s],
                             default="ok"),
                "paging": sorted(self._page_since)}
