"""Deterministic capacity / pressure signals: the port's copy of
`paddle_tpu.observability.capacity`.

`PressureSignals` is the pull-based sampler that turns the engine's
scattered load indicators — pool headroom, tier occupancy, lane and
tenant queue depths, admission sheds, `BlockPoolExhausted`
needed/available pressure, SLO burn rates — into ONE versioned
snapshot, plus a forecast: the reclaim-rate trend and a
blocks-exhaustion ETA from a linear fit over the sample window.

Discipline is the same as `utils.net.TokenBucket`: an explicit
injectable clock and a min-interval gate, so sampling is deterministic
and replay-testable — feed a fake clock, get byte-identical snapshot
sequences. Sources are zero-arg callables; a source that raises is
reported as `{"error": ...}` in its slot instead of poisoning the
snapshot (dead-source tolerance, same rule the fleet federation
applies across replicas).

The snapshot schema (`schema_version` 1) is the contract surface an
autoscaler's control loop consumes.
"""
from __future__ import annotations

import threading
import time
from collections import deque

SCHEMA_VERSION = 1

#: the FEDERATED snapshot's version: 2 added the
#: fleet-level "aggregate" block alongside the per-replica slots.
#: Per-replica snapshots keep their own SCHEMA_VERSION.
FLEET_SCHEMA_VERSION = 2


def _linear_slope(points):
    """Least-squares slope of (t, v) points; None with < 2 points."""
    n = len(points)
    if n < 2:
        return None
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    num = sum((t - mt) * (v - mv) for t, v in points)
    den = sum((t - mt) ** 2 for t, _ in points)
    if den == 0:
        return None
    return num / den


class PressureSignals:
    """Assemble the named `sources` into versioned pressure snapshots.

    `sources` maps slot name ("pool", "tier", "queues", "admission",
    "slo", ...) to a zero-arg callable returning a JSON-able dict.
    `maybe_sample()` honors `min_interval_s` on the explicit clock
    (call it every engine round; it is nearly always a no-op);
    `sample()` forces one. The newest snapshot is kept for `snapshot()`
    and the pool's `free_blocks` series feeds the exhaustion forecast.
    """

    def __init__(self, sources, *, min_interval_s=1.0, window=32,
                 clock=None):
        self._sources = dict(sources)
        self._min_interval = float(min_interval_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._free_series = deque(maxlen=int(window))
        self._last_t = None          # last sample time (gate)
        self._last = None            # last snapshot
        self._n_samples = 0

    def add_source(self, name, fn):
        with self._lock:
            self._sources[name] = fn

    def _read_sources(self):
        out = {}
        for name, fn in self._sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # dead-source tolerance
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def _forecast_locked(self, now, pool):
        free = pool.get("free_blocks") if isinstance(pool, dict) else None
        if isinstance(free, (int, float)):
            self._free_series.append((now, free))
        slope = _linear_slope(list(self._free_series))
        eta = None
        if slope is not None and slope < 0 and self._free_series:
            last_free = self._free_series[-1][1]
            if last_free > 0:
                eta = last_free / -slope
        return {
            # blocks/s the free list is draining (<0) or refilling (>0)
            "free_blocks_slope_per_s": slope,
            "exhaustion_eta_s": (None if eta is None
                                 else round(eta, 3)),
            "window_samples": len(self._free_series),
        }

    def sample(self, now=None):
        """Take one snapshot unconditionally; returns it."""
        now = self._clock() if now is None else now
        readings = self._read_sources()
        with self._lock:
            self._last_t = now
            self._n_samples += 1
            snap = {
                "schema_version": SCHEMA_VERSION,
                "ts": now,
                "samples": self._n_samples,
                "forecast": self._forecast_locked(
                    now, readings.get("pool")),
            }
            snap.update(readings)
            self._last = snap
            return snap

    def maybe_sample(self, now=None):
        """Sample iff `min_interval_s` elapsed since the last sample
        (TokenBucket-style gate). Returns the new snapshot or None."""
        now = self._clock() if now is None else now
        with self._lock:
            if (self._last_t is not None
                    and now - self._last_t < self._min_interval):
                return None
        return self.sample(now)

    def snapshot(self, now=None, refresh=True):
        """The newest snapshot; samples fresh when none exists yet (or
        always, with `refresh=True` — the `/capacity` endpoint path)."""
        if refresh:
            return self.sample(now)
        with self._lock:
            return self._last

    def history_len(self):
        with self._lock:
            return len(self._free_series)


def fleet_aggregate(replicas):
    """Fold per-replica capacity snapshots into the fleet-level
    aggregate block so autoscale policies never
    re-derive it: total free/used blocks, min headroom fraction, max
    SLO burn, summed queue depth and shed pressure, plus the soonest
    blocks-exhaustion ETA. Tolerates old-shape sources — a replica
    slot that is an error, or predates a field, simply contributes
    nothing to that field."""
    agg = {
        "replicas_total": len(replicas),
        "replicas_ok": 0,
        "replicas_error": 0,
        "free_blocks_total": 0,
        "used_blocks_total": 0,
        "num_blocks_total": 0,
        "min_headroom_frac": None,
        "max_burn": None,
        "queue_depth_total": 0,
        "busy_slots_total": 0,
        "max_slots_total": 0,
        "sheds_total": 0,
        "draining": 0,
        "min_exhaustion_eta_s": None,
    }
    for snap in replicas.values():
        if not isinstance(snap, dict) or "error" in snap:
            agg["replicas_error"] += 1
            continue
        agg["replicas_ok"] += 1
        pool = snap.get("pool")
        if isinstance(pool, dict) and "error" not in pool:
            free = pool.get("free_blocks")
            used = pool.get("used_blocks")
            num = pool.get("num_blocks")
            if isinstance(free, (int, float)):
                agg["free_blocks_total"] += int(free)
            if isinstance(used, (int, float)):
                agg["used_blocks_total"] += int(used)
            if isinstance(num, (int, float)):
                agg["num_blocks_total"] += int(num)
            if (isinstance(free, (int, float))
                    and isinstance(num, (int, float)) and num > 0):
                frac = free / num
                if (agg["min_headroom_frac"] is None
                        or frac < agg["min_headroom_frac"]):
                    agg["min_headroom_frac"] = frac
        queues = snap.get("queues")
        if isinstance(queues, dict) and "error" not in queues:
            for src, dst in (("queue_depth", "queue_depth_total"),
                             ("busy_slots", "busy_slots_total"),
                             ("max_slots", "max_slots_total")):
                v = queues.get(src)
                if isinstance(v, (int, float)):
                    agg[dst] += int(v)
        adm = snap.get("admission")
        if isinstance(adm, dict) and "error" not in adm:
            sheds = adm.get("sheds")
            if isinstance(sheds, (int, float)):
                agg["sheds_total"] += int(sheds)
            if adm.get("draining"):
                agg["draining"] += 1
        slo = snap.get("slo")
        if isinstance(slo, dict) and slo.get("enabled"):
            for s in slo.get("slos") or ():
                if not isinstance(s, dict):
                    continue
                for k in ("burn_fast", "burn_slow"):
                    b = s.get(k)
                    if isinstance(b, (int, float)) and (
                            agg["max_burn"] is None
                            or b > agg["max_burn"]):
                        agg["max_burn"] = b
        fc = snap.get("forecast")
        if isinstance(fc, dict):
            eta = fc.get("exhaustion_eta_s")
            if isinstance(eta, (int, float)) and (
                    agg["min_exhaustion_eta_s"] is None
                    or eta < agg["min_exhaustion_eta_s"]):
                agg["min_exhaustion_eta_s"] = eta
    return agg


def federate_capacity(sources, timeout_s=None):
    """Fold named per-replica capacity callables into one fleet
    snapshot, tolerating dead sources — the JSON twin of
    `fleet.federation.federate_metrics`.

    `sources`: dict name -> zero-arg callable returning a snapshot
    dict. A source that raises contributes `{"error": ...}` under its
    name instead of failing the page.

    `timeout_s`: per-snapshot deadline. A source that HANGS (e.g. a
    wedged subprocess replica whose socket accepts but never answers)
    degrades to an error slot exactly like a dead one, instead of
    stalling the whole page: sources run on daemon worker threads and
    any still unfinished at the deadline is abandoned (its thread
    dies with the process; the next snapshot probes it afresh).
    None = synchronous in-caller calls (no threads), the in-process
    fleet shape.
    """
    replicas = {}
    if timeout_s is None:
        for name, fn in sources.items():
            try:
                replicas[name] = fn()
            except Exception as e:
                replicas[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"schema_version": FLEET_SCHEMA_VERSION,
                "replicas": replicas,
                "aggregate": fleet_aggregate(replicas)}

    results = {}
    threads = {}
    for name, fn in sources.items():
        def _run(n=name, f=fn):
            try:
                results[n] = f()
            except Exception as e:  # noqa: BLE001 — error slot
                results[n] = {"error": f"{type(e).__name__}: {e}"}

        t = threading.Thread(target=_run, daemon=True,
                             name=f"capacity-{name}")
        t.start()
        threads[name] = t
    deadline = time.monotonic() + float(timeout_s)
    for name, t in threads.items():
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if name in results:
            replicas[name] = results[name]
        else:
            replicas[name] = {
                "error": f"timeout: no capacity snapshot within "
                         f"{float(timeout_s):g}s"}
    return {"schema_version": FLEET_SCHEMA_VERSION,
            "replicas": replicas,
            "aggregate": fleet_aggregate(replicas)}
