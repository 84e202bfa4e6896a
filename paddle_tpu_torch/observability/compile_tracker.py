"""Capture tracking at the graph boundaries: the port's counterpart of
`paddle_tpu.observability.compile_tracker`.

The reference counts XLA compiles at its jit boundaries: a fresh shape
bucket costs ~0.7 s there and lands on whatever requests are in flight.
PyTorch compiles nothing per shape. The port's costly first-use events
are CUDA graph CAPTURES: `DecodeGraphs` (a decode, verify or window
program per key) and `ProgramGraphs` (the dense decode program) capture
once per key, an eager warm-up plus the capture, and every later
dispatch replays. This module makes each capture a first-class,
attributable event, under the reference's API and metric names (ROADMAP
§C 18):

  * `DecodeGraphs` / `ProgramGraphs` call `record(program, seconds)`
    for every capture they make (`nn/decode_graph.py`), `program` naming
    the captured function (`multistep`, `packed_verify`,
    `unified_window`, or the dense program's key);
  * `wrap(program, fn)` returns a call-through wrapper that records a
    capture whenever `fn`'s capture count grew across the call: a
    callable exposing `_cache_size()` (the reference's protocol) or a
    `captures` counter (a `DecodeGraphs`);
  * each capture records `serving_xla_compiles_total{program,in_flight,
    shard}` and a `serving_xla_compile_seconds{program,shard}`
    observation (the reference's names, so its dashboards read the
    port's captures), emits a `compile` trace event (ts/dur: the request
    assembler attributes TTFT/ITL outliers to it), notifies the
    registered listeners (the per-server flight recorders), and lands
    in a bounded in-process event log;
  * `in_flight` comes from registered probes (each serving engine
    registers "do I have busy slots or queued work" by weakref), so
    `warm_buckets()` captures before start() label
    `in_flight="false"`, and a capture-clean measurement window is
    `count_since(mark, in_flight=True) == 0`.

The tracker is always on: captures are rare and their cost is seconds,
so recording one costs nothing that matters. Metric emission goes
through the registry's enabled gate like everything else; the event log
and the window API work regardless.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

from . import metrics as _metrics
from . import tracing as _tracing

# capture durations are big (0.05 s .. a minute with the kernel build)
COMPILE_BUCKETS = (.05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0)

_m_compiles = _metrics.counter(
    "serving_xla_compiles_total",
    "CUDA graph captures (the port's counterpart of the reference's XLA "
    "compiles), by program (multistep | packed_verify | unified_window "
    "| the dense program), whether requests were in flight, and shard "
    "label ('none' unsharded)",
    labelnames=("program", "in_flight", "shard"))
_m_compile_s = _metrics.histogram(
    "serving_xla_compile_seconds",
    "wall duration of a capture (eager warm-up + capture: the latency "
    "that lands on in-flight requests)",
    labelnames=("program", "shard"), buckets=COMPILE_BUCKETS)

EVENT_LOG_CAPACITY = 4096


class CompileTracker:
    """Process-wide capture event log + in-flight probe registry.
    Instantiable for tests; `TRACKER` is the default instance the graph
    caches record into."""

    def __init__(self, capacity=EVENT_LOG_CAPACITY):
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=capacity)
        self._total = 0
        self._total_in_flight = 0
        self._probes = []     # weakref.WeakMethod / weakref.ref
        self._listeners = []  # same, called with each event dict

    # -- probes / listeners ----------------------------------------------
    def _weak(self, fn):
        try:
            return weakref.WeakMethod(fn)
        except TypeError:
            return weakref.ref(fn)

    def register_in_flight_probe(self, fn):
        """Register a zero-arg callable answering "does your engine
        have live work right now". Held by weakref (bound methods via
        WeakMethod) so a garbage-collected server needs no unregister."""
        with self._lock:
            self._probes.append(self._weak(fn))

    def add_listener(self, fn):
        """Register a callable(event_dict) notified on every capture —
        the per-server flight recorders. Weakly held, like probes."""
        with self._lock:
            self._listeners.append(self._weak(fn))

    def _live(self, refs):
        out, dead = [], False
        for r in refs:
            fn = r()
            if fn is None:
                dead = True
            else:
                out.append((r, fn))
        if dead:
            refs[:] = [r for r, _ in out]
        return [fn for _, fn in out]

    def in_flight(self):
        with self._lock:
            probes = self._live(self._probes)
        for p in probes:
            try:
                if p():
                    return True
            except Exception:  # noqa: BLE001 — a dying server's probe
                continue  # must not break capture accounting
        return False

    # -- recording -------------------------------------------------------
    def record(self, program, dur_s, shard="none", in_flight=None):
        if in_flight is None:
            in_flight = self.in_flight()
        ev = {"program": program, "dur_s": float(dur_s),
              "in_flight": bool(in_flight), "shard": shard,
              "ts": time.perf_counter()}
        with self._lock:
            self._total += 1
            if ev["in_flight"]:
                self._total_in_flight += 1
            self._events.append(ev)
            listeners = self._live(self._listeners)
        flag = "true" if ev["in_flight"] else "false"
        _m_compiles.labels(program=program, in_flight=flag,
                           shard=shard).inc()
        _m_compile_s.labels(program=program, shard=shard).observe(dur_s)
        # the trace event carries the capture's START ts so the request
        # assembler can overlap it with request windows
        _tracing.event("compile", ts=ev["ts"] - ev["dur_s"],
                       dur=ev["dur_s"], program=program,
                       in_flight=ev["in_flight"], shard=shard)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001
                pass
        return ev

    # -- window API ------------------------------------------------------
    def mark(self):
        """Opaque window mark: pass back to count_since/events_since."""
        with self._lock:
            return self._total

    def count_since(self, mark, in_flight=None):
        """Captures since `mark`, optionally only those with the given
        in-flight flag — a measurement window's capture-clean check."""
        evs = self.events_since(mark)
        if in_flight is None:
            return len(evs)
        return sum(1 for e in evs if e["in_flight"] == bool(in_flight))

    def events_since(self, mark):
        with self._lock:
            n = self._total - int(mark)
            if n <= 0:
                return []
            return list(self._events)[-min(n, len(self._events)):]

    def stats(self):
        with self._lock:
            return {"total": self._total,
                    "total_in_flight": self._total_in_flight}

    # -- the boundary wrapper --------------------------------------------
    def wrap(self, program, fn, shard="none"):
        """Wrap a capturing callable: every call whose capture count
        grew is recorded as a capture of `program`. The count is
        `fn._cache_size()` (the reference's protocol) or `fn.captures`
        (a `DecodeGraphs`, a `ProgramGraphs`); a callable with neither
        is returned untouched (nothing to detect)."""
        size = getattr(fn, "_cache_size", None)
        if size is None and hasattr(fn, "captures"):
            def size():
                return fn.captures
        if size is None:
            return fn
        tracker = self

        def wrapped(*args, **kw):
            n0 = size()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if size() > n0:
                tracker.record(program, time.perf_counter() - t0, shard)
            return out

        wrapped.__name__ = getattr(fn, "__name__", program)
        wrapped.__wrapped__ = fn
        return wrapped


# ---- process-wide default tracker ---------------------------------------
TRACKER = CompileTracker()


def record(program, dur_s, shard="none", in_flight=None):
    return TRACKER.record(program, dur_s, shard, in_flight)


def wrap(program, fn, shard="none"):
    return TRACKER.wrap(program, fn, shard)


def register_in_flight_probe(fn):
    TRACKER.register_in_flight_probe(fn)


def add_listener(fn):
    TRACKER.add_listener(fn)


def mark():
    return TRACKER.mark()


def count_since(m, in_flight=None):
    return TRACKER.count_since(m, in_flight)


def events_since(m):
    return TRACKER.events_since(m)


def stats():
    return TRACKER.stats()
