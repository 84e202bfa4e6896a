"""Flight recorder + stall watchdog: the port's copy of
`paddle_tpu.observability.flight_recorder`.

A serving engine that slows down or wedges AFTER the fact is
undiagnosable from counters alone — counters say *that* throughput
dropped, not *which* request/dispatch/pool state it dropped on. The
flight recorder is a bounded, deterministic ring buffer of structured
engine events (admission, chunk plans, dispatch shapes, preemptions,
pool levels, graph captures, exceptions) that costs one bool check per
event when disabled and whose `dump()` reconstructs the last N engine
decisions on demand.

Two triggers auto-dump it:

  * the **stall watchdog** — a daemon thread sampling an engine-owned
    progress counter; work pending with no dispatch progress past the
    threshold flips health to "stalled" and dumps the ring (the
    post-hoc record of WHAT the engine was doing when it stopped);
  * an **unhandled engine exception** — the engine's dispatch except
    paths record the error and dump before fanning it to futures.

Both the recorder and the watchdog are owned per-server (the ops plane
of `PagedGenerationServer(expose_port=...)` enables them); the classes
here are engine-agnostic and instantiable for tests. Events carry a
monotonic sequence number and `time.perf_counter()` timestamps, so a
dump is deterministic and totally ordered even across threads.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time

from . import log as _log
from . import metrics as _metrics

_logger = _log.get_logger(__name__)

DEFAULT_CAPACITY = 512

_m_stalls = _metrics.counter(
    "serving_stalls_total",
    "stall-watchdog trips: work pending with no dispatch progress past "
    "the threshold (health flips to 'stalled', flight recorder dumps)")
_m_dumps = _metrics.counter(
    "serving_flight_recorder_dumps_total",
    "flight-recorder auto-dumps, by what triggered them",
    labelnames=("trigger",))


class FlightRecorder:
    """Bounded ring buffer of structured engine events.

    enabled=False (the default) makes `record()` one attribute load and
    a bool branch — the engine hooks stay in place at zero cost, the
    telemetry convention of the whole observability package. The ops
    plane enables it; tests can pass enabled=True directly.
    """

    def __init__(self, capacity=DEFAULT_CAPACITY, enabled=False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._dumps = 0
        self.last_dump = None  # {"trigger", "ts", "events"} of the last
        # auto- or manual dump, kept for /statusz

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # -- recording -------------------------------------------------------
    def record(self, name, **attrs):
        """Append one event; no-op when disabled. `attrs` must be
        JSON-serializable (the engine passes ints/floats/strings)."""
        if not self.enabled:
            return
        ev = {"name": name, "ts": time.perf_counter()}
        ev.update(attrs)
        with self._lock:
            ev["seq"] = next(self._seq)
            self._ring.append(ev)

    # -- dumping ---------------------------------------------------------
    def events(self):
        """Snapshot of the ring, oldest first (bounded at capacity)."""
        with self._lock:
            return list(self._ring)

    def dump(self, trigger="manual", sink=None):
        """Snapshot the ring and remember it as `last_dump`. Auto-dump
        callers pass their trigger ("stall", "engine_exception"); the
        dump also goes to the library logger (one line per event would
        flood — the whole dump is one JSON blob) and to `sink(dump)`
        when given."""
        evs = self.events()
        d = {"trigger": trigger, "ts": time.perf_counter(),
             "events": evs, "n_events": len(evs)}
        with self._lock:
            self._dumps += 1
            self.last_dump = d
        _m_dumps.labels(trigger=trigger).inc()
        if trigger != "manual":
            _logger.error("flight recorder dump (%s): %s", trigger,
                          json.dumps(evs))
        if sink is not None:
            try:
                sink(d)
            except Exception:  # noqa: BLE001 — a sink must not cascade
                _logger.exception("flight recorder dump sink failed")
        return d

    def stats(self):
        with self._lock:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "events": len(self._ring), "dumps": self._dumps,
                    "last_dump_trigger": (self.last_dump or {}).get(
                        "trigger")}

    def clear(self):
        with self._lock:
            self._ring.clear()


class StallWatchdog:
    """Flags an engine that has pending work but makes no dispatch
    progress for longer than `timeout` seconds.

    progress_fn: returns a monotonically increasing int the engine bumps
        on every dispatch/admission (reads are lock-free — the GIL makes
        int loads atomic and staleness only delays detection one poll).
    pending_fn: returns True while the engine has work (busy slots or a
        non-empty queue) — an idle engine is never stalled.
    on_stall: called ONCE per stall episode (the flight-recorder
        auto-dump); exceptions are logged, never propagated.
    on_recover: called when progress resumes after a stall.
    """

    def __init__(self, progress_fn, pending_fn, timeout=30.0,
                 on_stall=None, on_recover=None, poll=None):
        self.timeout = float(timeout)
        if self.timeout <= 0:
            raise ValueError("timeout must be > 0")
        self._progress_fn = progress_fn
        self._pending_fn = pending_fn
        self._on_stall = on_stall
        self._on_recover = on_recover
        self.poll = poll if poll is not None else min(
            1.0, self.timeout / 4)
        self._stalled = False
        self._stalls = 0
        self._stop = None
        self._thread = None

    @property
    def stalled(self):
        return self._stalled

    @property
    def stalls(self):
        return self._stalls

    def start(self):
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True,
            name="paddle-tpu-stall-watchdog")
        self._thread.start()
        return self

    def stop(self):
        if self._stop is not None:
            self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll * 4)

    def _fire(self, cb):
        if cb is None:
            return
        try:
            cb()
        except Exception:  # noqa: BLE001 — watchdog must keep running
            _logger.exception("stall watchdog callback failed")

    def _run(self, stop):
        last_progress = self._progress_fn()
        last_change = time.monotonic()
        while not stop.wait(self.poll):
            try:
                progress = self._progress_fn()
                pending = self._pending_fn()
            except Exception:  # noqa: BLE001 — a dying engine must not
                continue  # kill its own diagnostics thread
            now = time.monotonic()
            if progress != last_progress or not pending:
                last_progress = progress
                last_change = now
                if self._stalled:
                    self._stalled = False
                    _logger.warning(
                        "stall watchdog: progress resumed after %d "
                        "stall(s)", self._stalls)
                    self._fire(self._on_recover)
                continue
            if not self._stalled and now - last_change > self.timeout:
                self._stalled = True
                self._stalls += 1
                _m_stalls.inc()
                _logger.error(
                    "stall watchdog: no dispatch progress for %.1fs "
                    "with work pending (threshold %.1fs)",
                    now - last_change, self.timeout)
                self._fire(self._on_stall)
