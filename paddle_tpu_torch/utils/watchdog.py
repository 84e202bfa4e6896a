"""Training watchdog — hang/failure detection for long-running loops:
the port's copy of `paddle_tpu.utils.watchdog` (host-side and
device-agnostic).

A training job can wedge without crashing: a stuck collective, a
dead data-loader worker, an unresponsive device tunnel. The watchdog is
a daemon thread armed with a step heartbeat; if no `beat()` arrives
within `timeout` seconds it (1) dumps every Python thread's stack to
stderr (or `dump_path`), (2) invokes `on_timeout` (e.g. an emergency
checkpoint via framework.io.async_save), and (3) applies `action`:
"warn" (keep waiting — it re-arms), "interrupt" (raise
KeyboardInterrupt in the main thread), or "abort" (os._exit for an
external supervisor to restart).

Action choice matters: "interrupt" is delivered when the main thread
next runs Python bytecode — it unwedges Python-level stalls (slow data
source, livelocked loop) and lets finally/except cleanup run, but it
CANNOT break a main thread blocked inside a C call (a stuck collective
or device transfer); for those, use action="abort" with a supervisor,
which always recovers. The stack dump and emergency callback run either
way, so the hang is diagnosable and the state is saved even when the
process must be killed.

    with Watchdog(timeout=300, on_timeout=save_emergency) as wd:
        for batch in loader:
            loss = train_step(batch)
            wd.beat(loss=float(loss))
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback

from ..observability import log as _log
from ..observability import metrics as _metrics

_logger = _log.get_logger(__name__)
# heartbeat age is PULLED at metrics-export time (gauge_fn) so the
# beat() hot path stays untouched; with several live watchdogs the
# gauge follows the most recently started one
_m_fired = _metrics.counter(
    "watchdog_fired_total", "watchdog timeouts observed")
_m_beats = _metrics.counter(
    "watchdog_beats_total", "heartbeats received")


class Watchdog:
    def __init__(self, timeout, on_timeout=None, action="interrupt",
                 dump_path=None, poll_interval=None):
        if action not in ("warn", "interrupt", "abort"):
            raise ValueError(
                f"action must be warn|interrupt|abort, got {action!r}")
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self.action = action
        self.dump_path = dump_path
        self.poll = poll_interval or min(1.0, self.timeout / 4)
        self._last = time.monotonic()
        self._beats = 0
        self._fired = 0
        self._stop = threading.Event()
        self._thread = None
        self._info = {}

    # ---- heartbeat -------------------------------------------------------
    def beat(self, **info):
        """Call once per training step; `info` (loss, step, ...) is shown
        in the timeout report."""
        self._last = time.monotonic()
        self._beats += 1
        _m_beats.inc()
        if info:
            self._info = info

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None  # reap a fired/finished thread: re-arm
        if self._thread is not None:
            return self
        # PER-START stop event: a previous thread still draining its
        # on_timeout callback holds the OLD event, so a stop()+start()
        # cycle can never let it resurrect and fire against the new run
        self._stop = threading.Event()
        self._last = time.monotonic()
        _metrics.REGISTRY.gauge_fn(
            "watchdog_heartbeat_age_seconds",
            "seconds since the last beat() of the active watchdog",
            lambda: time.monotonic() - self._last)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-tpu-watchdog",
                                        args=(self._stop,))
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll * 4)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def fired(self):
        return self._fired

    # ---- internals -------------------------------------------------------
    def _run(self, stop):
        # `stop` is THIS thread's own event (see start()) — checking the
        # instance attribute would race with a stop()+start() re-arm
        while not stop.wait(self.poll):
            idle = time.monotonic() - self._last
            if idle < self.timeout:
                continue
            self._fired += 1
            _m_fired.inc()
            self._report(idle)
            cb = self.on_timeout
            if cb is not None:
                try:
                    cb(self)
                except Exception:  # noqa: BLE001 — report, keep watching
                    traceback.print_exc(file=sys.stderr)
            # the callback takes time; if the loop finished cleanly and
            # stop() ran meanwhile, do NOT kill/interrupt a healthy exit
            if stop.is_set():
                return
            if self.action == "interrupt":
                import _thread
                _thread.interrupt_main()
                return
            if self.action == "abort":
                os._exit(70)  # EX_SOFTWARE: let the supervisor restart us
            self._last = time.monotonic()  # warn: re-arm

    def _report(self, idle):
        lines = [
            f"[watchdog] no heartbeat for {idle:.1f}s "
            f"(timeout {self.timeout:.0f}s, {self._beats} beats, "
            f"last info {self._info or '{}'}) — thread stacks:"]
        frames = sys._current_frames()
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            lines.append(f"--- thread {t.name} ({t.ident}) ---")
            if frame is not None:
                lines.extend(
                    ln.rstrip() for ln in traceback.format_stack(frame))
        report = "\n".join(lines)
        _logger.error(report)
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(report + "\n")
            except OSError:
                pass
