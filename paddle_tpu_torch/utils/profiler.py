"""Profiler of the port (the reference's `paddle_tpu/utils/profiler.py`,
Paddle's python/paddle/fluid/profiler.py), over `torch.profiler`.

  * `profiler()` / `start_profiler()` / `stop_profiler()` trace a window
    and write its Chrome trace (`trace.json`) under `profile_path`: the
    device's kernels on the card, the host's ops when the state is "CPU"
    or the default device is the CPU;
  * `RecordEvent` / `record_event`, `summary()`, `reset()`: the host-side
    event timer, as the reference's;
  * `top_ops(fn)` / `print_top_ops(fn)`: `fn()` once to warm up, then
    `steps` calls under `torch.profiler`, aggregated by name into
    [(name, total_ms, count)], heaviest first. One timeline level is
    counted: on the card the device kernels (`self_device_time_total`),
    on the CPU each op's self time, so that no envelope (a module, a
    step) is counted on top of its members. The reference parses an XLA
    xplane for the same table.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict

import torch

from ..device import resolve_device
from ..observability import log as _log

_logger = _log.get_logger(__name__)
_records = defaultdict(list)
_active = {}


def _default_path():
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile")


def _on_card(state="All", device=None):
    """True when the window traces the card: the state "GPU", or "All"
    with a card as the device (the default one when None); "CPU" traces
    the host. Asking for a card where there is none raises."""
    if state == "CPU":
        return False
    return resolve_device("cuda" if state == "GPU" else device).type == \
        "cuda"


def _activities(on_card, include_host=True):
    acts = [torch.profiler.ProfilerActivity.CUDA] if on_card else []
    if include_host or not on_card:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return acts


def start_profiler(state="All", tracer_option="Default",
                   profile_path=None):
    on_card = _on_card(state)
    prof = torch.profiler.profile(activities=_activities(on_card))
    prof.start()
    _active.update(prof=prof, path=profile_path or _default_path(),
                   on_card=on_card, t0=time.time())


def stop_profiler(sorted_key=None, profile_path=None):
    if not _active:
        return
    if _active["on_card"]:
        torch.cuda.synchronize()
    prof = _active["prof"]
    prof.stop()
    path = profile_path or _active["path"]
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    _logger.info("[profiler] trace written to %s (%.2fs)", path,
                 time.time() - _active["t0"])
    _active.clear()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    start_profiler(state, profile_path=profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key)


class RecordEvent:
    """Host-side event timer: context manager AND decorator.

        with RecordEvent("matmul"): ...
        @record_event("step")            # or bare @record_event: the
        def step(...): ...               # event is named after the fn
    """

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _records[self.name].append(time.perf_counter() - self._t0)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)
        return wrapped


def record_event(name):
    """RecordEvent factory; also usable as a bare decorator
    (`@record_event`), naming the event after the function."""
    if callable(name):
        return RecordEvent(name.__qualname__)(name)
    return RecordEvent(name)


def summary():
    """Per-event stats: count/total/mean plus min/max/p50/p99 (nearest-
    rank percentiles over the recorded samples)."""
    out = {}
    for name, times in _records.items():
        ts = sorted(times)
        n = len(ts)
        total = sum(ts)
        pct = (lambda p: ts[min(n - 1, int(p * n))])
        out[name] = {"count": n, "total": total, "mean": total / n,
                     "min": ts[0], "max": ts[-1],
                     "p50": pct(0.50), "p99": pct(0.99)}
    return out


def reset():
    _records.clear()


def _aggregate_ops(fn, steps, trace_dir, include_host, device=None):
    """{name: [total_ms, count]} of `steps` calls of `fn()` (after one
    warm call) under torch.profiler: the device kernels on the card (and
    the host ops' self time with `include_host`), each op's self time on
    the CPU. With `trace_dir` the Chrome trace is written there."""
    on_card = _on_card(device=device)
    fn()
    if on_card:
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=_activities(on_card, include_host)) as prof:
        for _ in range(steps):
            fn()
        if on_card:
            torch.cuda.synchronize()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    cuda = torch.autograd.DeviceType.CUDA
    totals = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        if on_card and ev.device_type == cuda:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        elif ev.device_type != cuda and (include_host or not on_card):
            us = ev.self_cpu_time_total
        else:
            continue
        if us > 0:
            t = totals[ev.key]
            t[0] += us / 1e3
            t[1] += ev.count
    return totals


def top_ops(fn, steps=3, k=25, trace_dir=None, include_host=False,
            device=None):
    """Profile `fn()` (a zero-argument callable) and return the top-k ops
    by total time: [(op_name, total_ms, count)] — the device kernels on
    the card (the default device unless `device="cpu"`), the host ops'
    self time on the CPU."""
    totals = _aggregate_ops(fn, steps, trace_dir, include_host, device)
    return sorted(((n, ms, c) for n, (ms, c) in totals.items()),
                  key=lambda x: -x[1])[:k]


def print_top_ops(fn, steps=3, k=25, device=None):
    totals = _aggregate_ops(fn, steps, None, False, device)
    grand = sum(ms for ms, _ in totals.values())
    rows = sorted(((n, ms, c) for n, (ms, c) in totals.items()),
                  key=lambda x: -x[1])[:k]
    shown = sum(ms for _, ms, _ in rows)
    print(f"{'op':<60} {'ms':>10} {'count':>7} {'%':>6}")  # cli-print
    for name, ms, c in rows:
        print(f"{name[:60]:<60} {ms:>10.3f} {c:>7} "  # cli-print: table
              f"{100 * ms / max(grand, 1e-9):>5.1f}%")
    print(f"# top-{len(rows)} covers "  # cli-print: print_top_ops report
          f"{100 * shown / max(grand, 1e-9):.1f}% "
          f"of {grand:.1f}ms total op time")
    return rows
