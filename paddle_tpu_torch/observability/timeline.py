"""Chrome/Perfetto trace-event timeline export: the port's copy of
`paddle_tpu.observability.timeline`.

Counters say THAT cross-replica overlap happened; a timeline shows it.
This module lays the span sink (tracer events, stamped with a
`replica` attribute) and the per-replica flight-recorder rings
out as Chrome trace-event JSON — the format `chrome://tracing` and
https://ui.perfetto.dev open directly:

  * one PROCESS per replica (plus one for the router / unattributed
    events), named via `process_name` metadata events;
  * one TRACK (thread) per event family inside each replica —
    `dispatch` (engine rounds, decode/prefill/verify dispatch spans),
    `requests` (submit/admit/done/detokenize), `compiles`, `faults`
    (fault injection, recovery, quarantine, stalls), `lifecycle`
    (preemptions, migrations, failover, draining), and `ring` for the
    flight-recorder's instant entries;
  * spans with a duration become complete (`"ph": "X"`) events,
    everything else an instant (`"ph": "i"`); timestamps are the
    tracer's monotonic seconds rebased to 0 and scaled to µs.

Entry points: `write_chrome_trace(path, ...)` here,
`PagedGenerationServer.export_timeline(path)` on the serving stack.
"""
from __future__ import annotations

import json
import os

from . import tracing as _tracing

# event name -> track; anything unlisted lands on "requests"
_TRACKS = {
    "round": "dispatch",
    "decode_dispatch": "dispatch",
    "prefill_chunk": "dispatch",
    "verify_dispatch": "dispatch",
    "dispatch": "dispatch",
    "compile": "compiles",
    "fault_injected": "faults",
    "recovered": "faults",
    "recover_requeue": "faults",
    "quarantined": "faults",
    "quarantine": "faults",
    "request_timeout": "faults",
    "stall": "faults",
    "engine_exception": "faults",
    "shed": "faults",
    "reject": "faults",
    "preempted": "lifecycle",
    "preempt": "lifecycle",
    "resumed": "lifecycle",
    "migrate_out": "lifecycle",
    "fleet_migrate": "lifecycle",
    "fleet_place": "lifecycle",
    "fleet_failover_session": "lifecycle",
    "replica_kill": "lifecycle",
    "journal_readmit": "lifecycle",
    "draining": "lifecycle",
    "slo_degrade": "lifecycle",
}
_TRACK_ORDER = ("dispatch", "requests", "compiles", "faults",
                "lifecycle", "ring")
_SKIP = {"trace_start"}
_DROP_ARGS = {"ts", "dur", "name", "id", "tid", "depth", "parent",
              "seq", "replica"}


def _track_of(name, ring=False):
    if ring:
        return "ring"
    return _TRACKS.get(name, "requests")


def chrome_trace_events(span_events=(), recorders=None,
                        default_name="engine"):
    """Build the trace-event list. `span_events` is a tracer event
    stream (each event routed to the process named by its `replica`
    attribute, else `default_name`); `recorders` maps replica name ->
    flight-recorder event list (always instants on that replica's
    `ring` track). Returns (events, t0) with t0 the monotonic second
    everything was rebased against."""
    recorders = recorders or {}
    all_ts = [ev["ts"] for ev in span_events
              if "ts" in ev and ev.get("name") not in _SKIP]
    for evs in recorders.values():
        all_ts.extend(ev["ts"] for ev in evs
                      if "ts" in ev and ev.get("name") not in _SKIP)
    t0 = min(all_ts) if all_ts else 0.0
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    out = []

    def pid_of(name):
        if name not in pids:
            pids[name] = len(pids) + 1
            out.append({"ph": "M", "name": "process_name",
                        "pid": pids[name], "tid": 0,
                        "args": {"name": name}})
            out.append({"ph": "M", "name": "process_sort_index",
                        "pid": pids[name], "tid": 0,
                        "args": {"sort_index": pids[name]}})
        return pids[name]

    def tid_of(pid, track):
        key = (pid, track)
        if key not in tids:
            tids[key] = _TRACK_ORDER.index(track) + 1 \
                if track in _TRACK_ORDER else len(_TRACK_ORDER) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tids[key], "args": {"name": track}})
        return tids[key]

    def emit(ev, proc, ring=False):
        name = ev.get("name")
        if name is None or name in _SKIP or "ts" not in ev:
            return
        pid = pid_of(proc)
        tid = tid_of(pid, _track_of(name, ring=ring))
        args = {k: v for k, v in ev.items()
                if k not in _DROP_ARGS and v is not None}
        args.pop("name", None)
        rec = {"name": name, "pid": pid, "tid": tid, "cat": "serving",
               "ts": round((ev["ts"] - t0) * 1e6, 3), "args": args}
        dur = ev.get("dur")
        if dur is not None and not ring:
            rec["ph"] = "X"
            rec["dur"] = round(float(dur) * 1e6, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)

    for ev in span_events:
        emit(ev, ev.get("replica") or default_name)
    for rep_name, evs in recorders.items():
        for ev in evs:
            emit(ev, rep_name, ring=True)
    return out, t0


def write_chrome_trace(path, span_events=None, recorders=None,
                       default_name="engine"):
    """Write a Chrome trace-event JSON file; returns the number of
    non-metadata events written. `span_events=None` reads the process
    tracer's in-memory buffer."""
    if span_events is None:
        span_events = _tracing.events()
    events, _t0 = chrome_trace_events(span_events, recorders,
                                      default_name)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in events if e["ph"] != "M")
