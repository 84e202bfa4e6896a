"""Causal trace propagation across the serving fleet: the port's copy
of `paddle_tpu.observability.trace_context`.

The tracer answers "where did this request's time go" for ONE
engine; a fleet request that is shed, retried, failed over, or
migrated leaves per-replica fragments with no causal story. The fix is
one tiny immutable context minted ONCE where the request enters the
system (`FrontDoor`/`FleetRouter`/`PagedGenerationServer.submit`) and
carried through every placement hop:

    TraceContext(trace_id, hop, cause)

  * trace_id — stable for the request's whole fleet lifetime; every
    event/span/flight-recorder entry/journal record it touches is
    stamped with it;
  * hop — a counter that increments each time the request is RE-ADMITTED
    somewhere (fault retry on the same engine, failover to a survivor,
    planned migration). Preempt/resume inside one residency stays in
    the same hop — that gap is already reported as `requeue_ms`;
  * cause — why this hop exists: `admit` (hop 0) | `retry`
    (recovery-ladder requeue) | `failover` (replica death) |
    `migration` (planned live migration).

The context crosses process/replica boundaries as three plain fields
inside the journal-shape session entry (`SessionJournal.entry_for`), so
replica takeover and migration carry it for free.

`assemble_causal_traces` folds a stamped event stream back into ONE
causal tree per trace: root = the request's fleet lifetime, children =
hops (each on its replica, with its cause), grandchildren = the hop's
contiguous phases (queue_wait / admission / prefill / decode /
detokenize) which tile the hop's wall-clock exactly; the requeue gaps
BETWEEN hops appear as explicit `requeue` spans, so hop spans + gap
spans tile the root exactly too. Every span node carries
`replica` / `hop` / `cause` attributes, and a hop created by failover
or migration is linked to its source via `from_replica`.
"""
from __future__ import annotations

import itertools
import os
import threading

from . import tracing as _tracing

CAUSES = ("admit", "retry", "failover", "migration")

_mint_lock = threading.Lock()
_mint_counter = itertools.count()
# per-process salt: trace ids stay unique across the processes whose
# JSONL sinks might later be merged (subprocess replicas, bench runs)
_SALT = f"{os.getpid():05x}{int.from_bytes(os.urandom(3), 'big'):06x}"


class TraceContext:
    """Immutable (trace_id, hop, cause) triple. `child(cause)` is the
    ONLY way to advance it — hop bumps by one and the cause records why
    the request moved."""

    __slots__ = ("trace_id", "hop", "cause")

    def __init__(self, trace_id, hop=0, cause="admit"):
        if cause not in CAUSES:
            raise ValueError(f"unknown hop cause {cause!r} "
                             f"(causes: {CAUSES})")
        if int(hop) < 0:
            raise ValueError(f"hop must be >= 0, got {hop}")
        object.__setattr__(self, "trace_id", str(trace_id))
        object.__setattr__(self, "hop", int(hop))
        object.__setattr__(self, "cause", cause)

    def __setattr__(self, name, value):  # immutability guard
        raise AttributeError("TraceContext is immutable; use child()")

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, hop={self.hop}, "
                f"cause={self.cause!r})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and (self.trace_id, self.hop, self.cause)
                == (other.trace_id, other.hop, other.cause))

    def __hash__(self):
        return hash((self.trace_id, self.hop, self.cause))

    @classmethod
    def mint(cls):
        """A fresh hop-0 context (cause `admit`)."""
        with _mint_lock:
            n = next(_mint_counter)
        return cls(f"t{_SALT}{n:x}")

    def child(self, cause):
        """The next hop: same trace, hop+1, the given cause."""
        return TraceContext(self.trace_id, self.hop + 1, cause)

    def attrs(self, replica=None):
        """The stamping dict events/spans/ring entries carry."""
        d = {"trace_id": self.trace_id, "hop": self.hop,
             "cause": self.cause}
        if replica is not None:
            d["replica"] = replica
        return d

    def to_dict(self):
        return {"trace_id": self.trace_id, "hop": self.hop,
                "cause": self.cause}

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return None
        return cls(d["trace_id"], d.get("hop", 0),
                   d.get("cause", "admit"))


# ---- causal trace assembly ---------------------------------------------

def _span(name, ts, dur, **attrs):
    node = {"name": name, "ts": ts, "dur": max(0.0, dur)}
    node.update(attrs)
    return node


def _hop_node(hop_no, evs, clip_end=None):
    """One hop's span node: phases tile [hop start, hop end] exactly
    (the tracer's clamping discipline, applied per hop). `evs` is the hop's
    time-sorted stamped events. `clip_end` truncates the hop at the
    NEXT hop's start: a killed replica's in-flight dispatch can finish
    (and emit) after the router already failed the session over — the
    request's causal lifetime transfers at takeover, so the zombie
    tail is reported as `overlap_ms` instead of stretching the hop."""
    def end_of(ev):
        return ev["ts"] + ev.get("dur", 0.0)

    t0 = min(ev["ts"] for ev in evs)
    t1_raw = max(end_of(ev) for ev in evs)
    t1 = t1_raw
    if clip_end is not None:
        t1 = max(t0, min(t1, clip_end))
    replica = next((ev["replica"] for ev in evs if "replica" in ev),
                   None)
    cause = next((ev["cause"] for ev in evs if "cause" in ev), "admit")
    by_name = {}
    for ev in evs:
        by_name.setdefault(ev["name"], ev)  # first occurrence wins
    t_admit = by_name.get("request_admitted", {}).get("ts", t0)
    pre = by_name.get("prefill")
    t_pre0 = pre["ts"] if pre is not None else t_admit
    t_first = end_of(pre) if pre is not None else t_pre0
    done = by_name.get("request_done")
    t_done = done["ts"] if done is not None else t1
    det = by_name.get("detokenize")
    t_end = end_of(det) if det is not None else t_done
    # clamp to monotonic order inside [t0, t1] — a missing event's
    # phase collapses to zero instead of going negative
    t_admit = min(max(t_admit, t0), t1)
    t_pre0 = min(max(t_pre0, t_admit), t1)
    t_first = min(max(t_first, t_pre0), t1)
    t_done = min(max(t_done, t_first), t1)
    t_end = min(max(t_end, t_done), t1)
    tail = t1 - t_end  # events after the terminal record (none in a
    # finished hop; an interrupted hop ends at its last sighting)
    attrs = {"replica": replica, "hop": hop_no, "cause": cause}
    phases = [
        _span("queue_wait", t0, t_admit - t0, **attrs),
        _span("admission", t_admit, t_pre0 - t_admit, **attrs),
        _span("prefill", t_pre0, t_first - t_pre0, **attrs),
        _span("decode", t_first, t_done - t_first + tail, **attrs),
        _span("detokenize", t_done + tail, t_end - t_done, **attrs),
    ]
    node = _span("hop", t0, t1 - t0, **attrs)
    node["children"] = phases
    node["complete"] = done is not None
    node["events"] = [ev["name"] for ev in evs]
    if t1 < t1_raw:
        node["overlap_ms"] = round((t1_raw - t1) * 1e3, 4)
    if "migrate_out" in by_name:
        node["migrated_out"] = True
    return node


def assemble_causal_traces(evs=None, path=None):
    """Fold a stamped event stream into one causal tree per trace_id.

    Returns {trace_id: record} where record["tree"] is the nested span
    tree (root -> hop/requeue spans -> phase leaves; every span node
    carries `replica`/`hop`/`cause`), record["hops"] is the flat hop
    list, and the tiling invariants hold exactly:

        sum(phase durs of a hop)          == the hop's dur
        sum(hop durs) + sum(requeue durs) == record["wall_ms"] / 1e3

    A hop whose cause is `failover` or `migration` carries
    `from_replica` — the replica the request left. Events without a
    `trace_id` stamp (older streams, batch dispatch spans) are
    ignored here; the per-engine `assemble_request_traces` still reads
    them.
    """
    if evs is None:
        if path is None:
            evs = _tracing.events()
        else:
            evs = _tracing.load_events(path)
    traces: dict[str, list] = {}
    for ev in evs:
        tid = ev.get("trace_id")
        if tid is not None and "ts" in ev:
            traces.setdefault(tid, []).append(ev)
    out = {}
    for tid, events in traces.items():
        events.sort(key=lambda e: (e["ts"], e.get("id", 0)))
        hops: dict[int, list] = {}
        rid = None
        for ev in events:
            hops.setdefault(int(ev.get("hop", 0)), []).append(ev)
            if rid is None:
                rid = ev.get("request_id")
        order = sorted(hops)
        starts = [min(ev["ts"] for ev in hops[h]) for h in order]
        nodes = [_hop_node(h, hops[h],
                           clip_end=(starts[k + 1]
                                     if k + 1 < len(order) else None))
                 for k, h in enumerate(order)]
        children = []
        requeue_ms = 0.0
        for prev, nxt in zip(nodes, nodes[1:]):
            if nxt["cause"] in ("failover", "migration"):
                nxt["from_replica"] = prev["replica"]
        for k, node in enumerate(nodes):
            if k > 0:
                prev = nodes[k - 1]
                gap_t0 = prev["ts"] + prev["dur"]
                gap = node["ts"] - gap_t0
                requeue_ms += max(0.0, gap) * 1e3
                children.append(_span(
                    "requeue", gap_t0, gap, hop=node["hop"],
                    cause=node["cause"], replica=node["replica"]))
            children.append(node)
        t0 = nodes[0]["ts"]
        t1 = nodes[-1]["ts"] + nodes[-1]["dur"]
        root = _span("request", t0, t1 - t0, trace_id=tid,
                     request_id=rid, replica=nodes[0]["replica"],
                     hop=0, cause=nodes[0]["cause"])
        root["children"] = children
        out[tid] = {
            "trace_id": tid,
            "request_id": rid,
            "tree": root,
            "hops": nodes,
            "n_hops": len(nodes),
            "replicas": [n["replica"] for n in nodes],
            "causes": [n["cause"] for n in nodes],
            "complete": nodes[-1]["complete"],
            "wall_ms": round((t1 - t0) * 1e3, 4),
            "requeue_ms": round(requeue_ms, 4),
        }
    return out


def check_tiling(record, tol_ms=0.05):
    """Assert-helper: the record's spans tile wall-clock exactly (up to
    float rounding). Returns the worst absolute error in ms."""
    worst = 0.0
    for hop in record["hops"]:
        s = sum(c["dur"] for c in hop["children"])
        worst = max(worst, abs(s - hop["dur"]) * 1e3)
    total = sum(c["dur"] for c in record["tree"]["children"])
    worst = max(worst, abs(total * 1e3 - record["wall_ms"]))
    return worst
