"""Per-request tracing: the port's copy of
`paddle_tpu.observability.tracing`.

Lightweight span API answering "where did this request's 934ms go":

    from paddle_tpu_torch.observability import tracing
    with tracing.span("prefill", request_id=rid):
        ...

Every span/event is one dict with MONOTONIC timestamps
(time.perf_counter — durations and orderings are exact; `wall` carries
one time.time() anchor per process so JSONL files from different runs
can still be aligned roughly). Events buffer in memory and, when a sink
is configured, append to a JSONL file line-by-line — the trace survives
a crash up to the last completed span.

The serving engine emits a small vocabulary per request
(inference/serving.py):

    request_submitted    point event, request_id
    request_admitted     point event, request_id (slot picked)
    prefill_chunk        span, request_ids=[...] (ONE packed ragged
                         prefill dispatch serving several requests'
                         prompt chunks)
    prefill              per-request event with explicit ts/dur: first
                         chunk dispatch start -> final chunk done (its
                         end IS the request's first-token time); carries
                         `chunks`, the dispatches the prompt spanned
    decode_dispatch      span, request_ids=[...] (one batched step for
                         every active slot; k tokens when multi-step)
    request_done         point event, request_id, new_tokens, ttft_s,
                         cost (the request's closed attribution
                         account; None while attribution is not
                         ported)
    detokenize           span, request_id (assemble + resolve future)

`assemble_request_traces` folds that stream back into one record per
request with contiguous phases (queue_wait / admission / prefill /
decode / detokenize) that tile the request's wall-clock exactly, plus
TTFT and per-token decode latency — the standard latency lens of paged
serving engines (Ragged Paged Attention, arXiv:2604.15464).

`attach_device_ops` (the reference's bridge to its XLA profiler) is
not ported: it raises, naming ROADMAP §A 14.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

ENV_ENABLE = "PADDLE_TPU_TELEMETRY"
ENV_TRACE_PATH = "PADDLE_TPU_TRACE_PATH"
ENV_TRACE_MAX_BYTES = "PADDLE_TPU_TRACE_MAX_BYTES"

# Bounded sink: a long-lived serving run must not
# grow the trace file without bound. When the sink crosses the cap it
# rotates ONCE (path -> path + ".1", replacing any previous rotation)
# and restarts the live file, so disk usage is bounded at ~2x the cap
# while the most recent cap's worth of events is always on disk.
DEFAULT_TRACE_MAX_BYTES = 64 << 20  # 64 MiB


class Tracer:
    """Event collector: in-memory buffer + optional JSONL sink. All
    methods are thread-safe; span nesting is tracked per thread."""

    def __init__(self, enabled=None, path=None):
        if enabled is None:
            enabled = os.environ.get(ENV_ENABLE, "0") not in ("", "0",
                                                              "false")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._file = None
        self._path = None
        self._bytes = 0
        self._rotations = 0
        self.max_bytes = int(os.environ.get(ENV_TRACE_MAX_BYTES,
                                            DEFAULT_TRACE_MAX_BYTES))
        self._next_id = 0
        self._local = threading.local()
        # one wall-clock anchor: wall ~= _wall0 + (ts - _ts0)
        self._ts0 = time.perf_counter()
        self._wall0 = time.time()
        if path or os.environ.get(ENV_TRACE_PATH):
            self.configure(path=path or os.environ[ENV_TRACE_PATH])

    # -- config ----------------------------------------------------------
    def configure(self, path=None, enabled=None, truncate=False,
                  max_bytes=None):
        """Set the JSONL sink (None detaches) and/or toggle tracing.
        max_bytes caps the sink file (default 64 MiB, env
        PADDLE_TPU_TRACE_MAX_BYTES): crossing it rotates the file once
        to `path + ".1"` and restarts the live file."""
        with self._lock:
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            if self._file is not None and path != self._path:
                self._file.close()
                self._file = None
                self._path = None
            if path and self._file is None:
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
                self._file = open(path, "w" if truncate else "a",
                                  buffering=1)
                self._path = path
                self._bytes = self._file.tell()
                self._write_line(json.dumps(
                    {"name": "trace_start", "ts": self._ts0,
                     "wall": self._wall0}))
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    def _write_line(self, line):
        """Caller holds the lock. Rotates BEFORE the write when the
        sink would cross max_bytes, so the live file never exceeds the
        cap and the previous cap's worth of events survives at
        path + '.1'."""
        n = len(line) + 1
        if self._bytes and self._bytes + n > self.max_bytes:
            self._rotate_locked()
        self._file.write(line + "\n")
        self._bytes += n

    def _rotate_locked(self):
        self._file.close()
        try:
            os.replace(self._path, self._path + ".1")
        except OSError:  # cross-device/unwritable: truncate in place
            pass
        self._file = open(self._path, "w", buffering=1)
        self._bytes = 0
        self._rotations += 1
        header = json.dumps({"name": "trace_start", "ts": self._ts0,
                             "wall": self._wall0,
                             "rotation": self._rotations})
        self._file.write(header + "\n")
        self._bytes += len(header) + 1

    @property
    def path(self):
        return self._path

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # -- emission --------------------------------------------------------
    def _emit(self, ev):
        with self._lock:
            ev["id"] = self._next_id
            self._next_id += 1
            self._events.append(ev)
            if self._file is not None:
                self._write_line(json.dumps(ev))

    def event(self, name, **attrs):
        """Point event (duration 0)."""
        if not self.enabled:
            return
        ev = {"name": name, "ts": time.perf_counter(),
              "tid": threading.get_ident()}
        ev.update(attrs)
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name, **attrs):
        """Timed span; emitted on exit with its duration. Nested spans
        record their parent span's id (per-thread stack)."""
        if not self.enabled:
            yield None
            return
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        ev = {"name": name, "ts": time.perf_counter(),
              "tid": threading.get_ident()}
        ev.update(attrs)
        if stack:
            ev["parent"] = stack[-1]["name"]
        ev["depth"] = len(stack)
        stack.append(ev)
        try:
            yield ev
        finally:
            stack.pop()
            ev["dur"] = time.perf_counter() - ev["ts"]
            self._emit(ev)

    def wrap(self, name, fn, **attrs):
        """Decorator form: time every call of `fn` as a span — used for
        dispatch boundaries."""
        def wrapped(*a, **kw):
            if not self.enabled:
                return fn(*a, **kw)
            with self.span(name, **attrs):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", name)
        wrapped.__wrapped__ = fn
        return wrapped

    # -- access ----------------------------------------------------------
    def events(self):
        with self._lock:
            return list(self._events)

    def reset(self):
        """Drop buffered events (the JSONL sink, if any, keeps its
        already-written lines)."""
        with self._lock:
            self._events.clear()

    def flush(self):
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
                self._path = None


# ---- process-wide default tracer ---------------------------------------
TRACER = Tracer()


def configure(path=None, enabled=None, truncate=False, max_bytes=None):
    return TRACER.configure(path, enabled, truncate, max_bytes)


def span(name, **attrs):
    return TRACER.span(name, **attrs)


def event(name, **attrs):
    TRACER.event(name, **attrs)


def wrap(name, fn, **attrs):
    return TRACER.wrap(name, fn, **attrs)


def enable():
    TRACER.enable()


def disable():
    TRACER.disable()


def enabled():
    return TRACER.enabled


def events():
    return TRACER.events()


def reset():
    TRACER.reset()


def flush():
    TRACER.flush()


def load_events(path):
    """Read a trace JSONL file back into a list of event dicts (skips
    lines that fail to parse — a crashed writer can leave one)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


# ---- per-request trace assembly ----------------------------------------

def assemble_request_traces(evs=None, path=None):
    """Fold a serving event stream into one record per request_id.

    Returns {request_id: record} where record["phases_ms"] holds the
    contiguous queue_wait / admission / prefill / decode / detokenize
    breakdown (phases tile [submit, end] exactly, so their sum equals
    wall_ms up to float rounding), record["ttft_ms"] is submit -> first
    token (prefill end), and record["per_token_ms"] is the decode phase
    over the tokens it produced. Batched `decode_dispatch` spans are
    also counted per request (record["decode_dispatches"]) — their
    batch-shared durations explain the decode phase but are not used to
    build it, so overlapping requests don't double-book wall time.
    """
    if evs is None:
        if path is None:
            evs = TRACER.events()
        else:
            evs = load_events(path)
    reqs: dict[object, dict] = {}
    compiles = []  # (ts, dur, program): compile-tracker events, used
    # below to attribute TTFT/ITL outliers to in-window graph captures

    def rec(rid):
        return reqs.setdefault(rid, {"request_id": rid,
                                     "decode_dispatches": 0,
                                     "decode_dispatch_ms": 0.0})

    for ev in evs:
        name = ev.get("name")
        rid = ev.get("request_id")
        if name == "request_submitted" and rid is not None:
            rec(rid)["t_submit"] = ev["ts"]
        elif name == "request_admitted" and rid is not None:
            # a preempted request is re-admitted: keep the FIRST
            # admission (phases keep first-residency semantics; the
            # preempted gap is reported separately as requeue_ms)
            r = rec(rid)
            r.setdefault("t_admit", ev["ts"])
            if "_t_preempt" in r:
                r["requeue_ms"] = r.get("requeue_ms", 0.0) + \
                    (ev["ts"] - r.pop("_t_preempt")) * 1e3
        elif name == "preempted" and rid is not None:
            r = rec(rid)
            r["preemptions"] = r.get("preemptions", 0) + 1
            r["_t_preempt"] = ev["ts"]
        elif name == "prefill" and rid is not None:
            r = rec(rid)
            # keep the FIRST prefill: its end IS the request's first
            # token; a resume re-prefill lands inside the decode phase
            r.setdefault("t_prefill_start", ev["ts"])
            r.setdefault("t_first_token", ev["ts"] + ev.get("dur", 0.0))
            if ev.get("chunks") is not None:
                r["prefill_chunks"] = (r.get("prefill_chunks", 0)
                                       + ev["chunks"])
        elif name == "decode_dispatch":
            for rid2 in ev.get("request_ids", ()):
                r = rec(rid2)
                r["decode_dispatches"] += 1
                r["decode_dispatch_ms"] += ev.get("dur", 0.0) * 1e3
        elif name == "request_done" and rid is not None:
            r = rec(rid)
            r["t_done"] = ev["ts"]
            r["new_tokens"] = ev.get("new_tokens")
            if ev.get("ttft_s") is not None:
                r["ttft_ms"] = ev["ttft_s"] * 1e3
            if ev.get("cost") is not None:
                # per-request cost attribution: the closed
                # ledger account the engine attached at completion
                r["cost"] = ev["cost"]
        elif name == "detokenize" and rid is not None:
            rec(rid)["t_end"] = ev["ts"] + ev.get("dur", 0.0)
        elif name == "tier_promote" and rid is not None:
            # aggregated host-tier promote batch attributed to this
            # request's admission attach (overlapped prefetch batches
            # carry no request_id — they ran before admission)
            r = rec(rid)
            r["tier_promote_ms"] = (r.get("tier_promote_ms", 0.0)
                                    + ev.get("dur_s", 0.0) * 1e3)
            r["tier_promote_blocks"] = (r.get("tier_promote_blocks", 0)
                                        + ev.get("blocks", 0))
        elif name == "compile":
            compiles.append((ev["ts"], ev.get("dur", 0.0),
                             ev.get("program")))

    out = {}
    for rid, r in reqs.items():
        t_submit = r.get("t_submit")
        if t_submit is None:
            continue  # partial trace (request predates the window)
        t_admit = r.get("t_admit", t_submit)
        t_pre0 = r.get("t_prefill_start", t_admit)
        t_first = r.get("t_first_token", t_pre0)
        t_done = r.get("t_done", t_first)
        t_end = r.get("t_end", t_done)
        phases = {
            "queue_wait": (t_admit - t_submit) * 1e3,
            "admission": (t_pre0 - t_admit) * 1e3,
            "prefill": (t_first - t_pre0) * 1e3,
            "decode": (t_done - t_first) * 1e3,
            "detokenize": (t_end - t_done) * 1e3,
        }
        wall_ms = (t_end - t_submit) * 1e3
        new = r.get("new_tokens") or 0
        decode_toks = max(new - 1, 0)  # token 0 comes from prefill
        out[rid] = {
            "request_id": rid,
            "phases_ms": {k: round(v, 4) for k, v in phases.items()},
            "wall_ms": round(wall_ms, 4),
            "ttft_ms": round(r.get("ttft_ms",
                                   (t_first - t_submit) * 1e3), 4),
            "new_tokens": new,
            "per_token_ms": round(phases["decode"] / decode_toks, 4)
            if decode_toks else None,
            "decode_dispatches": r["decode_dispatches"],
            "decode_dispatch_ms": round(r["decode_dispatch_ms"], 4),
        }
        if "prefill_chunks" in r:  # chunked prefill (paged server)
            out[rid]["prefill_chunks"] = r["prefill_chunks"]
        if r.get("cost") is not None:  # per-request attribution
            # account closed at completion
            out[rid]["cost"] = r["cost"]
        if r.get("tier_promote_ms"):  # host-tier promote wall time of
            # this request's admission attach — its own trace event
            # now (not silently absorbed into the admission span); a
            # parallel "of which, tier promote" annotation inside the
            # admission phase, the compile_overlap_ms discipline —
            # the phase tiling of wall clock is untouched
            out[rid]["tier_promote_ms"] = round(r["tier_promote_ms"], 4)
            out[rid]["tier_promote_blocks"] = r["tier_promote_blocks"]
        if r.get("preemptions"):  # front door: the decode
            # phase of a preempted request absorbs its swap-out,
            # requeue wait, and resume re-prefill; requeue_ms says how
            # much of it was spent evicted
            out[rid]["preemptions"] = r["preemptions"]
            out[rid]["requeue_ms"] = round(r.get("requeue_ms", 0.0), 4)
        # capture attribution: compile-tracker events (CUDA graph
        # captures in the port)
        # overlapping this request's residency explain TTFT/ITL
        # outliers that would otherwise read as queue/prefill/decode
        # time — the phases still tile wall clock; this is a parallel
        # "of which, compile" annotation
        overlap = 0.0
        n_comp = 0
        for cts, cdur, _prog in compiles:
            o = min(cts + cdur, t_end) - max(cts, t_submit)
            if o > 0:
                overlap += o
                n_comp += 1
        if n_comp:
            out[rid]["compiles_in_window"] = n_comp
            out[rid]["compile_overlap_ms"] = round(overlap * 1e3, 4)
    return out


def summarize_traces(traces):
    """Aggregate assembled request traces: count, TTFT/wall percentiles,
    mean phase breakdown — the report block bench --telemetry prints."""
    recs = list(traces.values()) if isinstance(traces, dict) else \
        list(traces)
    if not recs:
        return {"requests": 0}
    ttfts = sorted(r["ttft_ms"] for r in recs)
    walls = sorted(r["wall_ms"] for r in recs)
    n = len(recs)

    def pct(xs, p):
        return xs[min(n - 1, int(p * n))]

    phases = {}
    for r in recs:
        for k, v in r["phases_ms"].items():
            phases[k] = phases.get(k, 0.0) + v
    return {
        "requests": n,
        "ttft_p50_ms": round(pct(ttfts, .50), 3),
        "ttft_p99_ms": round(pct(ttfts, .99), 3),
        "wall_p50_ms": round(pct(walls, .50), 3),
        "wall_p99_ms": round(pct(walls, .99), 3),
        "mean_phase_ms": {k: round(v / n, 3) for k, v in phases.items()},
    }


def attach_device_ops(report, fn, steps=3, k=25):
    """Not ported: the reference bridges its `utils/profiler.top_ops`
    (an XLA profile of a jitted `fn`) into a trace report. The port's
    profiler bridge waits for `utils/profiler` (ROADMAP §A 14); until
    then device time is read with `torch.profiler` directly (as
    scripts/torch_serve_profile.py does)."""
    raise NotImplementedError(
        "tracing.attach_device_ops is not ported (ROADMAP §A 14, "
        "utils/profiler); read device time with torch.profiler")
