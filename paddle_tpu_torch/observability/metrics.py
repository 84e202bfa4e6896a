"""Process-wide metrics registry: the port's copy of
`paddle_tpu.observability.metrics` (the same operations give the same
Prometheus text, byte for byte).

Counters, gauges, and fixed-bucket histograms with labels, answering
"what is the pool fill right now" for any instrumented subsystem from
one place. Reference direction: the production-visibility layer the
paper's framework gets from its Fleet/profiler stack (TensorFlow,
arXiv:1605.08695) and every serving engine's /metrics endpoint.

Design constraints:

  * near-zero cost when disabled — every mutator checks ONE bool before
    doing any work, so instrumented hot loops (the decode step, the
    admission path) pay an attribute load + branch and nothing else;
  * process-wide default registry, but `Registry` is instantiable for
    tests and embedded use;
  * two exporters: `to_prometheus()` (text exposition format, ready for
    a scrape endpoint or a file snapshot) and `snapshot()` (plain JSON
    dict for bench records and assertions).

Enable with PADDLE_TPU_TELEMETRY=1 in the environment or
`metrics.enable()` at runtime; both the registry and the tracer
(tracing.py) honor the same env var.

    from paddle_tpu_torch.observability import metrics
    reqs = metrics.counter("serving_requests_total",
                           "requests completed", labelnames=("server",))
    reqs.labels(server="paged").inc()
    depth = metrics.gauge("serving_queue_depth", "pending requests")
    depth.set(len(queue))
    h = metrics.histogram("ttft_seconds", "time to first token",
                          buckets=(.01, .05, .1, .5, 1, 5))
    h.observe(0.093)
    print(metrics.to_prometheus())
"""
from __future__ import annotations

import json
import math
import os
import threading

ENV_ENABLE = "PADDLE_TPU_TELEMETRY"

# Prometheus' default latency buckets (seconds) — a sane default for the
# step-time/TTFT histograms this registry mostly holds.
DEFAULT_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0)


def _check_labels(labelnames, labels):
    if tuple(sorted(labels)) != tuple(sorted(labelnames)):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"{sorted(labelnames)}")


class _Child:
    """One labeled series of a metric. Mutators no-op when the owning
    registry is disabled."""

    __slots__ = ("_m", "_key", "value", "_sum", "_count", "_bucket_counts")

    def __init__(self, metric, key):
        self._m = metric
        self._key = key
        self.value = 0.0
        if metric.kind == "histogram":
            self._sum = 0.0
            self._count = 0
            self._bucket_counts = [0] * (len(metric.buckets) + 1)

    # -- counter / gauge -------------------------------------------------
    def inc(self, amount=1.0):
        m = self._m
        if not m._reg.enabled:
            return
        if m.kind == "counter" and amount < 0:
            raise ValueError("counters can only increase")
        with m._lock:
            self.value += amount

    def dec(self, amount=1.0):
        m = self._m
        if m.kind != "gauge":
            raise TypeError(f"dec() on a {m.kind}")
        if not m._reg.enabled:
            return
        with m._lock:
            self.value -= amount

    def set(self, value):
        m = self._m
        if m.kind != "gauge":
            raise TypeError(f"set() on a {m.kind}")
        if not m._reg.enabled:
            return
        with m._lock:
            self.value = float(value)

    # -- histogram -------------------------------------------------------
    def observe(self, value):
        m = self._m
        if m.kind != "histogram":
            raise TypeError(f"observe() on a {m.kind}")
        if not m._reg.enabled:
            return
        value = float(value)
        with m._lock:
            self._sum += value
            self._count += 1
            for i, ub in enumerate(m.buckets):
                if value <= ub:
                    self._bucket_counts[i] += 1
                    break
            else:
                self._bucket_counts[-1] += 1  # +Inf bucket

    def percentile(self, p):
        """Histogram-estimated p-quantile (0..1): linear interpolation
        inside the bucket holding the target rank (the +Inf bucket
        answers with the last finite bound). 0.0 when empty."""
        m = self._m
        if m.kind != "histogram":
            raise TypeError(f"percentile() on a {m.kind}")
        with m._lock:
            total = self._count
            if not total:
                return 0.0
            rank = p * total
            seen = 0
            lo = 0.0
            for i, ub in enumerate(m.buckets):
                n = self._bucket_counts[i]
                if seen + n >= rank and n:
                    frac = (rank - seen) / n
                    return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
                seen += n
                lo = ub
            return m.buckets[-1] if m.buckets else 0.0


class Metric:
    """One named metric family; `labels(**kv)` returns the per-series
    child (the unlabeled family IS the child keyed by ())."""

    def __init__(self, registry, name, help_, kind, labelnames=(),
                 buckets=None):
        self._reg = registry
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if kind == "histogram":
            bs = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
            if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram buckets must be strictly "
                                 f"increasing, got {bs}")
            self.buckets = bs
        if not self.labelnames:  # pre-bind the unlabeled series
            self._default = self._child(())
        else:
            self._default = None

    def _child(self, key):
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._children[key] = _Child(self, key)
            return c

    def labels(self, **labels):
        _check_labels(self.labelnames, labels)
        return self._child(tuple(labels[k] for k in self.labelnames))

    def _only(self):
        if self._default is None:
            raise ValueError(f"metric {self.name} has labels "
                             f"{self.labelnames}; use .labels(...)")
        return self._default

    # unlabeled convenience surface
    def inc(self, amount=1.0):
        self._only().inc(amount)

    def dec(self, amount=1.0):
        self._only().dec(amount)

    def set(self, value):
        self._only().set(value)

    def observe(self, value):
        self._only().observe(value)

    def percentile(self, p):
        return self._only().percentile(p)

    @property
    def value(self):
        return self._only().value


class Registry:
    """Name -> Metric map with get-or-create semantics: registering the
    same name twice returns the SAME metric (kind/labelnames must
    match), so any module can declare its metrics at import time without
    coordination."""

    def __init__(self, enabled=None):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}
        self._gauge_fns: dict[str, object] = {}
        if enabled is None:
            enabled = os.environ.get(ENV_ENABLE, "0") not in ("", "0",
                                                              "false")
        self.enabled = bool(enabled)

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # -- declaration -----------------------------------------------------
    def _register(self, name, help_, kind, labelnames, buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                        f"{m.labelnames}, not {kind}{tuple(labelnames)}")
                return m
            m = Metric(self, name, help_, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labelnames=()):
        return self._register(name, help_, "counter", labelnames)

    def gauge(self, name, help_="", labelnames=()):
        return self._register(name, help_, "gauge", labelnames)

    def histogram(self, name, help_="", labelnames=(), buckets=None):
        return self._register(name, help_, "histogram", labelnames,
                              buckets)

    def gauge_fn(self, name, help_, fn):
        """A gauge whose value is pulled from `fn()` at export time —
        for state someone else owns (heartbeat age, pool fill) where a
        push on every change would be invasive."""
        g = self.gauge(name, help_)
        with self._lock:
            self._gauge_fns[name] = fn
        return g

    # -- export ----------------------------------------------------------
    def _pull_gauges(self):
        for name, fn in list(self._gauge_fns.items()):
            try:
                v = float(fn())
            except Exception:  # noqa: BLE001 — a dead provider must not
                continue  # poison the whole export
            m = self._metrics[name]
            c = m._default if m._default is not None else None
            if c is not None:
                with m._lock:
                    c.value = v

    def snapshot(self):
        """JSON-ready dict of every series' current value."""
        self._pull_gauges()
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            with m._lock:
                children = list(m._children.items())
            for key, c in children:
                lbl = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    series.append({
                        "labels": lbl, "sum": c._sum, "count": c._count,
                        "buckets": {
                            **{str(ub): n for ub, n in
                               zip(m.buckets, c._bucket_counts)},
                            "+Inf": c._bucket_counts[-1]},
                    })
                else:
                    series.append({"labels": lbl, "value": c.value})
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def to_json(self, **dump_kw):
        return json.dumps(self.snapshot(), **dump_kw)

    def to_prometheus(self):
        """Prometheus text exposition format (histograms as cumulative
        _bucket/_sum/_count, the standard scrape shape)."""
        self._pull_gauges()
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            with m._lock:
                children = list(m._children.items())
            for key, c in children:
                base = _fmt_labels(m.labelnames, key)
                if m.kind == "histogram":
                    cum = 0
                    for ub, n in zip(m.buckets, c._bucket_counts):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, le=_le(ub))}"
                            f" {cum}")
                    cum += c._bucket_counts[-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(m.labelnames, key, le='+Inf')}"
                        f" {cum}")
                    lines.append(f"{name}_sum{base} {_num(c._sum)}")
                    lines.append(f"{name}_count{base} {c._count}")
                else:
                    lines.append(f"{name}{base} {_num(c.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Zero every series (definitions and gauge providers stay
        registered) — bench measurement windows."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                for c in m._children.values():
                    c.value = 0.0
                    if m.kind == "histogram":
                        c._sum = 0.0
                        c._count = 0
                        c._bucket_counts = [0] * (len(m.buckets) + 1)

    def clear(self):
        """Drop every metric definition (tests)."""
        with self._lock:
            self._metrics.clear()
            self._gauge_fns.clear()


def _le(ub):
    return _num(ub)


def _num(v):
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f != f:
        return "NaN"
    if f == math.floor(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(names, values, **extra):
    pairs = [*zip(names, values), *extra.items()]
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(s):
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


# ---- process-wide default registry ------------------------------------
REGISTRY = Registry()


def counter(name, help_="", labelnames=()):
    return REGISTRY.counter(name, help_, labelnames)


def gauge(name, help_="", labelnames=()):
    return REGISTRY.gauge(name, help_, labelnames)


def histogram(name, help_="", labelnames=(), buckets=None):
    return REGISTRY.histogram(name, help_, labelnames, buckets)


def gauge_fn(name, help_, fn):
    return REGISTRY.gauge_fn(name, help_, fn)


def enable():
    REGISTRY.enable()


def disable():
    REGISTRY.disable()


def enabled():
    return REGISTRY.enabled


def snapshot():
    return REGISTRY.snapshot()


def to_prometheus():
    return REGISTRY.to_prometheus()


def to_json(**kw):
    return REGISTRY.to_json(**kw)


def reset():
    REGISTRY.reset()
