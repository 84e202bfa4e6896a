"""paddle_tpu_torch.observability — runtime telemetry and the serving
operations plane: the port's copy of `paddle_tpu.observability`, its
ported half (pure host Python, stdlib only).

  * `metrics` — process-wide registry of counters/gauges/histograms
    with labels; Prometheus-text and JSON snapshot exporters; one bool
    check per update when disabled.
  * `tracing` — span API emitting a JSONL event log with monotonic
    timestamps (bounded/rotating sink), plus the per-request trace
    assembler (queue-wait / admission / prefill / decode / detokenize
    phases, TTFT, per-token latency).
  * `exporter` — stdlib http.server daemon thread serving /metrics
    (Prometheus text), /statusz (live JSON engine state), /healthz
    (ok | degraded | stalled) and the split /healthz/live and
    /healthz/ready; started by `PagedGenerationServer(expose_port=...)`
    or PADDLE_TPU_METRICS_PORT.
  * `compile_tracker` — CUDA graph captures at the graph caches
    (`serving_xla_compiles_total{program,in_flight,shard}`, the
    reference's metric name; ROADMAP §C 18), always on, with the window
    API that proves a measurement window capture-clean.
  * `flight_recorder` — bounded ring buffer of structured engine
    events + the stall watchdog that auto-dumps it (no-op when
    disabled, like all telemetry).
  * `log` — the library logger (PADDLE_TPU_LOG_LEVEL verbosity).
  * `trace_context` — `TraceContext` (trace_id, hop, cause) stamped on
    every event of a request, `assemble_causal_traces` (one causal tree
    a request: hops, their phases, the requeue gaps) and `check_tiling`.
  * `slo` — declarative `SLO`s with multi-window burn rates
    (`SLOEngine`, `default_slos`); the /slo payload.
  * `capacity` — `PressureSignals`, the versioned pressure snapshot
    with an exhaustion forecast; the /capacity payload.
  * `timeline` — the Chrome/Perfetto trace-event export of the span
    sink and the flight-recorder rings.
  * `attribution` — `ResourceLedger` / `CostReport`: per-tenant device
    time, KV block-seconds, host-tier byte-seconds and capture time in
    integer units with exact conservation.

Not ported yet: `tracing.attach_device_ops`, the bridge to the
reference's XLA profiler, raises (ROADMAP §A 14).

One switch turns metrics+tracing on: PADDLE_TPU_TELEMETRY=1 in the
environment, or `observability.enable()` at runtime.
"""
from __future__ import annotations

from . import compile_tracker, exporter, flight_recorder  # noqa: F401
from . import log, metrics, tracing  # noqa: F401
from . import attribution, capacity, slo, timeline  # noqa: F401
from . import trace_context  # noqa: F401
from .attribution import (CostReport, ResourceLedger,  # noqa: F401
                          apportion, disabled_attribution_stats)
from .capacity import PressureSignals, federate_capacity  # noqa: F401
from .exporter import OpsEndpoint  # noqa: F401
from .flight_recorder import FlightRecorder, StallWatchdog  # noqa: F401
from .log import get_logger  # noqa: F401
from .metrics import (REGISTRY, counter, gauge, histogram,  # noqa: F401
                      snapshot, to_prometheus)
from .slo import SLO, SLOEngine, default_slos  # noqa: F401
from .timeline import write_chrome_trace  # noqa: F401
from .trace_context import (TraceContext,  # noqa: F401
                            assemble_causal_traces, check_tiling)
from .tracing import (TRACER, assemble_request_traces,  # noqa: F401
                      attach_device_ops, span, summarize_traces)


def enable():
    """Turn on metrics collection AND tracing."""
    metrics.enable()
    tracing.enable()


def disable():
    metrics.disable()
    tracing.disable()


def enabled():
    return metrics.enabled() or tracing.enabled()
