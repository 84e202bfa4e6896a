"""The production front door: streaming, SLO lanes,
preemption, and multi-tenant fairness over `PagedGenerationServer`.

`FrontDoor` is the delivery-and-policy facade a fleet talks to. It
wraps one paged serving engine, installs a `LaneScheduler` into it,
and exposes a submit surface with per-request lane / tenant / deadline
/ streaming:

    from paddle_tpu_torch.frontend import FrontDoor, TenantConfig

    fd = FrontDoor(model, max_slots=8, max_new_tokens=64,
                   detokenize=tok.decode,
                   tenants=[TenantConfig("free", weight=1,
                                         rate_tokens_per_s=500,
                                         max_queued=32),
                            TenantConfig("pro", weight=4)])
    fd.start()
    h = fd.submit(ids, lane="interactive", tenant="pro",
                  deadline_ms=250)
    for ev in h:                 # token-by-token streaming
        print(ev.text, end="")
    full = h.result()            # classic submit/drain surface
    fd.stats(); fd.stop()

Semantics in one paragraph: interactive-lane requests are ordered
earliest-deadline-first and may PREEMPT batch-lane residents under
resource pressure (the victim's live K/V is published through the
prefix-cache index, so its resume re-prefills from cache with
near-zero recompute; output is token-identical to an uninterrupted
run either way, because positions, penalties, and the counter-based
PRNG are all residency-invariant). Batch-lane requests share capacity
by per-tenant weighted fair share; token-rate limits DELAY a tenant
(its requests stay queued), bounded queues REJECT (`QueueFull` at
submit). Deadlines are observed, never enforced: a first token landing
past its deadline increments the lane's miss counter and the overage
histogram. The engine's legacy `submit()/result()` path still works on
a fronted server (default lane/tenant), and a server WITHOUT a front
door runs the exact code path it runs without one.
"""
from __future__ import annotations

from ..inference.serving import PagedGenerationServer, RequestMeta
from ..sampling import SamplingParams
from .scheduler import LANES, LaneScheduler
from .stream import StreamHandle
from .tenancy import QueueFull, TenantConfig  # noqa: F401 (re-export)


class FrontDoor:
    """Front-door facade over one `PagedGenerationServer`.

    Either pass a model (plus any `PagedGenerationServer` kwargs — the
    front door then builds the engine, with prefix caching ON by
    default so preemption swap-outs keep their work) or pass an
    existing not-yet-started server via `server=`.

    tenants: iterable of `TenantConfig` (closed roster: unknown
        tenants are rejected) or None (tenants auto-register with
        default config on first use).
    lane_weights: admission service weights, default 4:1
        interactive:batch.
    interactive_chunk_share: the interactive lane's guaranteed maximum
        share of each packed prefill chunk while batch prompts are
        feeding (the SLO-lane split of the packed-prefill chunk budget).
    preemption: allow interactive candidates to evict batch residents.
    preempt_wait_tokens: drain-wait hysteresis — while any resident is
        within this many tokens of its budget, a blocked interactive
        candidate waits for that slot instead of preempting (unless
        its deadline has already passed). 0 = always preempt.
    max_queue: global bounded queue across lanes/tenants (None =
        unbounded); overflow raises `QueueFull` at submit.
    stream_buffer: per-request cap on undelivered stream events before
        deltas coalesce (backpressure without blocking the engine).

    Ops plane: `expose_port=` (and `stall_timeout_s=`,
    `flight_recorder=`) forward to the engine like every other server
    kwarg — a fronted fleet node typically runs
    `FrontDoor(model, expose_port=9100, ...)` and is scraped at
    `/metrics`, watched at `/statusz` (which then carries the lane /
    tenant queue blocks), and health-checked at `/healthz`.
    `ops_url` / `health()` / `statusz()` / `dump_flight_recorder()`
    surface the engine's ops plane on the facade.
    """

    def __init__(self, model=None, *, server=None, tenants=None,
                 lane_weights=None, interactive_chunk_share=0.7,
                 preemption=True, preempt_wait_tokens=8,
                 max_queue=None, stream_buffer=256,
                 **server_kwargs):
        if (model is None) == (server is None):
            raise ValueError("pass exactly one of model= or server=")
        if server is None:
            # prefix caching on by default: it is the swap-out medium
            # that makes preemption cheap (publish instead of discard)
            server_kwargs.setdefault("enable_prefix_cache", True)
            server = PagedGenerationServer(model, **server_kwargs)
        elif server_kwargs:
            raise ValueError(
                f"server= given; engine kwargs "
                f"{sorted(server_kwargs)} must go to its constructor")
        self.server = server
        self.scheduler = LaneScheduler(
            tenants, lane_weights=lane_weights,
            interactive_chunk_share=interactive_chunk_share,
            preemption=preemption,
            preempt_wait_tokens=preempt_wait_tokens,
            max_queue=max_queue)
        server.set_scheduler(self.scheduler)
        self._stream_buffer = int(stream_buffer)

    # ---- lifecycle -------------------------------------------------------
    def warm(self, modes=((False, False),)):
        """Capture the engine's decode graphs before taking traffic
        (`PagedGenerationServer.warm_buckets`): preemption and cache-hit
        resumes make the first dispatch of a mode timing-dependent, so a
        front door that must meet TTFT deadlines from the first request
        warms explicitly, and a capture never lands on a request in
        flight. Call before start(). Returns the graphs captured (none
        on the CPU)."""
        return self.server.warm_buckets(modes=modes)

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop()

    # ---- client API ------------------------------------------------------
    def submit(self, ids, *, lane="interactive", tenant="default",
               deadline_ms=None, sampling=None, max_new_tokens=None,
               stream=True, on_token=None, timeout_s=None,
               stream_timeout_s=None):
        """Submit one request; returns a `StreamHandle` (iterate for
        token/text deltas, or call `.result()` for the classic full
        array — both always work; `stream=False` skips per-token event
        delivery but keeps the handle surface).

        lane: "interactive" (TTFT-sensitive, EDF, may preempt batch)
            or "batch" (throughput, tenant fair share, preemptible).
        tenant: accounting bucket for fairness / rate limits / bounded
            queues. Raises `QueueFull` when a bounded queue is full.
        deadline_ms: relative TTFT deadline; misses are counted (lane
            histograms + `stats()["frontdoor"]`), never enforced.
        sampling / max_new_tokens: forwarded to the engine unchanged.
        on_token: optional extra `(token, reason)` callback invoked
            from the engine thread alongside (after) the stream's own
            delivery — for latency probes and bridges that want raw
            tokens without consuming the stream.
        timeout_s: per-request engine deadline — queued or
            resident past this, the request is cancelled slot-
            freeingly and the stream terminates with
            reason="timeout".
        stream_timeout_s: iterator-side gap timeout — iterating the
            returned handle raises `TimeoutError` after this many
            seconds without an event, so a dead engine can never hang
            the consumer thread.

        When the engine was built with `shed_queue_depth=`, an
        overloaded submit raises `reliability.AdmissionShed` (nothing
        enqueued); its `retry_after_s` is the hint to surface as an
        HTTP Retry-After.
        """
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r} (lanes: {LANES})")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {deadline_ms}")
        srv = self.server
        budget = max_new_tokens
        if budget is None and isinstance(sampling, SamplingParams):
            budget = sampling.max_new_tokens
        if budget is None:
            budget = srv.max_new
        meta = RequestMeta(
            lane=lane, tenant=tenant,
            deadline_s=(None if deadline_ms is None
                        else deadline_ms * 1e-3),
            cost=int(len(ids) + budget))
        stops = (sampling.stop_strings
                 if isinstance(sampling, SamplingParams) else ())
        handle = StreamHandle(
            detokenize=srv._detok, stop_strings=stops,
            tail_tokens=srv.stop_tail_tokens,
            max_buffered=self._stream_buffer,
            timeout_s=stream_timeout_s)
        cb = handle._on_token if stream else None
        if on_token is not None:
            if cb is None:
                cb = on_token
            else:
                def cb(tok, reason, _h=handle._on_token, _u=on_token):
                    _h(tok, reason)
                    _u(tok, reason)
        fut = srv.submit(ids, max_new_tokens=max_new_tokens,
                         sampling=sampling, meta=meta, on_token=cb,
                         timeout_s=timeout_s)
        return handle._bind(fut)

    # ---- introspection ---------------------------------------------------
    def stats(self):
        """The engine's stats() — which, with the scheduler installed,
        already carries per-lane/per-tenant queue depths, preemption /
        resume / deadline-miss counters, per-lane TTFT/ITL
        percentiles, and the scheduler's rejection/throttle window."""
        return self.server.stats()

    def reset_stats(self):
        self.server.reset_stats()

    # ---- ops plane -------------------------------------------------------
    @property
    def ops_url(self):
        """Base URL of the engine's /metrics /statusz /healthz
        endpoint, or None when the server was built without one."""
        exp = self.server.exporter
        return exp.url if exp is not None else None

    def health(self):
        return self.server.health()

    def statusz(self):
        return self.server.statusz()

    def dump_flight_recorder(self):
        return self.server.dump_flight_recorder()

    def slo_report(self):
        """The engine's SLO burn-rate report — pass
        `slos=[SLO(...), ...]` (an engine kwarg) to attach objectives;
        the report is also served at the ops endpoint's /slo."""
        return self.server.slo_report()

    def export_timeline(self, path):
        """Write the engine's Chrome/Perfetto timeline."""
        return self.server.export_timeline(path)

    def capacity(self):
        """The engine's versioned pressure snapshot — pool
        headroom + exhaustion forecast, tier occupancy, lane/tenant
        queue depths, shed pressure and SLO burns; also served at the
        ops endpoint's /capacity."""
        return self.server.capacity_snapshot()

    def cost_report(self):
        """The engine's per-tenant `CostReport` billing export;
        None when the engine runs without attribution."""
        return self.server.cost_report()
