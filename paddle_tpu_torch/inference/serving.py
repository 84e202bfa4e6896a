"""PagedGenerationServer — continuous batching over the paged KV cache —
and GenerationServer, the dynamic batcher over one fixed-shape decode
program (the dense path; at the end of this docstring).

The core of `paddle_tpu.inference.serving.PagedGenerationServer`, on
PyTorch: the split scheduler round with its default settings.

  * Requests queue FIFO; a request is ADMITTED into an idle slot only
    when the pool can cover its worst case (ceil((len + budget + overrun)
    / block_size) blocks) on top of every resident slot's outstanding
    worst case, so mid-flight block exhaustion cannot happen. Blocks are
    still allocated lazily as sequences grow — the reservation is
    accounting, not allocation.
  * Each loop round runs at most ONE packed chunked prefill dispatch:
    up to `prefill_chunk_tokens` prompt tokens across all slots still
    feeding their prompts, concatenated into one token-packed stream
    (each chunk's region aligned to `pack_align`, pads routed to the
    trash block). A prompt longer than the budget is split across
    rounds; its partial K/V lives in the paged cache. A slot whose final
    chunk is in the dispatch samples its first token there (its TTFT).
  * Then ONE decode dispatch for every slot past its prompt:
    `steps_per_dispatch` tokens per slot (k > 1 runs `multistep(k)`;
    tokens after a stop or the budget are discarded).
  * Finished slots (EOS, a stop token, a stop string, or the budget)
    resolve their futures, free their blocks and refill from the queue
    next round.

Per-request sampling: each request carries `SamplingParams`, scattered
into its slot row of a `SlotParamStore`; every dispatch samples all its
rows at once under the store's mode (greedy dispatches are a bare
argmax). Each request's PRNG stream is `fold_in(PRNGKey(seed), step)`
with step = tokens generated so far, so a fixed seed gives the same
tokens whatever the batch, the slot or `steps_per_dispatch`. Stop
strings are matched on the host against the detokenized tail of the
output (`detokenize=`).

Prefix caching (`enable_prefix_cache=True`): on admission the prompt
is matched against the pool's content index (`PagedKVCache.
attach_prefix`); the longest cached block chain is attached by table
copy, those tokens count as fed, and the packed prefill starts at the
first uncached token (a fully cached prompt prefills exactly its last
token, which samples token 0). Every chunk's first write goes through
`prepare_write` (copy-on-write of a shared or index-claimed block);
each prompt is published when its last chunk lands; freed indexed
blocks park in the pool's LRU retention. Admission reserves one spare
block per request for the one copy-on-write a mid-block attach can
force. `kv_tier=` (a `kv_tier.HostKVTier`, or True) puts a host-RAM
tier below the pool: cold retained blocks demote to host memory
instead of being dropped and promote back on a later match. With
caching off (the default) the server takes the plain allocation path:
no lookups, no index, no retention, no spare block. The attribute is
read at each admission and publish, so it may be flipped on a live
server. `kv_dtype="int8"` serves from an int8 pool (codes + per-vector
scales; the int8 K1/K2 on the card). `quantization="w8a16"` (alias
`weight_quant="int8"`) packs the weights once, at construction
(`GPT2.quantize_weights`), and every dispatch runs the decoder's W8A16
products.

On the card every decode dispatch is ONE CUDA graph replay
(`PagedDecoder.graphs`, `nn/decode_graph.py`): `multistep(k, mode)` is
captured once per key (k, the mode, the stop matrix's width, the pool
and the params) and replayed, at k = 1 too, as the reference jits its
step and its k-step scan. A capture or replay that fails fails the
dispatch like any other; it never runs the eager loop instead. On the
CPU the eager functions run. The packed prefill stays eager: its stream
length varies with every dispatch.

Speculative decoding (`speculation=SpecConfig(...)`, or True for the
defaults): each round every decode-phase slot asks the drafter (default:
the n-gram / prompt-lookup `NgramDrafter`, no second model) for up to K
draft tokens; when any slot proposes, ONE verify dispatch
(`PagedDecoder.packed_verify`, K1 on the card over the plan's pinned
W-token windows, one graph replay) scores every decode-phase slot,
draft-free ones as one-position rows, instead of the plain decode
dispatch. The PRNG is counter-based, so the target's token at every
position is deterministic: acceptance is exact match, and fixed-seed
output (greedy, sampled, penalties) is token-identical to
non-speculative decode. A row emits its accepted drafts plus the bonus
token (1..K+1 tokens a dispatch, cut at a stop); rejected positions
roll back (`PagedKVCache.truncate_seq`) before the tokens are emitted.
Admission reserves the max(k - 1, K) overrun.

The unified round (`unified_round=True`): the round's prefill chunk
rows, decode rows and verify regions go into ONE packed stream and ONE
`PagedDecoder.unified_round` dispatch, token-identical to the split
round. A chunk-free round (steady decode) takes the window layout (P
rows of W = K + 1 tokens; one graph replay on the card); a round with
chunk rows runs eagerly (its stream length varies). `async_rounds=True`
(implies unified) double-buffers the loop: round N+1 is planned and
dispatched while round N runs, its decode rows fed from round N's
samples through a slot-indexed device carry, and round N is processed
after: the host learns of stops one round late and discards that
overshoot, so the output is the split round's. Round N's outputs go to
page-locked host buffers by non-blocking copies right after its
dispatch (a `.cpu()` after round N+1 is queued would wait for N+1 too),
and every upload to the card is non-blocking from page-locked memory.
Async rounds reserve 1 + K more positions (the round of overshoot).
Both require steps_per_dispatch=1. `stats()["rounds"]` counts rounds and
attention dispatches on both paths.

The packed stream is not bucketed to a power of two as the reference's
is: PyTorch compiles nothing per shape, so a bucket would only add pad
rows to every dispatch. Block tables are built fresh for every
dispatch, so a copy-on-write swap of a block id is never served stale.
Verify regions are not aligned (`_verify_align` 1, the reference's
value off the TPU): K1 takes any packing.

Reliability (the reference's recovery ladder, `paddle_tpu.reliability`
ported as `paddle_tpu_torch.reliability`):

  * A dispatch that raises does not fail its requests. Each implicated
    request is snapshotted to its DURABLE length (the positions
    completed dispatches wrote: the sequence is truncated there, and
    with prefix caching on published through `swap_out_seq`), requeued
    at the front with its resume state (`gen0`, the tokens emitted so
    far; `resume_ids` = ids ++ gen0), and the loop backs off
    (`RecoveryPolicy`: capped exponential). A request implicated in
    `quarantine_after` consecutive failures is QUARANTINED: its future
    fails with `QuarantinedRequest` naming the seam, one request a
    failure at most. `recovery=False` keeps the old blast radius (the
    dispatch's requests fail with the error).
  * Before the retry the dispatch state is rebuilt: the async round in
    flight is processed FIRST (its tokens are real and enter the
    snapshots), then the device carry is dropped (reseeded from the
    host) and the pending round cleared. Page-locked output buffers are
    made per dispatch (`_to_host`), so none outlives a failure. The
    retry replays the same captured graphs: a recovered fault adds no
    capture and never runs the eager loop.
  * A resumed request re-installs from its resume state: positions, the
    PRNG step (len(gen0)), the penalty counts (seeded from resume_ids)
    and the budget are residency-invariant. A cold resume re-prefills
    ids ++ gen0 (K1 writes those positions in one packed prefill where
    the uninterrupted run wrote them step by step, so on the card a
    resumed request equals the fault-free run up to float32 rounding of
    the K/V); a WARM resume (the prefix cache holds all but the last
    position) rejoins the next decode dispatch with no prefill, on the
    very blocks it swapped out.
  * The injected seams (`fault_plan=` or PADDLE_TPU_FAULT_PLAN;
    `FaultPlan`) fire BEFORE a dispatch's launches, at the reference's
    points: `slow_dispatch` and `ensure_many` before the table growth,
    then `prefill` / `decode` / `verify` / `unified_round` before the
    dispatch; `detokenize` and `stream_consumer` inside `_slot_token`.
    With no plan each is one `is None` check.
  * A sticky CUDA error (an illegal address, a corrupted context) cannot
    be recovered in-process: every later dispatch raises again, so the
    ladder quarantines request after request and health stays
    "degraded". Nothing here hides that: the process has to restart, and
    the journal is what carries its requests over.
  * `journal=` (a path or a `SessionJournal`; the reference's record
    format) records every accepted request and every token the HOST
    emitted (never one an async overshoot or a rollback discards);
    `kill()` stops the engine without resolving futures, and
    `recover_from_journal()` on a fresh server re-admits the
    interrupted requests from their recorded prompt, seed, sampling and
    emitted tokens.
  * `submit(timeout_s=)` cancels an overdue request, queued or resident
    (its slot and blocks are freed: `RequestTimeout`);
    `shed_queue_depth=` refuses a submit past that queue depth with
    `AdmissionShed` and its retry hint.

Observability (`paddle_tpu_torch.observability`): the reference's
`serving_*` metrics under their names (one bool check each while
PADDLE_TPU_TELEMETRY is off), its tracing events (`request_submitted`,
`request_admitted`, `prefill`, `prefill_chunk` / `decode_dispatch` /
`verify_dispatch` / `round` spans, `resumed`, `recover_requeue`,
`quarantined`, `request_timeout`, `journal_readmit`, `fault_injected`,
`recovered`, `request_done`, `detokenize`), `stats()["goodput"]`
(decoded = emitted + rolled back + replayed), `stats()["reliability"]`
and `stats()["compiles"]` (CUDA graph captures in the window, ROADMAP
§C 18). `expose_port=` (or PADDLE_TPU_METRICS_PORT; 0 = ephemeral)
starts the ops endpoint (/metrics, /statusz, /healthz, /healthz/live,
/healthz/ready), enables the flight recorder and the stall watchdog
(`stall_timeout_s`); `health()` / `liveness()` / `readiness()` /
`set_draining()` / `statusz()` / `dump_flight_recorder()` answer
in-process. `warm_buckets(modes)` captures, before `start()`, every
decode graph and (unified) window graph the loop can reach for those
modes, with all-padding rows whose writes land in the trash block: the
port's prefill is eager and unbucketed (§C 8), so there is nothing else
to warm; its captures are labelled not in flight.

The front door (`paddle_tpu_torch.frontend`): `set_scheduler(sched)`
(before `start()`) hands the queues and the admission policy to a
scheduler (`frontend.LaneScheduler`: SLO lanes, EDF, tenant fair share,
token buckets, bounded queues). `submit(meta=RequestMeta(...))` routes
through its `on_submit`; admission asks it for candidates, and a
candidate short of a slot or of blocks may PREEMPT residents the policy
names (`_preempt_slot_locked`: the async round in flight is processed
first, the victim's live K/V is published through `swap_out_seq` with
caching on, else freed, and the request requeues with its resume state;
it resumes through the resumed or warm install, token-identical to an
uninterrupted run). The packed prefill and the unified round's chunk
half take the scheduler's order and per-slot chunk caps
(`prefill_plan`); a cap shortens a row's chunk, each row stays one
segment. Recovery requeues, timeouts (`expire`), journal re-admission
and `stop()` (`drain`) go through it too. `tier_prefetch=` promotes
queued requests' tiered prefix blocks while a round runs (the
scheduler's `peek` orders them under a front door). Without a
scheduler the engine runs exactly the FIFO path above.
`stats()["frontdoor"]` carries preemptions, resumes, lane TTFT/ITL
percentiles and deadline misses (zeros without a scheduler).

Engine-side observability: every request carries a `TraceContext`
(`submit(trace_ctx=)`, else minted) stamped onto its events, spans,
flight-recorder entries and journal records (a recovery requeue and a
journal re-admission are new hops, cause "retry");
`observability.assemble_causal_traces` folds them into one tree a
request. `slos=` attaches an `SLOEngine` fed at the TTFT, ITL,
availability and goodput sites (`slo_report()`, /slo,
`stats()["slo"]`); `capacity_snapshot()` (/capacity) samples the
pool's headroom, the tier, the queues, shedding and the SLOs;
`export_timeline(path)` writes the Chrome/Perfetto timeline;
`attribution=` keeps a `ResourceLedger` that splits every dispatch's
measured wall time over its requests' tenants in integer nanoseconds
(device-ns over tenants equals busy-ns exactly), charges pool blocks to
their single owner and credits prefix-cache hits (`cost_report()`,
`stats()["attribution"]`).

Sharded serving (`sharding=ShardedEngineConfig(tp, dp, sp)`, or True
for the defaults; `paddle_tpu_torch.serving_dist`): every rank of a
torch.distributed world constructs the server with the same arguments;
the weights and the pool split over the mesh (tp: heads and Megatron
column/row splits; dp: the pool's block ranges, slots pinned to them;
sp: the packed prefill stream), and rank 0 plans while ranks above 0
call `serve_follower()` (the package docstring's design rule). Under sp
the chunk budget is `prefill_chunk_tokens * sp` and the unified round is
refused; under dp the pool size rounds up to a multiple of dp (its
default sizes each group for its own slots). With more than one rank the
decode, verify and window dispatches run eagerly, not as graph replays
(`stats()["sharding"]["graphs"]`). `stats()["sharding"]` and
`["collectives"]` (the wire bytes of the TP collectives) are the
reference's blocks; an unsharded server never imports `serving_dist`.

Fleet hooks (the reference's `paddle_tpu/inference/serving.py:
2192-2315`; `paddle_tpu_torch.fleet` drives them): `run_host_op(fn)`
runs `fn` on the engine thread at the next round boundary, the round in
flight drained first (inline on a server not yet started; queued ops
fail with "server stopped" on stop); `export_session(rid)` swaps a
resident session out as a preemption does (or takes a queued one out of
the queue), closes its journal entry as "migrated", charges the
payload's bytes to its tenant as migration wire bytes and returns
(journal entry, `export_prefix` payload); `import_kv_payload(payload,
owner)` runs `import_prefix` as a host op. Under `sharding=` they run on
rank 0 and the pool's `PoolMirror` gathers the export from the ranks and
replays the import on them.

GenerationServer (the reference's, `paddle_tpu/inference/serving.py:
289-639`) batches requests for one compiled decode program: a
`jit.load` of an `export_generator` artifact (`TranslatedLayer`), or
any callable `(ids [B, P] int32, seed, temperature, eos, top_p, pad)
-> [B, T]`. It waits for the first request, gathers more until the
program's batch B is full or `max_wait_ms` passes, takes only requests
sharing the head request's program signature (temperature, top_p,
seed, eos; per-slot `SamplingParams` fields are rejected at submit),
LEFT-pads each prompt to P, pads a partial batch by repeating row 0,
runs the program once and fans the rows out. Pad masking is by value
in the program, so it is engaged only for a batch holding a padded row,
and a full-length prompt containing the pad id is warned about (raised
under `strict_pad_check=True`). A batch without an explicit seed draws
seed + the batch count, so sampled batches never repeat their noise.
`stats()` carries the paged server's `stop_reasons` and `quantization`
blocks. It emits the reference's tracing events (`request_submitted`,
`request_admitted`, the `decode_dispatch` span, `request_done`) and
metrics (queue depth, busy rows, requests done, stop reasons, latency;
`server="dense"`). The server computes nothing itself: the program runs
on its own device. `attribution=True` splits each batch's measured
dispatch time evenly over its rows' tenants (`submit(tenant=)`,
`cost_report()`). `measure_offered_load` drives a server at a fixed
request rate.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import weakref
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..nn.decode import PagedDecoder
from ..observability import compile_tracker as _compile_tracker
from ..observability import flight_recorder as _flight
from ..observability import log as _obs_log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..observability.attribution import (ResourceLedger,
                                         disabled_attribution_stats)
from ..observability.capacity import PressureSignals
from ..observability.slo import SLOEngine
from ..observability.trace_context import TraceContext
from ..reliability import (AdmissionShed, QuarantinedRequest,
                           RecoveryPolicy, RequestTimeout, SessionJournal,
                           resolve_fault_plan)
from ..sampling import SamplingParams, SlotParamStore
from ..sampling.buffers import host_to_device
from ..spec_decode import SpecConfig, build_verify_plan
from .kv_cache import BlockPoolExhausted, PagedKVCache, blocks_for
from .kv_tier import normalize_kv_tier, payload_nbytes

_logger = _obs_log.get_logger(__name__)

ENV_METRICS_PORT = "PADDLE_TPU_METRICS_PORT"

# Serving telemetry under the reference's names: one bool check per
# update while PADDLE_TPU_TELEMETRY is off.
_m_queue_depth = _metrics.gauge(
    "serving_queue_depth", "requests waiting for a batch/slot",
    labelnames=("server",))
_m_slots_busy = _metrics.gauge(
    "serving_slots_busy", "occupied decode slots (paged) / in-flight "
    "batch rows (dense)", labelnames=("server",))
_m_requests_done = _metrics.counter(
    "serving_requests_total", "requests completed",
    labelnames=("server",))
_m_request_latency = _metrics.histogram(
    "serving_request_latency_seconds", "submit -> future resolved",
    labelnames=("server",))
_m_ttft = _metrics.histogram(
    "serving_ttft_seconds", "submit -> first generated token (paged)")
_m_slot_releases = _metrics.counter(
    "serving_slot_releases_total", "paged slots freed, by why the "
    "request finished", labelnames=("reason",))
_m_slot_refills = _metrics.counter(
    "serving_slot_refills_total",
    "idle paged slots refilled from the queue mid-flight")
_m_itl = _metrics.histogram(
    "paddle_tpu_serving_itl_seconds",
    "inter-token latency per generated token (decode-dispatch gap "
    "amortized over the tokens it emitted, paged) — the metric the "
    "prefill_chunk_tokens knob is tuned against")
_m_prefill_dispatches = _metrics.counter(
    "serving_prefill_dispatches_total",
    "packed ragged prefill chunk dispatches (paged); an admission "
    "burst of N requests costs O(1) of these per decode round, not N")
_m_decode_stall = _metrics.histogram(
    "serving_decode_stall_seconds",
    "time in-flight decode slots stalled while a packed prefill chunk "
    "dispatch ran (bounded by the chunk token budget)")
_m_stop_reason = _metrics.counter(
    "serving_stop_reason_total",
    "finished requests by why generation stopped "
    "(eos | stop_token | stop_string | budget)",
    labelnames=("server", "reason"))
_m_sampling_fast = _metrics.counter(
    "serving_sampling_fast_path_dispatches_total",
    "decode dispatches that took the all-greedy fast path (no resident "
    "request samples: bare argmax, no sort/PRNG cost)")
_m_sampling_sampled = _metrics.counter(
    "serving_sampling_sampled_dispatches_total",
    "decode dispatches through the full vectorized sampling pipeline "
    "(>= 1 resident sampled request)")
_m_spec_proposed = _metrics.counter(
    "serving_spec_proposed_tokens_total",
    "draft tokens proposed by the drafter across all slots/rounds")
_m_spec_accepted = _metrics.counter(
    "serving_spec_accepted_tokens_total",
    "proposed draft tokens the packed verification accepted")
_m_spec_rolled_back = _metrics.counter(
    "serving_spec_rolled_back_tokens_total",
    "rejected draft positions rolled back out of the paged cache "
    "(PagedKVCache.truncate_seq)")
_m_spec_verify = _metrics.counter(
    "serving_spec_verify_dispatches_total",
    "packed verification dispatches (one per round scores every "
    "speculating slot's drafts)")
_m_spec_accept_rate = _metrics.histogram(
    "serving_spec_acceptance_rate",
    "per-slot per-round accepted/proposed draft fraction",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
_m_preemptions = _metrics.counter(
    "serving_preemptions_total",
    "slots evicted mid-flight to make room for a higher-priority "
    "admission (the victim's live K/V is published through the "
    "prefix-cache index when caching is on, then the request requeues)",
    labelnames=("reason",))
_m_resumes = _metrics.counter(
    "serving_preempt_resumes_total",
    "requests re-admitted from resume state (a preemption, a recovery "
    "requeue or a journal re-admission; re-prefill of prompt + "
    "generated-so-far, served from the prefix cache when the "
    "swapped-out blocks survived retention)")
_m_preempt_cached = _metrics.counter(
    "serving_preempt_cached_tokens_total",
    "tokens of victim K/V published into the prefix-cache index at "
    "swap-out (the work preemption preserves instead of recomputing)")
_m_deadline_miss = _metrics.counter(
    "serving_deadline_misses_total",
    "requests whose first token landed after their TTFT deadline",
    labelnames=("lane",))
_m_deadline_overage = _metrics.histogram(
    "serving_deadline_overage_seconds",
    "by how much a missed TTFT deadline was missed (first token time "
    "minus deadline; only observed on misses)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
_m_decoded = _metrics.counter(
    "serving_tokens_decoded_total",
    "generated-token positions computed on device (decode steps, "
    "verify positions, prefill token-0 samples, and resume re-prefill "
    "of already-generated tokens)")
_m_replayed = _metrics.counter(
    "serving_tokens_replayed_total",
    "decoded-token positions whose work was wasted: multi-step "
    "post-stop discards, verify positions truncated by a stop, async "
    "overshoot, and resume re-prefill of already-generated tokens")
_m_goodput = _metrics.gauge(
    "serving_goodput_ratio",
    "emitted tokens / decoded-token positions for the current stats "
    "window (1.0 = every device token reached a client; speculation "
    "rollback, multi-step overrun and resume replay lower it)")
_m_engine_exc = _metrics.counter(
    "serving_engine_exceptions_total",
    "engine dispatch exceptions, by dispatch kind",
    labelnames=("where",))
_m_round_dispatches = _metrics.histogram(
    "serving_dispatches_per_round",
    "attention dispatches one scheduler round issued (split path: "
    "chunk prefill, decode and verify can each fire; unified round: "
    "always 1)", buckets=(1.0, 2.0, 3.0, 4.0))
_m_round_overlap = _metrics.histogram(
    "serving_round_overlap_seconds",
    "host plan+dispatch time of round N+1 hidden behind round N's "
    "device execution (async double-buffered engine loop; only "
    "observed while a round was in flight)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.5))
_m_fault_injected = _metrics.counter(
    "serving_fault_injected_total",
    "deterministic FaultPlan faults fired at an engine seam "
    "(injection is opt-in: ctor fault_plan= or PADDLE_TPU_FAULT_PLAN)",
    labelnames=("seam",))
_m_dispatch_retries = _metrics.counter(
    "serving_dispatch_retries_total",
    "failing dispatches absorbed by the recovery ladder: implicated "
    "requests were snapshotted and requeued for retry instead of "
    "having their futures failed")
_m_quarantined = _metrics.counter(
    "serving_requests_quarantined_total",
    "requests failed by the recovery ladder after implicating "
    "themselves in quarantine_after consecutive dispatch failures "
    "(co-resident requests resume token-identically)")
_m_recoveries = _metrics.counter(
    "serving_recoveries_total",
    "clean recoveries: first successful dispatch after >= 1 dispatch "
    "failure — health returns degraded -> ok")
_m_timeouts = _metrics.counter(
    "serving_request_timeouts_total",
    "requests cancelled by their per-request timeout_s (queued or "
    "resident; the slot and its blocks are freed, the stream "
    "terminates with reason='timeout')")
_m_prefetch_issued = _metrics.counter(
    "kv_tier_prefetch_issued_total",
    "host-tier blocks promoted AHEAD of admission by the prefetch "
    "loop, overlapped with the in-flight round's device execution")
_m_prefetch_hit = _metrics.counter(
    "kv_tier_prefetch_hit_total",
    "prefetched tier blocks still device-resident when their request "
    "was admitted: promotion wall time the admission path never paid")
_m_prefetch_wasted = _metrics.counter(
    "kv_tier_prefetch_wasted_total",
    "prefetched tier blocks whose request left the queue unadmitted "
    "(timeout/stop) or that pool pressure reclaimed before admission")
_m_sp_peak_bytes = _metrics.gauge(
    "serving_sp_attention_bytes_peak",
    "peak cross-rank fresh-K/V bytes a packed-prefill dispatch "
    "materializes per sp rank (sharded serving, sp > 1)")
_m_promote_overlap = _metrics.histogram(
    "kv_tier_promote_overlap_seconds",
    "wall time of overlapped (prefetch-ahead) tier promote batches: "
    "host copy time hidden behind device execution instead of being "
    "charged to the admission path",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.5))
_req_ids = itertools.count()

STOP_REASONS = ("eos", "stop_token", "stop_string", "budget")

HEALTH_CODES = {"ok": 0.0, "degraded": 1.0, "stalled": 2.0}


_NO_SPAN = contextlib.nullcontext()


def _dispatch_span(name, rids, **attrs):
    """A dispatch's tracing span over the request ids `rids` (an
    iterable, walked only when tracing is on); with tracing off, one
    shared no-op context."""
    if not _tracing.enabled():
        return _NO_SPAN
    return _tracing.span(name, request_ids=list(rids), **attrs)


@dataclass
class RequestMeta:
    """Scheduling metadata the front-door scheduler reads.

    lane: SLO lane name ("interactive" = TTFT-sensitive, "batch" =
        throughput). The engine itself is lane-agnostic: lanes only
        mean something to the installed scheduler policy.
    tenant: fair-share / rate-limit / attribution accounting bucket.
    deadline_s: relative TTFT deadline in SECONDS from submit; the
        engine counts (never enforces) misses at first-token time.
    cost: tokens the tenant's rate bucket is charged at admission
        (conventionally prompt_len + token budget)."""
    lane: str = "interactive"
    tenant: str = "default"
    deadline_s: float | None = None
    cost: int = 0


@dataclass(eq=False)  # identity: queues remove requests by identity
class _Req:
    ids: np.ndarray
    future: Future
    t_submit: float
    budget: int
    sampling: SamplingParams
    seed: int  # the request's PRNG stream seed (uint32)
    rid: str = ""
    ttft: float | None = None
    # streaming callback (token, reason|None), from the engine thread
    on_token: object = None
    # resume state: gen0 = tokens emitted before the last interruption
    # (a recovery requeue or a journal re-admission; the slot's token
    # list is re-seeded with them, so positions, the PRNG step and the
    # budget are residency-invariant); resume_ids = ids ++ gen0, the
    # prompt a resume re-prefills
    gen0: tuple = ()
    resume_ids: np.ndarray | None = None
    # wall-clock cancellation deadline, seconds from submit (None =
    # never)
    timeout_s: float | None = None
    # front door: scheduling metadata (None = the default lane and
    # tenant) and the times this request was swapped out
    meta: RequestMeta | None = None
    preempts: int = 0
    # causal tracing: the TraceContext stamped onto every event, span,
    # flight-recorder entry and journal record this request touches;
    # its hop bumps on a recovery requeue or a journal re-admission
    trace: TraceContext | None = None


class PagedGenerationServer:
    """Continuous-batching server over the paged KV cache (see module
    docstring).

    model: a `models.gpt2.GPT2`; its flat params are snapshotted onto
        the server's device at construction.
    max_slots: decode slots (concurrent sequences).
    block_size: tokens per KV block.
    max_prompt_len: longest prompt accepted (default: what fits
        max_position after the token budget and the multi-step overrun).
    max_new_tokens: default and largest per-request token budget.
    num_blocks: pool size incl. the trash block (default: every slot at
        its worst case, plus one copy-on-write spare per slot when
        prefix caching is on, + 1).
    eos_token_id: server-wide stop token (None = none).
    temperature: the default request's temperature (0 = greedy), for
        requests submitted without `SamplingParams`.
    seed: the server seed; a request without an explicit seed gets
        (seed + 0x9E3779B9 * (1 + n)) mod 2^32, n counting submissions.
    detokenize: callable(list of token ids) -> str; needed by requests
        with `stop_strings`, which are matched against the detokenized
        last `stop_tail_tokens` tokens.
    steps_per_dispatch: decode tokens per dispatch (k > 1 amortizes the
        per-dispatch host cost; up to k-1 tokens per request are decoded
        and discarded after a stop).
    prefill_chunk_tokens: max real prompt tokens per packed prefill
        dispatch (smaller bounds decode ITL during bursts, larger
        finishes prefills sooner).
    pack_align: alignment of each chunk's packed region (default 8; the
        Hopper kernel takes per-token segments and needs none).
    enable_prefix_cache: block-level prefix caching (module docstring).
    kv_tier: a `kv_tier.HostKVTier` (or True for the default one) below
        the pool; needs enable_prefix_cache.
    kv_dtype: None (a dense pool in the weights' dtype) or "int8".
    quantization: None or "w8a16" (int8 weights, packed once here);
        weight_quant="int8" is its alias.
    speculation: None, True (the default `SpecConfig`) or a SpecConfig:
        speculative decoding (module docstring).
    unified_round: one dispatch per scheduler round (module docstring).
    async_rounds: the double-buffered unified loop; implies
        unified_round.
    expose_port: None (or PADDLE_TPU_METRICS_PORT) -> no ops endpoint;
        a port (0 = ephemeral) starts it with the flight recorder and
        the stall watchdog.
    flight_recorder: True or a `FlightRecorder` turns the recorder on
        without the endpoint.
    stall_timeout_s: the stall watchdog's threshold.
    fault_plan: a `FaultPlan`, a spec string, or None (then
        PADDLE_TPU_FAULT_PLAN, unset = no plan).
    recovery: True (the default `RecoveryPolicy`), a RecoveryPolicy, or
        False (a failed dispatch fails its requests).
    journal: a path or a `SessionJournal` (module docstring).
    shed_queue_depth: refuse a submit arriving at this queue depth
        (`AdmissionShed`); None = never.
    slos: None, True (`observability.slo.default_slos()`), a list of
        `SLO`, or an `SLOEngine`: the burn-rate engine fed from the
        TTFT / ITL / availability / goodput sites (module docstring).
    attribution: None (on with the ops plane or a live metrics
        registry), True or False: the per-tenant `ResourceLedger`.
    tier_prefetch: None/False, True (look 2 queued requests ahead) or
        a positive depth: promote queued requests' tiered prefix
        blocks while the round runs; needs kv_tier.
    sharding: None (one device), True (a mesh of one) or a
        `serving_dist.ShardedEngineConfig`: sharded serving (module
        docstring); every rank constructs the server alike.
    device: None -> CUDA (raises when absent); "cpu" for the plain path.
    """

    def __init__(self, model, *, max_slots=4, block_size=16,
                 max_prompt_len=None, max_new_tokens=32, num_blocks=None,
                 eos_token_id=None, temperature=0.0, seed=0,
                 steps_per_dispatch=1, prefill_chunk_tokens=512,
                 pack_align=None, detokenize=None, stop_tail_tokens=16,
                 enable_prefix_cache=False, kv_tier=None, kv_dtype=None,
                 quantization=None, weight_quant=None, speculation=None,
                 unified_round=False, async_rounds=False,
                 expose_port=None, flight_recorder=None,
                 stall_timeout_s=30.0, fault_plan=None, recovery=True,
                 journal=None, shed_queue_depth=None, slos=None,
                 attribution=None, tier_prefetch=None, sharding=None,
                 device=None):
        if quantization not in (None, "w8a16"):
            raise ValueError(f"unknown quantization {quantization!r} "
                             "(supported: None, 'w8a16')")
        if weight_quant == "int8":
            quantization = "w8a16"
        elif weight_quant is not None:
            raise ValueError(f"unknown weight_quant {weight_quant!r} "
                             "(supported: 'int8')")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(supported: None, 'int8')")
        self.quantization = quantization
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        cfg = model.cfg
        self.temperature = float(temperature)
        self.max_new = int(max_new_tokens)
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # speculation: True -> the default SpecConfig; None keeps the
        # plain scheduler round exactly
        if speculation is True:
            speculation = SpecConfig()
        elif speculation is not None and not isinstance(speculation,
                                                        SpecConfig):
            raise TypeError(f"speculation must be a SpecConfig, True or "
                            f"None, got {type(speculation).__name__}")
        self.speculation = speculation
        self._spec_k = (speculation.max_draft_tokens
                        if speculation is not None else 0)
        self._drafter = (speculation.make_drafter()
                         if speculation is not None else None)
        if speculation is not None and self.steps_per_dispatch > 1:
            raise ValueError(
                "speculation requires steps_per_dispatch=1 (the verify "
                "dispatch already amortizes the per-dispatch floor over "
                "up to K+1 tokens; fusing verify rounds into a scan "
                "would need host drafting mid-scan)")
        self._async = bool(async_rounds)
        self._unified = bool(unified_round) or self._async
        if self._unified and self.steps_per_dispatch > 1:
            raise ValueError(
                "unified_round/async_rounds require steps_per_dispatch"
                "=1 (the fused round already amortizes the dispatch "
                "floor over the whole round)")
        # sharded serving: normalized and checked eagerly (tp must divide
        # the heads); the unsharded path never imports serving_dist
        if sharding is not None:
            from ..serving_dist import normalize_sharding

            sharding = normalize_sharding(sharding, cfg.num_heads)
        self._sp_degree = sharding.sp if sharding is not None else 1
        self._sp_attention = (sharding.sp_attention
                              if sharding is not None else "allgather")
        if self._unified and self._sp_degree > 1:
            raise ValueError(
                "sequence-parallel prefill (ShardedEngineConfig.sp > 1) "
                "requires the split scheduler path — the unified round "
                "packs decode/verify rows into the same stream the sp "
                "program would shard, and decode stays TP by design "
                "(set unified_round/async_rounds False)")
        self._uk1 = self._spec_k + 1  # the pinned readout width K + 1
        # verify regions take any packing on the card (K1 reads per-token
        # segments) and on the CPU: the reference's value off the TPU
        self._verify_align = 1
        # overrun past the budget: a multi-step dispatch may write up to
        # k-1 discarded tokens, a verify dispatch up to K speculative
        # positions past the last emitted token (rolled back on
        # rejection, but the blocks must be reservable); async rounds add
        # one round of overshoot, 1 + K positions
        slack = max(self.steps_per_dispatch - 1, self._spec_k)
        if self._async:
            slack += 1 + self._spec_k
        self._overrun = slack
        self.max_prompt_len = int(
            max_prompt_len or cfg.max_position - self.max_new
            - self._overrun)
        if self.max_prompt_len + self.max_new + self._overrun \
                > cfg.max_position:
            raise ValueError(
                f"max_prompt_len ({self.max_prompt_len}) + max_new_tokens "
                f"({self.max_new}) + overrun slack ({self._overrun}, "
                f"steps_per_dispatch/speculation) exceeds max_position "
                f"({cfg.max_position})")
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        if self.prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        self._pack_align = 8 if pack_align is None else int(pack_align)
        if self._pack_align < 1:
            raise ValueError("pack_align must be >= 1")
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        tier = normalize_kv_tier(kv_tier)
        if tier is not None and not self.enable_prefix_cache:
            raise ValueError(
                "kv_tier requires enable_prefix_cache=True (the tier "
                "holds demoted prefix-index content)")
        # tier prefetch-ahead: promote a QUEUED request's tiered blocks
        # into the pool while the current round runs, so its admission
        # attach finds the chain device-resident. None/False = the
        # synchronous promote-on-attach path only
        if tier_prefetch is not None and tier_prefetch is not False:
            if tier is None:
                raise ValueError(
                    "tier_prefetch requires kv_tier (prefetch-ahead "
                    "promotes host-tier content ahead of admission; "
                    "without a tier there is nothing to promote)")
            look = 2 if tier_prefetch is True else int(tier_prefetch)
            if look < 1:
                raise ValueError(
                    f"tier_prefetch={tier_prefetch!r} must be True or "
                    f"a positive lookahead depth (queued requests "
                    f"scanned per round)")
        else:
            look = 0
        self._prefetch_look = look
        self._prefetched: dict = {}       # rid -> prefetched hashes
        self._prefetch_done: set = set()  # rids whose walk went dry
        self._promote_ctx = None  # rid the attach in progress serves
        # reliability: the fault plan (one `is None` check per seam when
        # absent), the recovery policy (None = the old blast radius),
        # the journal and the shed depth; all validated before any
        # device allocation
        self._faults = resolve_fault_plan(fault_plan)
        if recovery is True:
            recovery = RecoveryPolicy()
        elif recovery is False or recovery is None:
            recovery = None
        elif not isinstance(recovery, RecoveryPolicy):
            raise TypeError(f"recovery must be a RecoveryPolicy or a "
                            f"bool, got {type(recovery).__name__}")
        self._recovery = recovery
        if isinstance(journal, (str, os.PathLike)):
            journal = SessionJournal(journal)
        elif journal is not None and not isinstance(journal,
                                                    SessionJournal):
            raise TypeError(f"journal must be a SessionJournal or a "
                            f"path, got {type(journal).__name__}")
        self._journal = journal
        if shed_queue_depth is not None and int(shed_queue_depth) < 1:
            raise ValueError(f"shed_queue_depth must be >= 1, "
                             f"got {shed_queue_depth}")
        self._shed_depth = (None if shed_queue_depth is None
                            else int(shed_queue_depth))
        self._params = {k: v.to(self.device)
                        for k, v in model.flat_params().items()}
        if quantization == "w8a16":
            self._params = model.quantize_weights(self._params)
        dt = self._params["ln_f.weight"].dtype
        self._m_width = blocks_for(
            self.max_prompt_len + self.max_new + self._overrun,
            self.block_size)
        dp = sharding.dp if sharding is not None else 1
        if num_blocks is None:  # worst case: every slot at full horizon
            spare = 1 if self.enable_prefix_cache else 0
            # under dp each block group backs its own slots (and holds
            # its own trash block)
            per_group = -(-self.max_slots // dp)
            num_blocks = dp * (per_group * (self._m_width + spare) + 1)
        # the pool's block axis splits over dp: round up to a multiple
        num_blocks = -(-int(num_blocks) // dp) * dp
        pool_kw = dict(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            block_size=self.block_size, num_blocks=num_blocks, dtype=dt,
            kv_dtype=kv_dtype, tier=tier, device=self.device)
        self.sharding = None
        self._mesh = None
        self._dist = None
        self._slot_groups = None
        if sharding is None:
            self.cache = PagedKVCache(**pool_kw)
            self._decoder = PagedDecoder.for_config(cfg, self.block_size,
                                                    kv_dtype=kv_dtype)
        else:
            # this rank's params, pool slice and decoder (collective:
            # every rank of the mesh constructs the server)
            from ..serving_dist import apply_sharding

            self._slot_groups = apply_sharding(self, sharding, cfg,
                                               pool_kw).slot_groups
        # graphs need a world of one (gloo collectives cannot be captured)
        self._graphs_on = self.device.type == "cuda" and (
            self._dist is None or not self._dist.multi)
        # the sp peak-bytes high-water mark (host arithmetic)
        self._sp_peak_bytes = 0
        self._sp_bytes_kw = dict(
            sp=self._sp_degree,
            tp=sharding.tp if sharding is not None else 1,
            num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            kv_quant=kv_dtype == "int8",
            itemsize=torch.tensor([], dtype=dt).element_size())
        # per-slot sampling state; the constructor's temperature is the
        # default for requests submitted without SamplingParams
        self._sp_store = SlotParamStore(self.max_slots, cfg.vocab_size,
                                        self.device)
        self._default_sampling = SamplingParams(
            temperature=self.temperature)
        self._detok = detokenize
        self.stop_tail_tokens = int(stop_tail_tokens)
        if self.stop_tail_tokens < 1:
            raise ValueError("stop_tail_tokens must be >= 1")
        self._seed0 = int(seed) & 0xFFFFFFFF
        self._auto_seeds = itertools.count()
        # slot state: None (idle) or dict(seq, req, toks, prompt, pos,
        # budget, fed, cached, chunks, t_pre0, t_last)
        self._slots = [None] * self.max_slots
        self._worst: dict[int, int] = {}  # seq -> worst-case block count
        self._seq_counter = 0
        self._lock = threading.Condition()
        self._queue: list[_Req] = []
        self._stop = False
        self._thread = None
        self._t0 = None
        # async rounds: the round in flight (plan, outputs) and the
        # slot-indexed device carry (token, write position, PRNG step)
        self._pending = None
        self._carry = None
        self._zero_carry = None
        # fleet host ops [(fn, Future)], run at the next round boundary
        self._host_ops: list = []
        # recovery ladder state (outside the stats window)
        self._fault_streak: dict[str, int] = {}  # rid -> consecutive
        self._consec_failures = 0                # failing dispatches
        self._any_timeouts = False  # set once a timed request is seen
        self._last_recovery = None  # {"ts", "recovered_from", "failures"}
        self._last_error = None
        self._last_error_info = None
        self._draining = False
        self._warm_ran = False
        # front door: the installed scheduler (None = the FIFO path)
        self._sched = None
        # SLO engine: None = every feed site is one `is None` check
        if slos is None or slos is False:
            self._slo = None
        elif isinstance(slos, SLOEngine):
            self._slo = slos
        else:
            self._slo = SLOEngine(slos)
        # the name a fleet wrapper stamps on trace events and spans
        self.trace_name = None
        self._reset_window()
        # ---- operations plane ----------------------------------------
        if expose_port is None:
            env_port = os.environ.get(ENV_METRICS_PORT, "")
            expose_port = int(env_port) if env_port else None
        self._ops_progress = 0  # bumped on every dispatch and admission;
        # the stall watchdog samples it
        if isinstance(flight_recorder, _flight.FlightRecorder):
            self._recorder = flight_recorder
        else:
            self._recorder = _flight.FlightRecorder(
                enabled=bool(flight_recorder)
                or expose_port is not None)
        self.stall_timeout_s = float(stall_timeout_s)
        self._watchdog = None
        self.exporter = None
        # attribution: None turns the ledger on with the ops plane or a
        # live metrics registry. It attaches to the pool before any
        # allocation, so every block's ownership is complete and the
        # conservation equations hold exactly
        if attribution is None:
            attribution = expose_port is not None or _metrics.enabled()
        self._ledger = ResourceLedger() if attribution else None
        self.cache.ledger = self._ledger
        self._attr_parts = None  # the cost rows of the dispatch running
        # pressure signals: always built (a sample is host counters
        # only); auto-sampled at round boundaries only with the
        # telemetry plane on, sampled fresh by capacity_snapshot()
        self._capacity = PressureSignals({
            "pool": self._cap_pool,
            "tier": self._cap_tier,
            "queues": self._cap_queues,
            "admission": self._cap_admission,
            "slo": self._cap_slo,
        })
        self._cap_auto = self._recorder.enabled or expose_port is not None
        if self.cache.tier is not None:
            self.cache.on_tier_event = self._on_tier_event
        # process-wide capture accounting: this engine answers "am I
        # serving live work" for the in-flight label, mirrors captures
        # into its flight recorder, and windows the count for
        # stats()["compiles"] (weakrefs: no unregister needed)
        _compile_tracker.register_in_flight_probe(self._ops_in_flight)
        _compile_tracker.add_listener(self._on_compile_event)
        self._compile_mark = _compile_tracker.mark()
        if expose_port is not None:
            # asking for a scrape endpoint IS opting into metrics
            _metrics.REGISTRY.enable()
            self._watchdog = _flight.StallWatchdog(
                lambda: self._ops_progress, self._ops_in_flight,
                timeout=self.stall_timeout_s,
                on_stall=self._on_stall).start()
            from ..observability.exporter import OpsEndpoint

            self.exporter = OpsEndpoint(
                statusz_fn=self.statusz, healthz_fn=self.health,
                livez_fn=self.liveness, readyz_fn=self.readiness,
                slo_fn=(self.slo_report if self._slo is not None
                        else None),
                capacity_fn=self.capacity_snapshot).start(
                    port=expose_port)
            # pull-time health gauge of the most recent ops-plane
            # server; a weak reference, so the registry does not keep a
            # killed server (and its pool) alive
            me = weakref.ref(self)

            def health_code():
                srv = me()
                return HEALTH_CODES[srv.health()[0]] if srv else 0.0

            _metrics.REGISTRY.gauge_fn(
                "serving_health_state",
                "engine health (0 ok, 1 degraded, 2 stalled) of the "
                "most recent ops-plane server", health_code)

    # ---- client surface -------------------------------------------------
    def submit(self, ids, max_new_tokens=None, sampling=None, *,
               meta=None, on_token=None, timeout_s=None, rid=None,
               trace_ctx=None):
        """Enqueue one prompt (any length <= max_prompt_len; no padding).
        Returns a Future resolving to the UNPADDED [len + generated]
        int32 sequence. Generation stops at EOS, a stop token id, a stop
        string, or the token budget (`max_new_tokens` arg, else
        `sampling`'s, else the server default).

        on_token: callable(token, reason) called from the engine thread
            for every generated token (reason None mid-stream, the stop
            reason on the last); an exception drops the stream, not the
            request.
        timeout_s: cancel the request (slot and blocks freed, the future
            fails with `RequestTimeout`) once it is this many seconds
            past its submit, queued or resident. Needs a started server.
        rid: a caller-pinned request id (default "pN"): the journal and
            the quarantine diagnostics speak it.
        meta: a `RequestMeta` (lane, tenant, TTFT deadline, rate cost)
            for the installed scheduler, whose `on_submit` may raise to
            reject (nothing is enqueued then); without a scheduler it
            rides along for attribution and the per-lane stats.
        trace_ctx: a caller-minted `TraceContext` (a front door or a
            router mints once, so the request's whole lifetime shares
            one trace_id); default a fresh hop-0 context.

        With `shed_queue_depth=`, a submit arriving at a queue that deep
        raises `AdmissionShed` (nothing is enqueued)."""
        if sampling is None:
            sampling = self._default_sampling
        elif not isinstance(sampling, SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, "
                            f"got {type(sampling).__name__}")
        if sampling.stop_strings and self._detok is None:
            raise ValueError(
                "stop_strings given but the server has no detokenizer "
                "(pass detokenize= to the PagedGenerationServer "
                "constructor)")
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0 or ids.size > self.max_prompt_len:
            raise ValueError(f"prompt length {ids.size} not in "
                             f"[1, {self.max_prompt_len}]")
        budget = (max_new_tokens if max_new_tokens is not None
                  else sampling.max_new_tokens)
        budget = self.max_new if budget is None else int(budget)
        if not 1 <= budget <= self.max_new:
            raise ValueError(f"max_new_tokens {budget} not in "
                             f"[1, {self.max_new}]")
        if meta is not None and not isinstance(meta, RequestMeta):
            raise TypeError(f"meta must be a RequestMeta, "
                            f"got {type(meta).__name__}")
        if timeout_s is not None:
            timeout_s = float(timeout_s)
            if timeout_s <= 0:
                raise ValueError(f"timeout_s must be > 0, "
                                 f"got {timeout_s}")
            self._any_timeouts = True
        if trace_ctx is not None and not isinstance(trace_ctx,
                                                    TraceContext):
            raise TypeError(f"trace_ctx must be a TraceContext, "
                            f"got {type(trace_ctx).__name__}")
        # explicit seeds reproduce tokens whatever the batch; auto seeds
        # give each request its own stream, deterministic given the
        # order of submission
        seed = (sampling.seed if sampling.seed is not None else
                (self._seed0 + 0x9E3779B9 * (1 + next(self._auto_seeds)))
                & 0xFFFFFFFF)
        req = _Req(ids=ids, future=Future(), t_submit=time.perf_counter(),
                   budget=budget, sampling=sampling, seed=seed,
                   rid=(str(rid) if rid is not None
                        else f"p{next(_req_ids)}"),
                   on_token=on_token, timeout_s=timeout_s, meta=meta,
                   trace=(trace_ctx if trace_ctx is not None
                          else TraceContext.mint()))
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            if self._shed_depth is not None:
                depth = self._queue_depth_locked()
                if depth >= self._shed_depth:
                    self._sheds += 1
                    hint = self._retry_after_hint_locked(depth)
                    self._recorder.record("shed", request_id=req.rid,
                                          depth=depth,
                                          retry_after_s=round(hint, 3))
                    raise AdmissionShed(depth, self._shed_depth, hint)
            if self._sched is not None:
                # scheduler-owned queues: on_submit may raise (a bounded
                # queue's rejection); nothing is enqueued then
                try:
                    self._sched.on_submit(req, time.perf_counter())
                except Exception as e:
                    self._recorder.record(
                        "reject", request_id=req.rid,
                        error=f"{type(e).__name__}: {e}")
                    raise
            else:
                self._queue.append(req)
                _m_queue_depth.labels(server="paged").set(len(self._queue))
            if self._journal is not None:
                # under the lock: the loop admits under it too, so the
                # accept record precedes the request's first token
                self._journal.record_accept(req)
            self._lock.notify()
        if self._ledger is not None:
            # only requests that were enqueued enter the cost ledger
            self._ledger.request_begin(
                req.rid, meta.tenant if meta is not None else "default")
        self._recorder.record(
            "submit", request_id=req.rid, prompt_len=int(ids.size),
            budget=budget, lane=meta.lane if meta is not None else None,
            tenant=meta.tenant if meta is not None else None,
            **self._tr(req))
        _tracing.event("request_submitted", request_id=req.rid,
                       prompt_len=int(ids.size), budget=budget,
                       **self._tr(req))
        return req.future

    def _queue_depth_locked(self):
        """Requests waiting: the FIFO queue, or the scheduler's."""
        return (self._sched.depth() if self._sched is not None
                else len(self._queue))

    def set_scheduler(self, sched):
        """Install a front-door scheduler: an object owning the request
        queues and the admission and preemption policy. The engine asks
        it instead of its FIFO queue for submission routing
        (`on_submit`, which may raise to reject), candidate selection
        (`next_request` / `pop`), preemption victims (`victims`), the
        requeue of preempted requests (`requeue`), packed-prefill order
        and per-slot chunk caps (`prefill_plan`), timeouts (`expire`),
        prefetch look-ahead (`peek`) and queue depths (`depth` /
        `lane_depths` / `tenant_depths`). None uninstalls; without one
        the engine runs its reservation-FIFO path unchanged. Install
        before start(): the loop reads it unlocked."""
        if self._thread is not None:
            raise RuntimeError("install the scheduler before start()")
        self._sched = sched
        return self

    def start(self):
        if self._thread is not None:
            return self
        if self._stop:
            raise RuntimeError(
                "server was stopped; build a new PagedGenerationServer")
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _halt(self):
        """Stop the loop (it processes the round in flight first), then
        the ops plane; flush the journal."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=120)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
        if self.exporter is not None:
            self.exporter.stop()
        if self._journal is not None:
            self._journal.flush()

    def stop(self):
        """Graceful shutdown: queued and resident futures fail with
        "server stopped" (no client hangs); their journal records stay
        live, so a restarted server may still re-admit them. A sharded
        server's rank 0 then releases its followers."""
        self._halt()
        if self._dist is not None:
            self._dist.close()
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            if self._sched is not None:
                pending.extend(self._sched.drain())
            for req in pending:
                self._abandon_prefetch_locked(req.rid)
            # residents of a stopped loop never finish: fail them too
            pending += [s["req"] for s in self._slots if s is not None]
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

    def kill(self):
        """Hard-stop the engine WITHOUT resolving the futures of queued
        or resident requests: the crash of the journal's recovery story.
        A fresh server built over the same journal re-admits every
        accepted-but-unfinished request (`recover_from_journal`). The
        round in flight is processed before the loop exits, so every
        token the host had received is journaled."""
        self._halt()
        if self._dist is not None:
            self._dist.close()

    def serve_follower(self):
        """Ranks above 0 of a sharded server: replay rank 0's dispatches
        and pool operations on this rank's slices until rank 0 stops.
        Returns {"dispatches": n, "digest": hex} — the digest folds in
        every dispatch's tokens, equal on every rank."""
        if self._dist is None or not self._dist.multi:
            raise RuntimeError("serve_follower() needs a sharded server "
                               "over more than one rank")
        return self._dist.serve()

    # ---- stats -----------------------------------------------------------
    def _reset_window(self):
        self._lat = []
        self._ttft = []
        self._itl = []
        self._tokens_out = 0
        self._steps = 0
        self._prefills = 0
        self._prefill_dispatches = 0
        self._active_integral = 0
        self._sampled_dispatches = 0
        self._fastpath_dispatches = 0
        self._graph_replays = 0
        self._verify_replays = 0
        self._round_replays = 0
        self._stop_reasons = dict.fromkeys(STOP_REASONS, 0)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rolled_back = 0
        self._spec_dispatches = 0
        self._spec_rounds_per_slot = 0
        self._rounds = 0
        self._round_dispatch_count = 0
        self._mixed_rounds = 0
        self._overlap_s = 0.0
        # goodput: decoded = emitted + spec-rolled-back + replayed, by
        # construction at every dispatch site
        self._decoded_tokens = 0
        self._replayed_tokens = 0
        # reliability window counters
        self._faults_injected = 0
        self._dispatch_retries = 0
        self._recoveries = 0
        self._quarantined = 0
        self._timeouts = 0
        self._sheds = 0
        self._resumes = 0
        self._warm_resumes = 0
        # front door window counters (zeros without a scheduler)
        self._preemptions = 0
        self._preempt_cached_tokens = 0
        self._deadline_requests: dict[str, int] = {}
        self._deadline_misses: dict[str, int] = {}
        self._lane_ttft: dict[str, list] = {}
        self._lane_itl: dict[str, list] = {}
        # tier prefetch-ahead window counters
        self._prefetch_issued = 0
        self._prefetch_hits = 0
        self._prefetch_wasted = 0
        self._prefetch_overlap_s = 0.0
        self._sp_peak_bytes = 0
        if self._dist is not None:
            self._dist.reset_wire_stats()
        # goodput-delta marks of the per-round SLO feed
        self._slo_good_mark = (0, 0)
        if self._sched is not None:
            self._sched.reset_window()
        self._compile_mark = _compile_tracker.mark()
        # a fresh window is healthy again
        self._last_error = None
        self._last_error_info = None
        self._consec_failures = 0

    def reset_stats(self):
        """Zero the measurement window (latency, TTFT and ITL samples,
        counters, the degraded state) and restart its clock."""
        with self._lock:
            self._reset_window()
            self._t0 = time.perf_counter()
        if self._ledger is not None:
            # window accounts zero; occupancy LEVELS carry forward, so
            # both sides of each conservation equation restart at zero
            self._ledger.reset()

    def stats(self):
        """Window stats. ITL is per GENERATED token: each decode
        dispatch's host-visible gap since the slot's previous emission,
        amortized over the tokens it emitted."""
        with self._lock:
            lat = sorted(self._lat)
            ttft = sorted(self._ttft)
            itl = sorted(self._itl)
            dt = (time.perf_counter() - self._t0) if self._t0 else 0.0

            def pct(xs, p):
                return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else 0.0

            out = {
                "requests": len(lat),
                "new_tokens": self._tokens_out,
                "tokens_per_sec": self._tokens_out / dt if dt else 0.0,
                "p50_ms": pct(lat, 0.50) * 1e3,
                "p90_ms": pct(lat, 0.90) * 1e3,
                "p99_ms": pct(lat, 0.99) * 1e3,
                "ttft_p50_ms": pct(ttft, 0.50) * 1e3,
                "ttft_p99_ms": pct(ttft, 0.99) * 1e3,
                "itl_p50_ms": pct(itl, 0.50) * 1e3,
                "itl_p99_ms": pct(itl, 0.99) * 1e3,
                "decode_steps": self._steps,
                "prefills": self._prefills,
                "prefill_dispatches": self._prefill_dispatches,
                # decode dispatches by mode: any row sampled, or the
                # bare-argmax greedy variant
                "sampling_sampled_dispatches": self._sampled_dispatches,
                "sampling_fast_path_dispatches": self._fastpath_dispatches,
                "stop_reasons": dict(self._stop_reasons),
                # mean busy slots per decode dispatch / max_slots
                "slot_fill": (self._active_integral
                              / ((self._steps or 1) * self.max_slots)),
                "kv_cache": self.cache.stats(),
                # decode dispatches served by a CUDA graph replay (every
                # one on the card, none on the CPU) and the captures so
                # far (the decoder's lifetime)
                "decode_graph_replays": self._graph_replays,
                "decode_graph_captures": self._decoder.graphs.captures,
                # verify dispatches and window rounds served by a graph
                # replay (every one on the card)
                "verify_graph_replays": self._verify_replays,
                "round_graph_replays": self._round_replays,
                # the reference's schema, zeroed when speculation is off
                "speculation": {
                    "enabled": self.speculation is not None,
                    "proposed_tokens": self._spec_proposed,
                    "accepted_tokens": self._spec_accepted,
                    "rolled_back_tokens": self._spec_rolled_back,
                    "verify_dispatches": self._spec_dispatches,
                    "slot_rounds": self._spec_rounds_per_slot,
                    # share of the proposed draft tokens accepted
                    "acceptance_rate": (self._spec_accepted
                                        / (self._spec_proposed or 1)),
                },
                # rounds and attention dispatches on both engine paths
                # (split: up to prefill + decode or verify a round;
                # unified: 1); mixed = rounds with prefill AND decode or
                # verify work; overlap = host plan + dispatch time hidden
                # behind a round in flight (async)
                "rounds": {
                    "unified": self._unified,
                    "async": self._async,
                    "rounds": self._rounds,
                    "attention_dispatches": self._round_dispatch_count,
                    "dispatches_per_round": (self._round_dispatch_count
                                             / (self._rounds or 1)),
                    "mixed_rounds": self._mixed_rounds,
                    "overlap_seconds": self._overlap_s,
                    "overlap_fraction": (self._overlap_s / dt
                                         if dt else 0.0),
                },
                # the reference's schema, zeroed when quantization is off
                "quantization": {
                    "enabled": (self.quantization is not None
                                or self.kv_dtype is not None),
                    "mode": self.quantization or "none",
                    "kv_dtype": self.cache.stats_kv_dtype(),
                    "kv_scale_bytes": self.cache.scale_bytes,
                    "kv_pool_bytes_total": self.cache.pool_bytes_total,
                },
                # decoded device tokens = emitted + speculation-rolled-
                # back + replayed (multi-step overrun discards,
                # stop-truncated verify positions, async overshoot,
                # resume re-prefill of emitted tokens)
                "goodput": {
                    "decoded_tokens": self._decoded_tokens,
                    "goodput_tokens": self._tokens_out,
                    "rolled_back_tokens": self._spec_rolled_back,
                    "replayed_tokens": self._replayed_tokens,
                    "goodput_ratio": (self._tokens_out
                                      / (self._decoded_tokens or 1)),
                },
                # fault injection, the recovery ladder, timeouts and
                # shedding (zeros when nothing failed); `resumes` counts
                # re-admissions from resume state, `warm_resumes` those
                # that skipped the prefill
                "reliability": {
                    "recovery_enabled": self._recovery is not None,
                    "fault_plan": (self._faults.describe()
                                   if self._faults is not None
                                   else None),
                    "faults_injected": self._faults_injected,
                    "dispatch_retries": self._dispatch_retries,
                    "recoveries": self._recoveries,
                    "quarantined": self._quarantined,
                    "timeouts": self._timeouts,
                    "shed": self._sheds,
                    "resumes": self._resumes,
                    "warm_resumes": self._warm_resumes,
                    "consecutive_failures": self._consec_failures,
                    "last_recovery": (dict(self._last_recovery)
                                      if self._last_recovery else None),
                    "journal": (self._journal.stats()
                                if self._journal is not None else None),
                },
                # CUDA graph captures inside THIS window (the process-
                # wide capture tracker, windowed at reset_stats):
                # in_flight > 0 means a capture landed on live requests
                "compiles": {
                    "window_total": _compile_tracker.count_since(
                        self._compile_mark),
                    "window_in_flight": _compile_tracker.count_since(
                        self._compile_mark, in_flight=True),
                },
                # ops plane state (schema-stable when disabled)
                "ops": {
                    "exporter_port": (self.exporter.port
                                      if self.exporter else None),
                    "health": ("ok" if self._watchdog is None
                               and self._last_error is None
                               else self.health()[0]),
                    "stalls": (self._watchdog.stalls
                               if self._watchdog else 0),
                    "flight_recorder": self._recorder.stats(),
                },
                # tier prefetch-ahead: blocks promoted ahead of
                # admission and how they settled (zeros when off)
                "tier_prefetch": {
                    "enabled": bool(self._prefetch_look),
                    "lookahead": self._prefetch_look,
                    "issued_blocks": self._prefetch_issued,
                    "hit_blocks": self._prefetch_hits,
                    "wasted_blocks": self._prefetch_wasted,
                    "hit_rate": (self._prefetch_hits
                                 / (self._prefetch_issued or 1)),
                    "overlap_promote_s": self._prefetch_overlap_s,
                },
                "available_blocks": self.cache.available_block_count,
                # queue depths: the FIFO queue, or the scheduler's lane
                # and tenant queues (empty dicts without a front door)
                "queue_depth": self._queue_depth_locked(),
                "lane_queue_depth": ({} if self._sched is None
                                     else self._sched.lane_depths()),
                "tenant_queue_depth": ({} if self._sched is None
                                       else self._sched.tenant_depths()),
                "frontdoor": self._frontdoor_stats_locked(),
                # the mesh, and the TP collectives' wire bytes (zeroed
                # schema when unsharded or tp = 1)
                "sharding": self._sharding_stats(),
                "collectives": self._collectives_stats(),
                "wall_s": dt,
            }
        # the ledger and the SLO engine have their own locks
        out["attribution"] = (self._ledger.stats()
                              if self._ledger is not None
                              else disabled_attribution_stats())
        out["slo"] = {
            "enabled": self._slo is not None,
            "slos": (self._slo.evaluate()
                     if self._slo is not None else []),
        }
        return out

    def _sharding_stats(self):
        """The stats()["sharding"] block: the config's shape when sharded,
        the zeroed schema otherwise (no serving_dist import)."""
        if self.sharding is None:
            return {"enabled": False, "mesh_shape": {}, "tp_degree": 0,
                    "dp_degree": 0, "sp_degree": 0,
                    "collective_quant": "none", "sp_attention": "none",
                    "sp_attention_bytes_peak": 0}
        out = self.sharding.stats_block()
        out["sp_attention_bytes_peak"] = self._sp_peak_bytes
        out["graphs"] = ("on" if self._graphs_on
                         else "off (world > 1: eager dispatches)"
                         if self._dist.multi else "off (cpu)")
        return out

    def _collectives_stats(self):
        """The stats()["collectives"] block: the window's wire bytes of
        the TP collectives (zeros unsharded or at tp = 1)."""
        cq = self._dist.shard.cq if self._dist is not None else None
        wire = (self._dist.wire_stats() if self._dist is not None
                else {"bytes_total": 0, "bytes_baseline": 0,
                      "by_collective": {}})
        return {
            "enabled": cq is not None,
            "mode": cq.mode if cq is not None else "none",
            "tp": self.sharding.tp if self.sharding is not None else 1,
            "bytes_total": wire["bytes_total"],
            "bytes_baseline": wire["bytes_baseline"],
            "by_collective": wire["by_collective"],
        }

    def _note_sp_peak(self, packed_tokens):
        """The cross-rank fresh-K/V bytes this packed dispatch holds a sp
        rank (host arithmetic): kept as a high-water mark, and for ring
        and ulysses asserted under the chunk-length-independent bound
        on every dispatch."""
        from ..serving_dist.sp_attention import (sp_attention_flat_bound,
                                                 sp_attention_peak_bytes)

        mode = self._sp_attention
        peak = sp_attention_peak_bytes(mode, int(packed_tokens),
                                       **self._sp_bytes_kw)
        if mode != "allgather":
            kw = dict(self._sp_bytes_kw)
            kw.pop("sp")
            bound = sp_attention_flat_bound(mode, **kw)
            if peak > bound:
                raise AssertionError(
                    f"sp_attention={mode!r}: dispatch peak {peak} B "
                    f"exceeds the chunk-length-independent flat bound "
                    f"{bound} B — the O(block) memory invariant broke")
        if peak > self._sp_peak_bytes:
            self._sp_peak_bytes = peak
            _m_sp_peak_bytes.set(float(peak))

    def _frontdoor_stats_locked(self):
        """The stats()["frontdoor"] block; caller holds the lock."""
        def pcts(samples):
            xs = sorted(samples)
            n = len(xs)
            return {
                "p50_ms": xs[min(n - 1, int(0.50 * n))] * 1e3 if n else 0.0,
                "p99_ms": xs[min(n - 1, int(0.99 * n))] * 1e3 if n else 0.0,
                "n": n,
            }

        lanes = {}
        for lane in sorted(set(self._lane_ttft) | set(self._lane_itl)):
            lanes[lane] = {"ttft": pcts(self._lane_ttft.get(lane, ())),
                           "itl": pcts(self._lane_itl.get(lane, ()))}
        d_req = sum(self._deadline_requests.values())
        d_miss = sum(self._deadline_misses.values())
        out = {
            "enabled": self._sched is not None,
            "preemptions": self._preemptions,
            "resumes": self._resumes,
            "preempt_cached_tokens": self._preempt_cached_tokens,
            "deadline_requests": dict(self._deadline_requests),
            "deadline_misses": dict(self._deadline_misses),
            "deadline_miss_rate": d_miss / (d_req or 1),
            "lanes": lanes,
            "rejected": 0,
            "rate_throttled_skips": 0,
        }
        if self._sched is not None:
            out.update(self._sched.window_stats())
        return out

    def cost_report(self):
        """The per-tenant `CostReport` billing export of the current
        window; None when attribution is off."""
        return self._ledger.report() if self._ledger is not None else None

    # ---- capacity signals ------------------------------------------------
    def _cap_pool(self):
        return self.cache.headroom()

    def _cap_tier(self):
        return self.cache._tier_stats()

    def _cap_queues(self):
        out = {"queue_depth": len(self._queue),
               "busy_slots": sum(1 for s in self._slots if s is not None),
               "max_slots": self.max_slots,
               "lanes": {}, "tenants": {}}
        sched = self._sched
        if sched is not None:
            try:
                out["queue_depth"] = sched.depth()
                out["lanes"] = sched.lane_depths()
                out["tenants"] = sched.tenant_depths()
            except Exception:  # noqa: BLE001 — a torn-down scheduler
                pass           # must not poison the snapshot
        return out

    def _cap_admission(self):
        info = self._last_error_info
        return {
            "sheds": self._sheds,
            "shed_queue_depth": self._shed_depth,
            "draining": self._draining,
            # how short the last failed allocation fell (0 when healthy)
            "exhaustion_needed": (info or {}).get("needed", 0),
            "exhaustion_available": (info or {}).get("available", 0),
        }

    def _cap_slo(self):
        if self._slo is None:
            return {"enabled": False, "slos": []}
        rep = self._slo.report()
        return {"enabled": True, "worst": rep["worst"],
                "slos": [{"name": s["name"], "state": s["state"],
                          "burn_fast": s["burn_fast"],
                          "burn_slow": s["burn_slow"],
                          "budget_remaining": s["budget_remaining"]}
                         for s in rep["slos"]]}

    def capacity_snapshot(self):
        """One fresh `PressureSignals` snapshot (schema_version 1): the
        /capacity payload."""
        return self._capacity.sample()

    def _maybe_sample_capacity(self):
        """Round-boundary auto-sample (telemetry plane on only): a
        min-interval-gated snapshot into the flight recorder, so stall
        and exception dumps carry the pressure history."""
        if not self._cap_auto:
            return
        snap = self._capacity.maybe_sample()
        if snap is None:
            return
        pool = snap.get("pool", {})
        fc = snap.get("forecast", {})
        self._recorder.record(
            "capacity_sample", free_blocks=pool.get("free_blocks"),
            available_blocks=pool.get("available_blocks"),
            queue_depth=snap.get("queues", {}).get("queue_depth"),
            exhaustion_eta_s=fc.get("exhaustion_eta_s"))

    # ---- attribution -------------------------------------------------------
    def _charge_dispatch(self, dur_s, parts):
        """Charge one dispatch's measured wall time to its requests (no
        wire bytes: one unsharded engine moves none)."""
        if self._ledger is None or not parts:
            return
        self._ledger.charge_device(int(dur_s * 1e9), parts)

    def _attr_begin(self, pairs):
        """The cost rows [(tenant, rid, weight)] of the dispatch about to
        run, from (req, weight) pairs (weight: tokens fed, decoded or
        verified); also the target of a capture charged inside it.
        None with attribution off."""
        if self._ledger is None:
            return None
        parts = [(r.meta.tenant if r.meta is not None else "default",
                  r.rid, int(w)) for r, w in pairs]
        self._attr_parts = parts
        return parts

    # ---- causal tracing and SLOs -----------------------------------------
    def _tr(self, req):
        """The trace stamps (trace_id, hop, cause, replica) of one
        request's events, spans and flight-recorder entries."""
        t = req.trace
        if t is None:
            return {}
        return t.attrs(replica=self.trace_name)

    def _rattr(self):
        """The replica stamp of batch dispatch spans (empty off a
        fleet)."""
        return ({"replica": self.trace_name}
                if self.trace_name is not None else {})

    def _slo_latency(self, kind, value_s, req, n=1):
        """Feed one ttft/itl observation (caller checked _slo)."""
        meta = req.meta
        self._slo.observe(kind, value_s=value_s, n=n,
                          lane=meta.lane if meta is not None else None,
                          tenant=meta.tenant if meta is not None else None,
                          replica=self.trace_name)

    def _slo_avail(self, req, ok):
        """Feed one availability outcome: finished, or failed for good
        (quarantine, timeout, a failure with recovery off)."""
        if self._slo is None:
            return
        meta = req.meta
        self._slo.observe("availability", good=ok,
                          lane=meta.lane if meta is not None else None,
                          tenant=meta.tenant if meta is not None else None,
                          replica=self.trace_name)

    def _slo_goodput_round(self):
        """Per-round goodput feed: emitted vs decoded tokens since the
        last round (caller holds the lock and checked _slo)."""
        good0, dec0 = self._slo_good_mark
        good = max(0, self._tokens_out - good0)
        waste = max(0, (self._decoded_tokens - dec0)
                    - (self._tokens_out - good0))
        self._slo_good_mark = (self._tokens_out, self._decoded_tokens)
        if good or waste:
            self._slo.observe_counts("goodput", good, waste,
                                     replica=self.trace_name)

    def slo_report(self):
        """The /slo payload (`SLOEngine.report()`); the empty all-ok
        shape without SLOs."""
        if self._slo is None:
            return {"slos": [], "worst": "ok", "paging": []}
        return self._slo.report()

    def export_timeline(self, path):
        """Write this engine's Chrome/Perfetto timeline (the span sink
        and the flight-recorder ring) to `path`; returns the event
        count."""
        from ..observability import timeline as _timeline

        name = self.trace_name or "engine"
        return _timeline.write_chrome_trace(
            path, recorders={name: self._recorder.events()},
            default_name=name)

    # ---- tier prefetch-ahead ----------------------------------------------
    def _on_tier_event(self, kind, **fields):
        """The pool's tier callback -> flight recorder + trace event. A
        `tier_promote` batch (one chain walk of an attach or a prefetch
        tick) is its own event, so admission spans do not absorb
        promotion time; an overlapped (prefetch) batch also feeds the
        overlap histogram."""
        if kind == "demote":
            self._recorder.record("kv_tier_demote", **fields)
            _tracing.event("kv_tier_demote", **fields)
        elif kind == "tier_promote":
            if fields.get("overlapped"):
                dur = float(fields.get("dur_s", 0.0))
                _m_promote_overlap.observe(dur)
                with self._lock:
                    self._prefetch_overlap_s += dur
            if self._promote_ctx is not None:
                fields = dict(fields, request_id=self._promote_ctx)
            self._recorder.record("tier_promote", **fields)
            _tracing.event("tier_promote", **fields)
        else:
            self._recorder.record("kv_tier_promote", **fields)
            _tracing.event("kv_tier_promote", **fields)

    def _tier_prefetch_tick(self):
        """Promote the next queued requests' tiered blocks into the pool,
        right after a round's dispatch is issued, so the host-side tier
        work overlaps the device's. The promote walk is the one an
        attach would run, only earlier; a prefetched block reclaimed
        before admission re-promotes (or recomputes) on attach, with the
        same tokens. Budgeted by the free list only: prefetch fills idle
        capacity and never reclaims retained content."""
        if not self._prefetch_look or self.cache.tier is None:
            return
        with self._lock:
            if self._sched is not None:
                peek = getattr(self._sched, "peek", None)
                if peek is None:
                    return
                heads = [r for r in peek(time.perf_counter(),
                                         self._prefetch_look)
                         if r.rid not in self._prefetch_done]
            else:
                heads = [r for r in self._queue[:self._prefetch_look]
                         if r.rid not in self._prefetch_done]
        budget = self.cache.free_block_count
        for r in heads:
            if budget <= 0:
                break
            prompt = r.resume_ids if r.resume_ids is not None else r.ids
            hashes, _tokens, _nbytes = self.cache.prefetch_promote(
                prompt, limit_blocks=budget)
            if hashes:
                budget -= len(hashes)
                _m_prefetch_issued.inc(len(hashes))
                with self._lock:
                    self._prefetch_issued += len(hashes)
                    self._prefetched.setdefault(r.rid, set()).update(
                        hashes)
            else:
                # a dry walk: skip the rid until it settles, so an idle
                # queue does not re-hash long prompts every round
                with self._lock:
                    self._prefetch_done.add(r.rid)

    def _settle_prefetch_locked(self, rid):
        """At admission: prefetched blocks still in the device index are
        hits, those pool pressure reclaimed meanwhile are wasted. Caller
        holds the lock."""
        self._prefetch_done.discard(rid)
        pref = self._prefetched.pop(rid, None)
        if not pref:
            return
        hit = self.cache.device_resident_count(pref)
        wasted = len(pref) - hit
        self._prefetch_hits += hit
        self._prefetch_wasted += wasted
        if hit:
            _m_prefetch_hit.inc(hit)
        if wasted:
            _m_prefetch_wasted.inc(wasted)

    def _abandon_prefetch_locked(self, rid):
        """A queued request left unadmitted (timeout, stop): all that
        was prefetched for it is wasted (the blocks stay in retention).
        Caller holds the lock."""
        self._prefetch_done.discard(rid)
        pref = self._prefetched.pop(rid, None)
        if pref:
            self._prefetch_wasted += len(pref)
            _m_prefetch_wasted.inc(len(pref))

    # ---- health and the operations plane ---------------------------------
    def _ops_in_flight(self):
        """True while the engine has live work: busy slots or queued
        requests. Read lock-free from the watchdog and capture-tracker
        threads (staleness only delays detection by one poll)."""
        if self._stop:
            # a stopped or killed engine never dispatches again (kill()
            # leaves its slots occupied on purpose): never in flight
            return False
        if any(s is not None for s in self._slots) or self._queue:
            return True
        if self._sched is not None:
            try:
                return self._sched.depth() > 0
            except Exception:  # noqa: BLE001 — a torn-down scheduler
                return False   # must not break health checks
        return False

    def _on_compile_event(self, ev):
        # a finished capture IS progress: without this, the dispatch
        # that captured reads as a stall to the watchdog (a capture that
        # itself outlasts the threshold still trips)
        self._ops_progress += 1
        self._recorder.record(
            "compile", program=ev["program"],
            dur_s=round(ev["dur_s"], 4), in_flight=ev["in_flight"],
            shard=ev["shard"])
        # attribution: a capture inside a dispatch is charged to the
        # requests that dispatch computed for (its time is already in
        # the dispatch's measured time: a parallel account, not a part)
        if self._ledger is not None and self._attr_parts:
            self._ledger.charge_compile(int(ev["dur_s"] * 1e9),
                                        self._attr_parts)

    def _on_stall(self):
        self._recorder.record("stall", progress=self._ops_progress,
                              free_blocks=self.cache.available_block_count)
        if self._recorder.enabled:
            self._recorder.dump(trigger="stall")

    def health(self):
        """(status, detail) for /healthz: "stalled" while the watchdog
        sees pending work with no dispatch progress (503), "degraded"
        after a dispatch exception until a clean recovery (the first
        successful dispatch after it) or reset_stats(); the detail then
        carries the reason it recovered from and when."""
        detail = {
            "engine_running": self._thread is not None,
            "progress": self._ops_progress,
            "stalls": self._watchdog.stalls if self._watchdog else 0,
        }
        if self._last_recovery is not None:
            detail["last_recovery"] = dict(self._last_recovery)
        if self._watchdog is not None and self._watchdog.stalled:
            detail["stall_timeout_s"] = self.stall_timeout_s
            return "stalled", detail
        if self._last_error is not None:
            detail["last_error"] = self._last_error
            detail["degraded_reason"] = self._last_error
            if self._last_error_info is not None:
                detail["last_error_info"] = dict(self._last_error_info)
            return "degraded", detail
        return "ok", detail

    def liveness(self):
        """(live, detail) for /healthz/live: the engine loop is alive
        (started, not stopped, thread running). Degraded or stalled is
        still live."""
        alive = (not self._stop and self._thread is not None
                 and self._thread.is_alive())
        return alive, {"engine_running": alive, "stopped": self._stop,
                       "progress": self._ops_progress}

    def readiness(self):
        """(ready, detail) for /healthz/ready: alive AND accepting
        admissions (not draining, not stalled). `warmed` says whether
        `warm_buckets` ran."""
        alive, detail = self.liveness()
        stalled = self._watchdog is not None and self._watchdog.stalled
        ready = alive and not stalled and not self._draining
        detail = dict(detail, stalled=stalled, draining=self._draining,
                      warmed=self._warm_ran,
                      queue_depth=self._queue_depth_locked())
        return ready, detail

    def set_draining(self, draining=True):
        """Mark the engine drain-only: /healthz/ready answers 503 while
        residents keep decoding. Returns self."""
        self._draining = bool(draining)
        self._recorder.record("draining", draining=self._draining)
        return self

    def statusz(self):
        """Live JSON engine state for /statusz: per-slot residency, the
        three health views, stats() and the flight recorder's summary."""
        with self._lock:
            slots = []
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                meta = s["req"].meta
                slots.append({
                    "slot": i, "request_id": s["req"].rid,
                    "seq": s["seq"], "prompt_len": int(s["prompt"].size),
                    "fed": int(s["fed"]), "tokens": len(s["toks"]),
                    "budget": s["budget"],
                    "phase": ("decode" if s["fed"] >= s["prompt"].size
                              else "prefill"),
                    "lane": meta.lane if meta else None,
                    "tenant": meta.tenant if meta else None,
                })
        status, detail = self.health()
        live, live_detail = self.liveness()
        ready, ready_detail = self.readiness()
        return {
            "server": "paged",
            "health": {"status": status, **detail},
            "liveness": {"live": live, **live_detail},
            "readiness": {"ready": ready, **ready_detail},
            "slots": slots,
            "max_slots": self.max_slots,
            "engine": self.stats(),
            "flight_recorder": self._recorder.stats(),
            "last_dump": self._recorder.last_dump,
        }

    def dump_flight_recorder(self):
        """Manual flight-recorder dump (a stall or a dispatch exception
        dumps automatically)."""
        return self._recorder.dump(trigger="manual")

    def warm_buckets(self, modes=((False, False),)):
        """Capture, before `start()`, every CUDA graph the loop can
        reach for the given sampling modes ((any sampled, any
        penalties) pairs), so live traffic never pays a capture: the
        decode graph (`steps_per_dispatch`, max_slots rows), with
        speculation the verify graph (its pinned plan shape), and in the
        unified loop the window graph of every row count P (powers of
        two up to max_slots). Each is captured through ONE all-padding
        dispatch (positions -1 and empty tables: every write lands in
        the trash block; no sequence, sampling or cache state changes).
        The packed prefill and the mixed unified rounds are eager and
        unbucketed here (ROADMAP §C 8), so they have nothing to warm.
        On the CPU nothing is captured. Returns the graphs captured;
        sets `warmed` in readiness()."""
        if self._thread is not None:
            raise RuntimeError(
                "warm_buckets must run before start() (the engine loop "
                "owns the cache once it is running)")
        n = 0
        if self._graphs_on:
            dec = self._decoder
            c0 = dec.graphs.captures
            S, W, K1 = self.max_slots, self._uk1, self._uk1
            kc, vc = self.cache.k_blocks, self.cache.v_blocks

            def z(*shape):
                return torch.zeros(shape, dtype=torch.int32,
                                   device=self.device)

            def neg(*shape):
                return torch.full(shape, -1, dtype=torch.int32,
                                  device=self.device)

            for mode in modes:
                mode = (bool(mode[0]), bool(mode[1]))
                if not self._unified:
                    dec.graphs(self.steps_per_dispatch, mode, self._params,
                               z(S), z(S),
                               torch.zeros((S,), dtype=torch.bool,
                                           device=self.device),
                               z(S, self._m_width), kc, vc,
                               self._sp_store.warm_step_args(mode))
                    if self._drafter is not None:
                        P = 1
                        while P < S:
                            P *= 2
                        dec.graphs.verify(
                            mode, self._params, z(P * W), z(P * W),
                            neg(P * W), z(P, self._m_width), z(P, K1),
                            neg(P), kc, vc,
                            self._sp_store.warm_unified_args(P, mode))
                    continue
                P = 1
                while True:
                    T = P * W
                    dec.graphs.unified(
                        mode, self._params, z(T), z(T), neg(T),
                        z(P, self._m_width), z(P, K1), neg(P), neg(P),
                        neg(T), neg(T), neg(P), z(S), z(S), z(S), kc, vc,
                        self._sp_store.warm_unified_args(P, mode))
                    if P >= S:
                        break
                    P *= 2
            torch.cuda.synchronize(self.device)
            n = dec.graphs.captures - c0
        _logger.info("warm_buckets: captured %d graphs (%d modes)", n,
                     len(modes))
        self._warm_ran = True
        return n

    # ---- reliability -------------------------------------------------------
    def _engine_exception(self, where, e, request_ids=()):
        """Shared dispatch-exception bookkeeping: health goes degraded
        (until a clean recovery or reset_stats), the exception counts by
        dispatch kind, and the flight recorder auto-dumps."""
        self._last_error = f"{where}: {type(e).__name__}: {e}"
        info = {"where": where, "error_type": type(e).__name__,
                "message": str(e)}
        if isinstance(e, BlockPoolExhausted):
            info["needed"] = e.needed
            info["available"] = e.available
        self._last_error_info = info
        _m_engine_exc.labels(where=where).inc()
        self._recorder.record("engine_exception", where=where,
                              error=self._last_error,
                              request_ids=list(request_ids))
        if self._recorder.enabled:
            self._recorder.dump(trigger="engine_exception")

    def _maybe_fault(self, seam):
        """Deterministic fault-injection point: one `is None` check
        with no plan; otherwise poll the plan's seam x occurrence
        schedule and turn a scheduled fault into its effect (raise,
        simulated pool exhaustion, or a watchdog-visible sleep)."""
        plan = self._faults
        if plan is None:
            return
        f = plan.poll(seam)
        if f is None:
            return
        with self._lock:
            self._faults_injected += 1
        _m_fault_injected.labels(seam=seam).inc()
        self._recorder.record("fault_injected", seam=seam, kind=f.kind,
                              occurrence=f.index)
        _tracing.event("fault_injected", seam=seam, kind=f.kind,
                       occurrence=f.index)
        if f.kind == "slow":
            time.sleep(f.delay_s)
            return
        if f.kind == "exhausted":
            raise BlockPoolExhausted(
                f"injected fault at seam '{seam}' (occurrence "
                f"{f.index}): simulated pool exhaustion")
        raise plan.make_fault(f)

    def _release_slot(self, i):
        """Free slot i: its blocks back to the pool, its reservation and
        its sampling row dropped. Returns the slot's state."""
        s = self._slots[i]
        if self.cache.has_seq(s["seq"]):
            self.cache.free(s["seq"])
        self._worst.pop(s["seq"], None)
        self._slots[i] = None
        self._sp_store.clear_slot(i)
        return s

    def _recover_slot(self, i, where):
        """Snapshot one implicated slot for retry: roll its sequence back
        to the DURABLE length (positions completed dispatches wrote: the
        failed dispatch may have grown the table past them), publish
        that prefix through `swap_out_seq` when prefix caching is on
        (else free it), free the slot and return the request with its
        resume state. None when the slot already emptied."""
        s = self._slots[i]
        if s is None:
            return None
        seq, req = s["seq"], s["req"]
        toks = s["toks"]
        in_decode = s["fed"] >= s["prompt"].size
        durable = (s["pos"] + len(toks) - 1 if in_decode and toks
                   else int(s["fed"]))
        known = (np.concatenate([req.ids, np.asarray(toks, np.int32)])
                 if toks else req.ids)
        if self.cache.has_seq(seq):
            live = self.cache.seq_len(seq)
            durable = max(0, min(live, durable))
            if durable < live:
                self.cache.truncate_seq(seq, durable)
            if self.enable_prefix_cache and durable > 0:
                self.cache.swap_out_seq(seq, known[:durable])
            else:
                self.cache.free(seq)
        self._worst.pop(seq, None)
        self._slots[i] = None
        self._sp_store.clear_slot(i)
        req.gen0 = tuple(toks)
        req.resume_ids = known
        if req.trace is not None:
            # a fault-retry requeue starts a new hop: the next
            # residency's events carry hop + 1, cause "retry"
            req.trace = req.trace.child("retry")
        self._recorder.record(
            "recover_requeue", request_id=req.rid, slot=i, seq=seq,
            where=where, tokens_done=len(toks), durable=int(durable),
            **self._tr(req))
        _tracing.event("recover_requeue", request_id=req.rid, slot=i,
                       seq=seq, where=where, **self._tr(req))
        return req

    def _quarantine_slot(self, i, where, e, failures):
        """Give up on ONE request: fail its future with a diagnostic
        naming the seam, free its slot and blocks. Co-residents are
        untouched."""
        s = self._release_slot(i)
        req = s["req"]
        err = QuarantinedRequest(req.rid, where, failures, e)
        with self._lock:
            self._quarantined += 1
        _m_quarantined.inc()
        if self._journal is not None:
            self._journal.record_done(req.rid, "quarantined")
        self._recorder.record("quarantine", request_id=req.rid, slot=i,
                              seq=s["seq"], seam=where, failures=failures,
                              error=f"{type(e).__name__}: {e}",
                              **self._tr(req))
        cost = (self._ledger.request_done(req.rid)
                if self._ledger is not None else None)
        _tracing.event("quarantined", request_id=req.rid, slot=i,
                       seam=where, failures=failures, cost=cost,
                       **self._tr(req))
        self._slo_avail(req, False)
        _logger.error("quarantined request %s after %d consecutive "
                      "failure(s) at seam %s: %s", req.rid, failures,
                      where, e)
        req.future.set_exception(err)

    def _dispatch_failure(self, where, e, slot_idx):
        """A dispatch raised. With recovery off: every request in it
        fails with `e` (the old blast radius). With the ladder: process
        the async round in flight first (its tokens are real), snapshot
        and requeue every implicated request at the FRONT of the queue,
        quarantine at most ONE whose consecutive-failure streak reached
        the policy's threshold (highest streak, lowest slot on ties),
        drop the dispatch state (the carry, the pending round) and back
        off before the loop retries."""
        rids = [self._slots[i]["req"].rid for i in slot_idx
                if self._slots[i] is not None]
        self._engine_exception(where, e, rids)
        _logger.error("dispatch %s failed for slots %s: %s: %s", where,
                      list(slot_idx), type(e).__name__, e)
        if self._recovery is None:
            for i in slot_idx:
                if self._slots[i] is None:
                    continue
                s = self._release_slot(i)
                if self._journal is not None:
                    self._journal.record_done(s["req"].rid, "failed")
                self._slo_avail(s["req"], False)
                if self._ledger is not None:
                    self._ledger.request_done(s["req"].rid)
                s["req"].future.set_exception(e)
            return
        pol = self._recovery
        self._drain_pending()
        with self._lock:
            self._dispatch_retries += 1
            self._consec_failures += 1
            consec = self._consec_failures
        _m_dispatch_retries.inc()
        live = [i for i in slot_idx if self._slots[i] is not None]
        for i in live:
            rid = self._slots[i]["req"].rid
            self._fault_streak[rid] = self._fault_streak.get(rid, 0) + 1
        suspects = [i for i in live
                    if self._fault_streak[self._slots[i]["req"].rid]
                    >= pol.quarantine_after]
        if suspects:
            victim = max(suspects, key=lambda i: (
                self._fault_streak[self._slots[i]["req"].rid], -i))
            streak = self._fault_streak.pop(
                self._slots[victim]["req"].rid)
            self._quarantine_slot(victim, where, e, streak)
            live.remove(victim)
        requeued = [r for r in (self._recover_slot(i, where) for i in live)
                    if r is not None]
        with self._lock:
            if self._sched is not None:
                now = time.perf_counter()
                for req in reversed(requeued):  # requeue() prepends
                    self._sched.requeue(req, now)
            else:
                for req in reversed(requeued):
                    self._queue.insert(0, req)
                _m_queue_depth.labels(server="paged").set(len(self._queue))
            self._lock.notify()
        # the device chain may name freed slots: reseed from the host
        self._pending = None
        self._carry = None
        delay = pol.backoff_s(consec)
        if delay > 0:
            with self._lock:
                if not self._stop:
                    self._lock.wait(timeout=delay)

    def _dispatch_ok(self, slots):
        """Success bookkeeping of the ladder: reset the failure streaks
        of the requests in the dispatched `slots` (an iterable, walked
        only after a failure); the first success after >= 1 failure is
        a CLEAN RECOVERY (health degraded -> ok, counted and
        timestamped)."""
        if self._recovery is None or (self._consec_failures == 0
                                      and not self._fault_streak):
            return
        for i in slots:
            if self._slots[i] is not None:
                self._fault_streak.pop(self._slots[i]["req"].rid, None)
        if not self._consec_failures:
            return
        with self._lock:
            self._last_recovery = {
                "ts": time.time(),
                "recovered_from": self._last_error,
                "failures": self._consec_failures,
            }
            self._consec_failures = 0
            self._recoveries += 1
            self._last_error = None
            self._last_error_info = None
        _m_recoveries.inc()
        self._recorder.record(
            "recovered", failures=self._last_recovery["failures"],
            recovered_from=self._last_recovery["recovered_from"])
        _tracing.event("recovered",
                       failures=self._last_recovery["failures"])
        _logger.warning("engine recovered after %d failed dispatch(es): "
                        "%s", self._last_recovery["failures"],
                        self._last_recovery["recovered_from"])

    def _fail_timeout_req(self, req, now):
        """Fail one expired request (already detached from the queue or
        its slot). Caller holds the lock."""
        self._abandon_prefetch_locked(req.rid)
        self._timeouts += 1
        _m_timeouts.inc()
        if self._journal is not None:
            self._journal.record_done(req.rid, "timeout")
        self._recorder.record("request_timeout", request_id=req.rid,
                              waited_s=round(now - req.t_submit, 4),
                              timeout_s=req.timeout_s, **self._tr(req))
        cost = (self._ledger.request_done(req.rid)
                if self._ledger is not None else None)
        _tracing.event("request_timeout", request_id=req.rid,
                       waited_s=now - req.t_submit, cost=cost,
                       **self._tr(req))
        self._slo_avail(req, False)
        req.future.set_exception(RequestTimeout(
            req.rid, now - req.t_submit, req.timeout_s))

    def _expire_timeouts_locked(self, now):
        """Cancel every queued or resident request past its timeout_s.
        SLOT-FREEING: a resident's blocks return to the pool at once.
        Caller holds the lock."""
        def dead(r):
            return (r.timeout_s is not None
                    and now - r.t_submit > r.timeout_s)

        expired = [r for r in self._queue if dead(r)]
        if expired:
            for r in expired:
                self._queue.remove(r)
            _m_queue_depth.labels(server="paged").set(len(self._queue))
        if self._sched is not None:
            exp = getattr(self._sched, "expire", None)
            if exp is not None:
                expired.extend(exp(now, dead))
        for r in expired:
            self._fail_timeout_req(r, now)
        if any(s is not None and dead(s["req"]) for s in self._slots):
            self._drain_pending()  # async: host state goes authoritative
            for i, s in enumerate(self._slots):
                if s is None or not dead(s["req"]):
                    continue
                self._release_slot(i)
                self._fail_timeout_req(s["req"], now)

    def _retry_after_hint_locked(self, depth):
        """Estimated seconds until the queue drains one admission wave:
        the AdmissionShed hint."""
        lat = sorted(self._lat)
        p50 = lat[len(lat) // 2] if lat else 0.25
        waves = -(-int(depth) // max(1, self.max_slots))
        return max(0.05, p50) * max(1, waves)

    # ---- the journal -------------------------------------------------------
    def recover_from_journal(self, journal=None):
        """Re-admit every accepted-but-unfinished request recorded in
        `journal` (default: the server's own) from its recorded prompt,
        emitted tokens, seed, budget and sampling. A request whose
        recorded tokens already satisfy a stop condition resolves at
        once. Returns {rid: Future}; call before or after start()."""
        j = journal if journal is not None else self._journal
        if j is None:
            raise ValueError("no journal: pass one or build the "
                             "server with journal=")
        out = {}
        for ent in j.interrupted():
            if ent.get("trace"):
                # a crash-restart re-admission is a new hop of the SAME
                # trace (cause "retry")
                ent = dict(ent)
                ent["trace"] = TraceContext.from_dict(
                    ent["trace"]).child("retry").to_dict()
            out[ent["rid"]] = self.admit_journal_entry(ent)
        return out

    def admit_journal_entry(self, ent, on_token=None):
        """Re-admit ONE journal-shape entry (rid, ids, gen0, budget,
        seed, sampling, timeout_s, meta, trace; what
        `SessionJournal.interrupted()` yields) and return its Future. `on_token` streams the REMAINING
        tokens only."""
        req = self._build_resume_req(ent)
        req.on_token = on_token
        done = self._journal_terminal_reason(req)
        if done is not None:
            # the interruption lost only the terminal record
            if self._journal is not None:
                self._journal.record_done(req.rid, done)
            req.future.set_result(np.concatenate(
                [req.ids, np.asarray(req.gen0, np.int32)])
                if req.gen0 else req.ids.copy())
            return req.future
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            if self._sched is not None:
                self._sched.on_submit(req, time.perf_counter())
            else:
                self._queue.append(req)
                _m_queue_depth.labels(server="paged").set(len(self._queue))
            if self._journal is not None:
                # re-accept with gen0 folded in, so a second crash
                # resumes from here
                self._journal.record_accept(req)
            self._lock.notify()
        self._recorder.record("journal_readmit", request_id=req.rid,
                              tokens_done=len(req.gen0), **self._tr(req))
        _tracing.event("journal_readmit", request_id=req.rid,
                       tokens_done=len(req.gen0), **self._tr(req))
        return req.future

    def _build_resume_req(self, ent):
        """One journal entry -> a resume-state `_Req` (not through
        submit(): the recorded seed must win over auto-derivation)."""
        sampling = (SamplingParams(**{k: tuple(v) if isinstance(v, list)
                                      else v
                                      for k, v in ent["sampling"].items()})
                    if ent.get("sampling") else self._default_sampling)
        if sampling.stop_strings and self._detok is None:
            raise ValueError(
                f"journal request {ent['rid']!r} uses stop_strings but "
                f"this server has no detokenizer (pass detokenize=)")
        meta = None
        if ent.get("meta"):
            m = ent["meta"]
            meta = RequestMeta(lane=m.get("lane", "interactive"),
                               tenant=m.get("tenant", "default"),
                               deadline_s=m.get("deadline_s"),
                               cost=int(m.get("cost", 0)))
        # the entry's trace context carries the trace across restarts;
        # an entry without one starts a fresh trace
        req = _Req(ids=np.asarray(ent["ids"], np.int32), future=Future(),
                   t_submit=time.perf_counter(), budget=int(ent["budget"]),
                   sampling=sampling, seed=int(ent["seed"]),
                   rid=ent["rid"], timeout_s=ent.get("timeout_s"),
                   meta=meta,
                   trace=(TraceContext.from_dict(ent["trace"])
                          if ent.get("trace") else TraceContext.mint()))
        gen0 = [int(t) for t in ent.get("gen0", [])]
        if gen0:
            req.gen0 = tuple(gen0)
            req.resume_ids = np.concatenate(
                [req.ids, np.asarray(gen0, np.int32)])
        if req.timeout_s is not None:
            self._any_timeouts = True
        return req

    def _journal_terminal_reason(self, req):
        """The stop reason a journal-recovered request's recorded tokens
        already satisfy (the crash lost only the terminal record), or
        None."""
        if not req.gen0:
            return None
        if len(req.gen0) >= req.budget:
            return "budget"
        last = int(req.gen0[-1])
        sp = req.sampling
        if self.eos >= 0 and last == self.eos:
            return "eos"
        if sp is not None and last in getattr(sp, "stop_token_ids", ()):
            return "stop_token"
        if sp is not None and sp.stop_strings and self._detok is not None:
            tail = self._detok(list(req.gen0)[-self.stop_tail_tokens:])
            if any(s in tail for s in sp.stop_strings):
                return "stop_string"
        return None

    # ---- fleet hooks -------------------------------------------------------
    def _run_host_ops_locked(self):
        """Run the queued host ops on the engine thread (the caller holds
        the lock and has drained the round in flight): between round
        boundaries nothing else touches the pool."""
        ops, self._host_ops = self._host_ops, []
        for fn, fut in ops:
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — the op's error
                fut.set_exception(e)    # belongs to its caller

    def _fail_host_ops_locked(self, exc):
        ops, self._host_ops = self._host_ops, []
        for _fn, fut in ops:
            if not fut.done():
                fut.set_exception(exc)

    def run_host_op(self, fn, timeout=None):
        """Run `fn()` on the engine thread at the next round boundary
        (under the engine lock, any async round drained) and return its
        result: the safe way for another thread to touch the pool's
        tensors (migration export and import). On a server that has not
        started, `fn` runs inline. Never call it from an engine callback
        (on_token, the scheduler): that deadlocks."""
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            if self._thread is None:
                return fn()
            f = Future()
            self._host_ops.append((fn, f))
            self._lock.notify()
        return f.result(timeout=timeout)

    def export_session(self, rid, include_kv=True):
        """Planned-migration source hook: detach one request, resident
        (swapped out as a preemption is, its live K/V published through
        the prefix index when caching is on) or still queued, and return
        `(entry, kv_payload)`. `entry` is the journal-shape resume state
        `admit_journal_entry` re-admits on the target; `kv_payload` is
        `PagedKVCache.export_prefix` of the swapped-out chain (None when
        caching is off, the request never prefilled, or
        include_kv=False): imported on the target, the session resumes
        with no prefill recompute. The request's future here is
        abandoned (the router owns the client's future) and its journal
        entry closes with reason "migrated". Raises KeyError for an
        unknown or finished rid."""
        def out(req, payload):
            ent = SessionJournal.entry_for(req)
            if payload is not None and self._ledger is not None:
                # migration wire bytes, charged at the source to the
                # departing session's tenant
                nbytes = (payload_nbytes(payload["k"])
                          + payload_nbytes(payload["v"]))
                tenant = req.meta.tenant if req.meta is not None \
                    else "default"
                self._ledger.charge_wire(nbytes, [(tenant, req.rid, 1)],
                                         kind="migration")
            if self._journal is not None:
                self._journal.record_done(rid, "migrated")
            if self._ledger is not None:
                # the session leaves this replica: close its request
                # view (the tenant's window totals stay)
                self._ledger.request_done(rid)
            self._recorder.record(
                "migrate_out", request_id=rid, tokens_done=len(req.gen0),
                kv_tokens=len(payload["tokens"]) if payload else 0,
                **self._tr(req))
            _tracing.event("migrate_out", request_id=rid,
                           tokens_done=len(req.gen0), **self._tr(req))
            return ent, payload

        def op():
            for i, s in enumerate(self._slots):
                if s is not None and s["req"].rid == rid:
                    req = self._preempt_slot_locked(i, why="migration")
                    if req is None:
                        break  # the drain finished it
                    payload = None
                    if include_kv and self.enable_prefix_cache:
                        payload = self.cache.export_prefix(req.resume_ids)
                    return out(req, payload)
            req = None
            if self._sched is not None:
                hits = self._sched.expire(time.perf_counter(),
                                          lambda r: r.rid == rid)
                req = hits[0] if hits else None
            else:
                req = next((q for q in self._queue if q.rid == rid), None)
                if req is not None:
                    self._queue.remove(req)
                    _m_queue_depth.labels(server="paged").set(
                        len(self._queue))
            if req is None:
                raise KeyError(f"unknown or already-finished request "
                               f"{rid!r} in export_session()")
            return out(req, None)
        return self.run_host_op(op)

    def import_kv_payload(self, payload, owner=None):
        """Planned-migration target hook: install an `export_prefix`
        payload into this server's pool on the engine thread
        (`run_host_op`), so the following `admit_journal_entry`
        attaches it instead of prefilling. Returns the tokens imported;
        raises BlockPoolExhausted when the pool cannot hold the chain
        (the router then replays the journal). `owner` is the (tenant,
        rid) the imported blocks' residency is charged to here."""
        return self.run_host_op(
            lambda: self.cache.import_prefix(payload, owner=owner))

    # ---- admission -------------------------------------------------------
    def _outstanding_blocks(self, group=None):
        """Blocks the resident slots (of block group `group`, or all) may
        still demand in the worst case."""
        total = 0
        for i, slot in enumerate(self._slots):
            if slot is not None and (group is None
                                     or self._group_of(i) == group):
                held = self.cache.blocks_held(slot["seq"])
                total += max(0, self._worst[slot["seq"]] - held)
        return total

    def _group_of(self, i):
        """The pool block group slot i allocates in (0 without dp)."""
        return 0 if self._slot_groups is None else self._slot_groups[i]

    def _room(self, i):
        """Blocks the reservation can still promise a request in slot i:
        its group's obtainable blocks less its residents' worst case."""
        g = self._group_of(i)
        if self._slot_groups is None:
            return self.cache.available_block_count \
                - self._outstanding_blocks()
        return self.cache.available_in(g) - self._outstanding_blocks(g)

    def _worst_blocks(self, req):
        """Worst-case block reservation for `req` (prompt + budget + the
        multi-step, speculative and async overrun), plus one spare block
        for the (at most one) copy-on-write a prefix attach ending
        mid-block can force. A resumed request's resume prompt replaces
        the prompt and its emitted tokens come off the budget: the same
        total."""
        prompt = req.resume_ids if req.resume_ids is not None else req.ids
        remaining = req.budget - len(req.gen0)
        return blocks_for(prompt.size + remaining + self._overrun,
                          self.block_size) + (
            1 if self.enable_prefix_cache else 0)

    def _install_slot_locked(self, i, req, worst):
        """Bind `req` to slot `i` (the caller checked the reservation). A
        resumed request's slot is re-seeded with its emitted tokens and
        its resume prompt, so every position, PRNG-step and budget
        formula downstream is residency-invariant."""
        seq = self._seq_counter
        self._seq_counter += 1
        self._worst[seq] = worst
        if self._slot_groups is not None:
            self.cache.set_seq_group(seq, self._group_of(i))
        tenant = req.meta.tenant if req.meta is not None else "default"
        if self._ledger is not None:
            # tag the sequence BEFORE any block is taken: every growth
            # under this seq charges this (tenant, rid)
            self.cache.set_seq_owner(seq, tenant, req.rid)
        prompt = req.resume_ids if req.resume_ids is not None else req.ids
        # prefix caching: attach the longest cached chain; those tokens
        # count as fed and the prefill starts at the first uncached one
        cached = 0
        if self.enable_prefix_cache:
            # prefetch settlement FIRST (a hit is a block still resident
            # now: the attach below re-publishes walked hashes), then
            # stamp the request id on any tier_promote the attach fires
            self._settle_prefetch_locked(req.rid)
            self._promote_ctx = req.rid
            try:
                cached = self.cache.attach_prefix(seq, prompt)
            finally:
                self._promote_ctx = None
            if cached and self._ledger is not None:
                # the attacher's saved recompute, credited at the
                # measured prefill cost a token (the publisher keeps
                # paying the blocks' residency)
                self._ledger.credit_prefix(tenant, req.rid, cached)
        # WARM RESUME: every position but the last attached, and at
        # least one token emitted before the interruption. The slot is a
        # decode slot already: its last emitted token is the decode
        # input, position size - 1 the one position to write, the PRNG
        # step len(gen0). It rejoins the next decode dispatch with no
        # prefill.
        warm = (req.resume_ids is not None and bool(req.gen0)
                and cached >= prompt.size - 1)
        if warm:
            # the write block may still be shared with the prefix the
            # swap-out published: privatize it first
            self.cache.prepare_write(seq, prompt.size - 1)
        # fed: prompt tokens already written to the cache — the slot is
        # in its PREFILL phase until fed == prompt length, then decodes
        self._slots[i] = {"seq": seq, "req": req, "toks": list(req.gen0),
                          "prompt": prompt, "pos": req.ids.size,
                          "budget": req.budget,
                          "fed": prompt.size if warm else cached,
                          "cached": cached, "chunks": 0, "t_pre0": None,
                          "t_last": None}
        # penalty counts seed from the (resume) prompt: prompt counts +
        # generated counts, the uninterrupted run's buffer state
        self._sp_store.set_slot(i, req.sampling, req.seed, eos=self.eos,
                                prompt_ids=prompt)
        if req.resume_ids is not None:
            self._resumes += 1
            if warm:
                self._warm_resumes += 1
            _m_resumes.inc()
            _tracing.event("resumed", request_id=req.rid, slot=i, seq=seq,
                           cached_tokens=cached,
                           tokens_done=len(req.gen0), warm=warm,
                           **self._tr(req))
        if warm and self._async:
            # the slot joins the next decode dispatch directly: its carry
            # entry must hold its host-known state
            self._seed_carry_slot(i)
        _m_slot_refills.inc()
        self._ops_progress += 1
        self._recorder.record(
            "admit", request_id=req.rid, slot=i, seq=seq,
            cached_tokens=cached, resume=req.resume_ids is not None,
            free_blocks=self.cache.available_block_count,
            **self._tr(req))
        _tracing.event("request_admitted", request_id=req.rid, slot=i,
                       seq=seq, cached_tokens=cached, **self._tr(req))

    def _preempt_slot_locked(self, i, why="pressure"):
        """Evict slot `i` mid-flight: publish its live K/V through the
        prefix-cache index when caching is on (the blocks park in
        retention, so the resume re-prefills about one token unless pool
        pressure reclaimed them), else free it, and hand the request
        back with its tokens so far as resume state (`gen0`,
        `resume_ids`). Runs between dispatches only. Async: the round in
        flight is processed first, so the victim's token list and its
        K/V are authoritative; that may finish the victim, and then
        there is nothing to evict and this returns None. The freed slot
        is an idle row of the next decode graph replay (ctx 1 on the
        trash block, like any idle slot)."""
        self._drain_pending()
        s = self._slots[i]
        if s is None:
            return None
        seq, req = s["seq"], s["req"]
        known = (np.concatenate([req.ids, np.asarray(s["toks"], np.int32)])
                 if s["toks"] else req.ids)
        cached = 0
        if self.cache.has_seq(seq):  # a never-prefilled slot owns none
            if self.enable_prefix_cache:
                cached = self.cache.swap_out_seq(seq, known)
            else:
                self.cache.free(seq)
        self._worst.pop(seq, None)
        self._slots[i] = None
        self._sp_store.clear_slot(i)
        req.gen0 = tuple(s["toks"])
        req.resume_ids = known
        req.preempts += 1
        self._preemptions += 1
        self._preempt_cached_tokens += cached
        _m_preemptions.labels(reason=why).inc()
        _m_preempt_cached.inc(cached)
        self._recorder.record(
            "preempt", request_id=req.rid, slot=i, seq=seq,
            tokens_done=len(s["toks"]), cached_tokens=cached, reason=why,
            **self._tr(req))
        _tracing.event("preempted", request_id=req.rid, slot=i, seq=seq,
                       tokens_done=len(s["toks"]), cached_tokens=cached,
                       reason=why, **self._tr(req))
        return req

    def _admit_locked(self):
        """Fill idle slots FIFO while the pool can cover each request's
        worst case; head-of-line blocking keeps arrival order under
        pressure. With a scheduler installed, `_admit_sched_locked`."""
        if self._sched is not None:
            self._admit_sched_locked()
            return
        admitted = False
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._queue:
                continue
            req = self._queue[0]
            worst = self._worst_blocks(req)
            if self._room(i) < worst:
                if self._slot_groups is None:
                    break
                continue  # dp: another group's idle slot may fit
            self._queue.pop(0)
            self._install_slot_locked(i, req, worst)
            admitted = True
        if admitted and _metrics.enabled():
            _m_queue_depth.labels(server="paged").set(len(self._queue))

    def _admit_sched_locked(self):
        """Scheduler-driven admission: take candidates in the policy's
        order (lane weights, EDF, tenant fair share, rate limits). A
        candidate short of a slot or of blocks may name preemption
        victims; each is swapped out and requeued, then the reservation
        is checked again. A lane whose candidate stays blocked is set
        aside for this pass (no cross-lane head-of-line blocking)."""
        blocked: set = set()
        while True:
            now = time.perf_counter()
            req = self._sched.next_request(now, blocked)
            if req is None:
                break
            worst = self._worst_blocks(req)

            def pick():
                # an idle slot, one whose block group fits if any does
                idle = [i for i, s in enumerate(self._slots) if s is None]
                return next((i for i in idle if self._room(i) >= worst),
                            idle[0] if idle else None)

            free_i = pick()

            def short():
                return self._room(free_i) < worst

            if free_i is None or short():
                # (slot, resident, remaining tokens): the remaining
                # budget feeds the policy's drain-wait hysteresis
                occupied = [(j, self._slots[j]["req"],
                             self._slots[j]["budget"]
                             - len(self._slots[j]["toks"]))
                            for j in range(self.max_slots)
                            if self._slots[j] is not None]
                for j in self._sched.victims(req, occupied, now):
                    victim = self._preempt_slot_locked(j)
                    if victim is not None:
                        self._sched.requeue(victim, now)
                    free_i = pick()
                    if free_i is not None and not short():
                        break
                if free_i is None or short():
                    blocked.add(getattr(req.meta, "lane", None))
                    continue
            self._sched.pop(req, now)
            self._install_slot_locked(free_i, req, worst)

    # ---- the loop --------------------------------------------------------
    def _loop(self):
        try:
            self._loop_body()
        except Exception as e:  # noqa: BLE001 — the engine thread's
            # boundary: an engine bug leaves a post-hoc record (health
            # degraded, the flight recorder dumps) and must not strand
            # callers on futures that never resolve
            self._engine_exception("engine_loop", e)
            _logger.exception("paged serving loop died")
            with self._lock:
                self._stop = True
                self._fail_host_ops_locked(e)
                reqs = [s["req"] for s in self._slots if s is not None]
                reqs += self._queue
                self._queue.clear()
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(e)

    def _loop_body(self):
        while True:
            with self._lock:
                stop = self._stop
                if not stop:
                    if self._host_ops:
                        # migration exports and imports run here, with
                        # the round in flight processed first: its
                        # write-back cannot overwrite an import
                        self._drain_pending()
                        self._run_host_ops_locked()
                    if self._any_timeouts:
                        self._expire_timeouts_locked(time.perf_counter())
                    self._admit_locked()
                    idle = all(s is None for s in self._slots)
                    if idle and self._pending is None:
                        self._lock.wait(timeout=0.1)
                        continue
            if stop:
                # async: resolve the round in flight, so no future is
                # left waiting on tokens the device already computed
                self._drain_pending()
                with self._lock:
                    self._fail_host_ops_locked(
                        RuntimeError("server stopped"))
                return
            if idle:
                self._drain_pending()
            elif self._unified:
                self._round_unified()
            else:
                self._round_split()

    def _note_round(self, n_dispatches, mixed):
        """Per-round dispatch accounting, both engine paths: `mixed`
        marks a round with prefill AND decode or verify work."""
        with self._lock:
            self._rounds += 1
            self._round_dispatch_count += n_dispatches
            if mixed:
                self._mixed_rounds += 1
            if self._slo is not None:
                self._slo_goodput_round()
        _m_round_dispatches.observe(float(n_dispatches))
        # min-interval gated: a no-op on almost every round
        self._maybe_sample_capacity()

    def _dispatches(self):
        return self._prefill_dispatches + self._steps + self._spec_dispatches

    def _round_split(self):
        """One scheduler round of the split path: at most one packed
        chunk-prefill dispatch, then one verify or one plain decode
        dispatch, so in-flight decode never stalls longer than one chunk
        budget."""
        d0 = self._dispatches()
        pre_idx = [i for i, s in enumerate(self._slots)
                   if s is not None and s["fed"] < s["prompt"].size]
        if pre_idx:
            self._prefill_packed(pre_idx)
        if _metrics.enabled():
            _m_slots_busy.labels(server="paged").set(
                sum(s is not None for s in self._slots))
        active_idx = [i for i, s in enumerate(self._slots)
                      if s is not None and s["fed"] >= s["prompt"].size]
        if active_idx:
            # speculation: when any slot proposes drafts, ONE verify
            # dispatch serves every decode-phase slot; otherwise (and
            # always with speculation off) the plain decode dispatch
            spec_slots = ()
            if self._drafter is not None:
                spec_slots = self._speculate(active_idx)
            plain_idx = [i for i in active_idx if i not in spec_slots
                         and self._slots[i] is not None]
            if plain_idx:
                self._decode_plain(plain_idx)
        # prefetch-ahead: promote the next queued requests' tiered
        # blocks before the coming admission pass attaches them
        self._tier_prefetch_tick()
        d1 = self._dispatches()
        if d1 > d0:
            self._note_round(d1 - d0,
                             mixed=bool(pre_idx) and bool(active_idx))

    def _tensor(self, a):
        return host_to_device(a, self.device)

    def _to_host(self, tensors):
        """Start copying a dispatch's outputs to the host: on the card
        into page-locked buffers by non-blocking copies, with an event
        after them (the outputs may be a graph's, overwritten by its
        next replay: the copies are queued before it). Returns what
        `_host_arrays` reads. The buffers are made per dispatch, so no
        failed dispatch leaves one behind."""
        if self.device.type != "cuda":
            return tuple(tensors), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    @staticmethod
    def _host_arrays(fetched):
        """Wait for `_to_host`'s copies; their numpy arrays."""
        host, ev = fetched
        if ev is not None:
            ev.synchronize()
        return tuple(h.numpy() for h in host)

    def _note_first_token(self, s, t_now):
        """A prompt's last chunk landed: TTFT (a resumed request keeps
        its first residency's), the prefix publish, the per-request
        prefill trace event."""
        req = s["req"]
        if req.ttft is None:
            req.ttft = t_now - req.t_submit
            _m_ttft.observe(req.ttft)
            if self._slo is not None:
                self._slo_latency("ttft", req.ttft, req)
            with self._lock:
                self._ttft.append(req.ttft)
                meta = req.meta
                if meta is not None:
                    lane = meta.lane
                    self._lane_ttft.setdefault(lane, []).append(req.ttft)
                    if meta.deadline_s is not None:
                        self._deadline_requests[lane] = \
                            self._deadline_requests.get(lane, 0) + 1
                        if req.ttft > meta.deadline_s:
                            self._deadline_misses[lane] = \
                                self._deadline_misses.get(lane, 0) + 1
                            _m_deadline_miss.labels(lane=lane).inc()
                            _m_deadline_overage.observe(
                                req.ttft - meta.deadline_s)
        if self.enable_prefix_cache:
            # every prompt position is written: index the blocks (a
            # resumed request publishes its resume prompt)
            self.cache.publish_prefix(s["seq"], s["prompt"])
        t_pre0 = s["t_pre0"] if s["t_pre0"] is not None else t_now
        _tracing.event("prefill", request_id=req.rid, ts=t_pre0,
                       dur=t_now - t_pre0, prompt_len=int(s["prompt"].size),
                       seq=s["seq"], chunks=s["chunks"],
                       cached_tokens=s["cached"], **self._tr(req))
        with self._lock:
            self._prefills += 1
        s["t_last"] = t_now

    @staticmethod
    def _replay_of(req, start, n):
        """Positions of a chunk [start, start + n) past the request's
        ORIGINAL prompt: emitted tokens a resume re-feeds (decoded work
        that emits nothing)."""
        if req.resume_ids is None:
            return 0
        return max(0, start + n - max(start, req.ids.size))

    def _prefill_entries(self, pre_idx, budget):
        """[(slot, chunk cap or None)] in chunk order: the scheduler's
        (interactive and EDF first, the interactive lane's share capped
        while batch prompts feed), else slot order uncapped. A cap only
        shortens a row's chunk: each row stays one segment."""
        if self._sched is not None and pre_idx:
            return self._sched.prefill_plan(
                [(i, self._slots[i]) for i in pre_idx], budget)
        return [(i, None) for i in pre_idx]

    def _prefill_packed(self, pre_idx):
        """ONE packed ragged prefill dispatch over up to
        prefill_chunk_tokens prompt tokens of the slots still feeding
        their prompts (slot order)."""
        align = self._pack_align
        # sp multiplies the chunk budget: each sp rank runs T/sp rows
        budget = self.prefill_chunk_tokens * self._sp_degree
        plan = []  # (slot_idx, start, n, packed_offset)
        off = 0
        for i, cap in self._prefill_entries(pre_idx, budget):
            if budget <= 0:
                break
            s = self._slots[i]
            n = min(s["prompt"].size - s["fed"], budget)
            if cap is not None:
                n = min(n, int(cap))
            if n <= 0:
                continue
            plan.append((i, s["fed"], n, off))
            off += -(-n // align) * align
            budget -= n
        if not plan:
            return
        T, P = off, len(plan)
        toks = np.zeros((T,), np.int32)
        seg = np.zeros((T,), np.int32)
        pos = np.full((T,), -1, np.int32)  # -1 marks packing pad
        sample_idx = np.zeros((P,), np.int32)
        base_steps = np.zeros((P,), np.int32)
        done_rows = []  # (slot_idx, plan_row)
        for r, (i, start, n, o) in enumerate(plan):
            s = self._slots[i]
            toks[o:o + n] = s["prompt"][start:start + n]
            seg[o:o + n] = r
            pos[o:o + n] = np.arange(start, start + n, dtype=np.int32)
            # a resumed request samples its next token at PRNG step
            # len(generated so far), where an uninterrupted decode would
            base_steps[r] = len(s["toks"])
            if s["t_pre0"] is None:
                s["t_pre0"] = time.perf_counter()
            if start + n == s["prompt"].size:
                sample_idx[r] = o + n - 1
                done_rows.append((i, r))
        in_plan = {p[0] for p in plan}
        decoding = any(s is not None and j not in in_plan
                       and s["fed"] >= s["prompt"].size
                       for j, s in enumerate(self._slots))
        n_tok = int(sum(p[2] for p in plan))
        if self._recorder.enabled:
            self._recorder.record(
                "prefill_chunk", packed=int(T), rows=len(plan),
                tokens=n_tok, free_blocks=self.cache.available_block_count)
        if self._sp_degree > 1:
            self._note_sp_peak(T)
        parts = self._attr_begin(
            (self._slots[i]["req"], n) for i, _start, n, _o in plan)
        t0 = time.perf_counter()
        try:
            with _dispatch_span(
                    "prefill_chunk",
                    (self._slots[i]["req"].rid for i, *_ in plan),
                    packed=T, segments=len(plan), tokens=n_tok,
                    **self._rattr()):
                self._maybe_fault("slow_dispatch")
                self._maybe_fault("ensure_many")
                # the whole plan's tables grow atomically (reservation-
                # backed, so this cannot exhaust the pool mid-plan)
                self.cache.ensure_many(
                    [(self._slots[i]["seq"], start + n)
                     for i, start, n, _ in plan])
                if self.enable_prefix_cache:
                    # copy-on-write: a chunk starting in an attached
                    # (shared or index-claimed) block writes to a copy
                    for i, start, _n, _o in plan:
                        self.cache.prepare_write(self._slots[i]["seq"],
                                                 start)
                width = max(blocks_for(start + n, self.block_size)
                            for _, start, n, _ in plan)
                tables = self._tensor(self.cache.table_array(
                    [self._slots[i]["seq"] for i, *_ in plan], width))
                # token-0 sampling runs the decode pipeline at the row's
                # PRNG base step
                done_set = {r for _, r in done_rows}
                sp, mode = self._sp_store.packed_args(
                    [i for i, *_ in plan], [r in done_set for r in range(P)],
                    base_steps)
                self._maybe_fault("prefill")
                tok, stopped, _kc, _vc, counts = \
                    self._decoder.packed_prefill(
                        self._params, self._tensor(toks), self._tensor(seg),
                        self._tensor(pos), tables,
                        self._tensor(sample_idx), self.cache.k_blocks,
                        self.cache.v_blocks, sp, mode)
                self._sp_store.swap_counts(counts)
                tok_h = tok.cpu().numpy()
                stopped_h = stopped.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the recovery ladder (or,
            # with recovery off, fail this chunk's requests)
            self._dispatch_failure("prefill", e, [i for i, *_ in plan])
            return
        self._dispatch_ok(i for i, *_ in plan)
        t_now = time.perf_counter()
        if parts:
            self._charge_dispatch(t_now - t0, parts)
            # the measured prefill cost a token: the rate prefix-cache
            # savings are credited at
            self._ledger.note_prefill_cost(int((t_now - t0) * 1e9), n_tok)
        self._ops_progress += 1
        if decoding:
            _m_decode_stall.observe(t_now - t0)
        _m_prefill_dispatches.inc()
        replay = sum(self._replay_of(self._slots[i]["req"], start, n)
                     for i, start, n, _o in plan)
        with self._lock:
            self._prefill_dispatches += 1
            self._decoded_tokens += replay + len(done_rows)
            self._replayed_tokens += replay
        _m_decoded.inc(replay + len(done_rows))
        if replay:
            _m_replayed.inc(replay)
        for i, start, n, _o in plan:
            self._slots[i]["fed"] = start + n
            self._slots[i]["chunks"] += 1
        for i, r in done_rows:
            self._note_first_token(self._slots[i], t_now)
            self._slot_token(i, int(tok_h[r]),
                             device_stopped=bool(stopped_h[r]))

    def _decode_plain(self, active_idx):
        """One decode dispatch (k tokens per slot with multi-step
        scheduling) for the decode-phase slots."""
        k = self.steps_per_dispatch
        tok = np.zeros((self.max_slots,), np.int32)
        pos = np.zeros((self.max_slots,), np.int32)
        act = np.zeros((self.max_slots,), bool)
        steps = np.zeros((self.max_slots,), np.int32)
        for i in active_idx:
            s = self._slots[i]
            tok[i] = s["toks"][-1]
            pos[i] = s["pos"] + len(s["toks"]) - 1
            act[i] = True
            steps[i] = len(s["toks"])  # the PRNG step counter
        # one dispatch serves the whole mixed batch; an all-greedy batch
        # takes the bare-argmax variant
        sp, mode = self._sp_store.step_args(steps)
        (_m_sampling_sampled if mode[0] else _m_sampling_fast).inc()
        with self._lock:
            if mode[0]:
                self._sampled_dispatches += 1
            else:
                self._fastpath_dispatches += 1
        if self._recorder.enabled:
            self._recorder.record(
                "decode_dispatch", slots=len(active_idx), k=k,
                sampled=bool(mode[0]),
                free_blocks=self.cache.available_block_count)
        parts = self._attr_begin(
            (self._slots[i]["req"], k) for i in active_idx)
        t0 = time.perf_counter()
        try:
            with _dispatch_span(
                    "decode_dispatch",
                    (self._slots[i]["req"].rid for i in active_idx), k=k,
                    **self._rattr()):
                self._maybe_fault("slow_dispatch")
                self._maybe_fault("ensure_many")
                # grow tables for the incoming token(s) BEFORE the step
                # writes them (k tokens starting at the feed position)
                self.cache.ensure_many(
                    [(self._slots[i]["seq"], self._slots[i]["pos"]
                      + len(self._slots[i]["toks"]) - 1 + k)
                     for i in active_idx])
                tables = self._tensor(self.cache.table_array(
                    [s["seq"] if s is not None else None
                     for s in self._slots], self._m_width))
                args = (self._params, self._tensor(tok), self._tensor(pos),
                        self._tensor(act), tables, self.cache.k_blocks,
                        self.cache.v_blocks, sp)
                self._maybe_fault("decode")
                if self._graphs_on:  # one graph replay, any k
                    toks, stopped, _kc, _vc, counts = self._decoder.graphs(
                        k, mode, *args)
                    with self._lock:
                        self._graph_replays += 1
                elif k == 1:
                    nxt, stopped, _kc, _vc, counts = self._decoder.step(
                        *args, mode)
                    toks, stopped = nxt[None], stopped[None]     # [1, S]
                else:
                    toks, stopped, _kc, _vc, counts = \
                        self._decoder.multistep(k, mode)(*args)
                toks = toks.cpu().numpy()                     # [k, S]
                stops = stopped.cpu().numpy()
                # the counts are copied out before the next dispatch (a
                # graph's outputs belong to its next replay)
                self._sp_store.swap_counts(counts)
        except Exception as e:  # noqa: BLE001 — the recovery ladder (or,
            # with recovery off, fail this dispatch's requests)
            self._dispatch_failure("decode", e, list(active_idx))
            return
        self._dispatch_ok(active_idx)
        t_now = time.perf_counter()
        if parts:
            self._charge_dispatch(t_now - t0, parts)
        self._ops_progress += 1
        decoded = toks.shape[0] * len(active_idx)
        with self._lock:
            self._steps += 1
            self._active_integral += len(active_idx)
            self._decoded_tokens += decoded
        _m_decoded.inc(decoded)
        discarded = 0
        for i in active_idx:  # tokens after a stop are discarded
            discarded += toks.shape[0] - self._emit_row(
                i, toks[:, i], stops[:, i], toks.shape[0], t_now)
        self._note_replayed(discarded)

    def _note_replayed(self, discarded):
        if discarded:
            with self._lock:
                self._replayed_tokens += discarded
            _m_replayed.inc(discarded)
        if _metrics.enabled():
            _m_goodput.set(self._tokens_out / (self._decoded_tokens or 1))

    # ---- speculation (split round) ---------------------------------------
    def _propose(self, s):
        """The drafter's proposal for slot state `s`: up to
        min(K, remaining budget - 1) tokens (with one token left a draft
        adds nothing), from the request's prompt + generated tokens."""
        kcap = min(self._spec_k, s["budget"] - len(s["toks"]) - 1)
        if kcap < 1:
            return np.empty((0,), np.int32)
        ctx = np.concatenate([s["req"].ids, np.asarray(s["toks"], np.int32)])
        return np.asarray(self._drafter.propose(ctx, kcap),
                          np.int32).reshape(-1)[:kcap]

    def _speculate(self, active_idx):
        """Propose drafts for every decode-phase slot; when any slot got
        a proposal, ONE verify dispatch serves them ALL (draft-free slots
        as one-position rows, their decode step), so a round never pays a
        verify and a plain decode dispatch. Returns the slots served, or
        () when nobody proposed (the round takes the plain decode)."""
        entries = []
        for i in active_idx:
            s = self._slots[i]
            entries.append((i, s["toks"][-1], s["pos"] + len(s["toks"]) - 1,
                            len(s["toks"]), self._propose(s)))
        if not any(e[4].size for e in entries):
            return ()
        plan = build_verify_plan(entries, self._spec_k, self._verify_align,
                                 min_rows=self.max_slots)
        self._verify_packed(plan)
        return set(plan.slots)

    def _verify_packed(self, plan):
        """ONE verify dispatch for the plan's slots, then accept and roll
        back: row r's drafts were written at write_pos + 1 .. + k; the
        dispatch returns the target's token at every position, the
        accepted counts and the stop flags. The cache is truncated to
        write_pos + accepted + 1 first, then the accepted drafts and the
        bonus token go through `_slot_token` (stopping at a stop)."""
        proposed = int(sum(d.size for d in plan.drafts))
        with self._lock:
            self._spec_proposed += proposed
            self._spec_rounds_per_slot += sum(1 for d in plan.drafts
                                              if d.size)
        _m_spec_proposed.inc(proposed)
        if self._recorder.enabled:
            self._recorder.record(
                "verify_dispatch", rows=plan.rows, proposed=proposed,
                free_blocks=self.cache.available_block_count)
        P = plan.dlen.shape[0]
        slot_rows = [plan.slots[r] if r < plan.rows else None
                     for r in range(P)]
        parts = self._attr_begin(
            (self._slots[i]["req"], plan.drafts[r].size + 1)
            for r, i in enumerate(plan.slots))
        t0 = time.perf_counter()
        try:
            with _dispatch_span(
                    "verify_dispatch",
                    (self._slots[i]["req"].rid for i in plan.slots),
                    segments=plan.rows, proposed=proposed,
                    **self._rattr()):
                self._maybe_fault("slow_dispatch")
                self._maybe_fault("ensure_many")
                # every row's table grows to its speculative horizon in
                # one atomic call (the reservation covers K positions)
                self.cache.ensure_many(plan.grow_updates(
                    [self._slots[i]["seq"] for i in plan.slots]))
                # the decode dispatch's table width: a pinned shape
                tables = self._tensor(self.cache.table_array(
                    [self._slots[i]["seq"] if i is not None else None
                     for i in slot_rows], self._m_width))
                sp, mode = self._sp_store.verify_args(slot_rows, plan.steps)
                args = (self._params, self._tensor(plan.toks),
                        self._tensor(plan.seg), self._tensor(plan.pos),
                        tables, self._tensor(plan.sample_idx),
                        self._tensor(plan.dlen), self.cache.k_blocks,
                        self.cache.v_blocks, sp)
                self._maybe_fault("verify")
                if self._graphs_on:  # one graph replay
                    vtok, acc, stopped, _kc, _vc, counts = \
                        self._decoder.graphs.verify(mode, *args)
                    with self._lock:
                        self._verify_replays += 1
                else:
                    vtok, acc, stopped, _kc, _vc, counts = \
                        self._decoder.packed_verify(*args, mode)
                vtok_h, acc_h, stop_h = self._host_arrays(
                    self._to_host((vtok, acc, stopped)))
                self._sp_store.swap_counts(counts)
        except Exception as e:  # noqa: BLE001 — the recovery ladder (or,
            # with recovery off, fail this dispatch's requests)
            self._dispatch_failure("verify", e, list(plan.slots))
            return
        self._dispatch_ok(plan.slots)
        _m_spec_verify.inc()
        t_now = time.perf_counter()
        if parts:
            self._charge_dispatch(t_now - t0, parts)
        self._ops_progress += 1
        with self._lock:
            self._spec_dispatches += 1
        discarded = 0
        for r, i in enumerate(plan.slots):
            s = self._slots[i]
            a = int(acc_h[r])
            k_r = int(plan.drafts[r].size)
            # roll back FIRST, while the sequence exists: keep the last
            # emitted token and the accepted drafts
            self.cache.truncate_seq(s["seq"], plan.write_pos[r] + a + 1)
            if k_r:  # draft-free rows have nothing to score
                with self._lock:
                    self._spec_accepted += a
                    self._spec_rolled_back += k_r - a
                _m_spec_accepted.inc(a)
                _m_spec_rolled_back.inc(k_r - a)
                _m_spec_accept_rate.observe(a / k_r)
                _tracing.event("spec_round", request_id=s["req"].rid,
                               proposed=k_r, accepted=a,
                               rolled_back=k_r - a)
            # goodput: the row computed k_r + 1 positions, a + 1
            # candidate emissions (a stop-truncated rest is replay) and
            # k_r - a rejected drafts (rolled back above)
            with self._lock:
                self._decoded_tokens += k_r + 1
            _m_decoded.inc(k_r + 1)
            discarded += (a + 1) - self._emit_row(i, vtok_h[r], stop_h[r],
                                                  a + 1, t_now)
        self._note_replayed(discarded)

    def _emit_row(self, i, toks, stops, n, t_now):
        """Emit the first n of one dispatch's tokens for slot i (fewer
        when a stop ends the request), with their ITL: the gap since the
        slot's previous emission, amortized over the tokens emitted.
        Returns the tokens consumed."""
        s = self._slots[i]
        t_prev = s["t_last"] if s["t_last"] is not None else t_now
        consumed = 0
        for j in range(n):
            consumed += 1
            self._slot_token(i, int(toks[j]), device_stopped=bool(stops[j]))
            if self._slots[i] is None:  # stopped: the rest is discarded
                break
        if self._slots[i] is not None:
            self._slots[i]["t_last"] = t_now
        per = max(t_now - t_prev, 0.0) / consumed
        req = s["req"]
        with self._lock:
            self._itl.extend([per] * consumed)
            if req.meta is not None:
                self._lane_itl.setdefault(req.meta.lane, []).extend(
                    [per] * consumed)
        if self._slo is not None:
            self._slo_latency("itl", per, req, n=consumed)
        if _metrics.enabled():
            for _ in range(consumed):
                _m_itl.observe(per)
        return consumed

    # ---- the unified round -----------------------------------------------
    def _round_unified(self):
        """One scheduler round of the unified path: plan the round (chunk
        rows, decode rows, verify regions), run it as ONE dispatch, and
        process its outputs. Async: the round dispatched here runs while
        the previous one is processed, and is processed in the next
        iteration, after its successor's dispatch; the plan and dispatch
        time of a round with one in flight counts as overlap."""
        t0 = time.perf_counter()
        plan = self._plan_round()
        outs = self._dispatch_round(plan) if plan is not None else None
        t1 = time.perf_counter()
        # prefetch-ahead while the round runs on the device (outside
        # the overlap measurement, so the planner metric stays
        # comparable)
        self._tier_prefetch_tick()
        if not self._async:
            if outs is not None:
                self._process_round(plan, outs)
            return
        pending, self._pending = self._pending, None
        if pending is not None:
            with self._lock:
                self._overlap_s += t1 - t0
            _m_round_overlap.observe(t1 - t0)
            self._process_round(*pending)
        if outs is not None:
            self._pending = (plan, outs)
        else:
            self._carry = None  # the chain broke: reseed from the host

    def _drain_pending(self):
        """Async: process the round in flight now, so the host state is
        authoritative (stop, idle, a failure's snapshots, timeouts).
        Breaks the device chain: the carry is reseeded from the host at
        the next plan."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._carry = None
            self._process_round(*pending)

    def _seed_carry(self):
        """Build the slot-indexed device carry from the host state: each
        decode-phase slot's last token, its write position and its PRNG
        step (the async chain's start). Other entries are written by
        their own round before any round reads them."""
        S = self.max_slots
        tok = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        steps = np.zeros((S,), np.int32)
        for i, s in enumerate(self._slots):
            if s is not None and s["toks"] \
                    and s["fed"] >= s["prompt"].size:
                tok[i] = s["toks"][-1]
                pos[i] = s["pos"] + len(s["toks"]) - 1
                steps[i] = len(s["toks"])
        self._carry = (self._tensor(tok), self._tensor(pos),
                       self._tensor(steps))

    def _seed_carry_slot(self, i):
        """Install one slot's host-known decode state into the live
        device carry: a warm resume enters the decode phase without a
        unified round having set its entry. (The carry's tensors may be
        a graph's outputs: they are copied, not written in place.)"""
        if self._carry is None:
            return
        s = self._slots[i]
        ct, cp, cs = (t.clone() for t in self._carry)
        ct[i] = int(s["toks"][-1])
        cp[i] = int(s["pos"] + len(s["toks"]) - 1)
        cs[i] = len(s["toks"])
        self._carry = (ct, cp, cs)

    def _plan_round(self):
        """ONE combined plan: prefill chunk rows (`_prefill_packed`'s
        budget and order), then a decode or verify row for every
        decode-phase slot (its drafts, if any). Async: a decode row's
        token, positions and PRNG step come from the device carry (the
        plan holds references to slots, not values). Returns None when no
        slot has work."""
        align = self._pack_align
        K1 = self._uk1
        W = -(-K1 // self._verify_align) * self._verify_align
        rows = []
        budget = self.prefill_chunk_tokens
        pre_idx = [i for i, s in enumerate(self._slots)
                   if s is not None and s["fed"] < s["prompt"].size]
        for i, cap in self._prefill_entries(pre_idx, budget):
            if budget <= 0:
                break
            s = self._slots[i]
            n = min(s["prompt"].size - s["fed"], budget)
            if cap is not None:
                n = min(n, int(cap))
            if n <= 0:
                continue
            rows.append({"kind": "chunk", "slot": i, "seq": s["seq"],
                         "start": s["fed"], "n": n,
                         "width": -(-n // align) * align,
                         "done": s["fed"] + n == s["prompt"].size})
            budget -= n
        for i, s in enumerate(self._slots):
            if s is None or s["fed"] < s["prompt"].size:
                continue
            # async: the context is the host-known tokens, one round
            # stale: stale drafts only lower the acceptance rate
            drafts = (self._propose(s) if self._drafter is not None
                      else np.empty((0,), np.int32))
            rows.append({"kind": "step", "slot": i, "seq": s["seq"],
                         "drafts": drafts, "width": W,
                         "steps": len(s["toks"]),
                         "wpos": s["pos"] + len(s["toks"]) - 1})
        if not rows:
            return None
        if self._async and self._carry is None:
            self._seed_carry()
        P = 1
        while P < len(rows):
            P *= 2
        # a chunk-free round takes the window layout: T = P * W, one
        # pinned region a row (the verify trunk; one graph on the card)
        window = all(row["kind"] == "step" for row in rows)
        offsets = []
        off = 0
        for row in rows:
            offsets.append(off)
            off += row["width"]
        T = P * W if window else off
        toks = np.zeros((T,), np.int32)
        seg = np.zeros((T,), np.int32)
        pos = np.full((T,), -1, np.int32)
        carry_map = np.full((T,), -1, np.int32)
        pos_map = np.full((T,), -1, np.int32)
        sample_idx = np.zeros((P, K1), np.int32)
        dlen = np.full((P,), -1, np.int32)
        row_slot = np.full((P,), -1, np.int32)
        steps_map = np.full((P,), -1, np.int32)
        steps = np.zeros((P,), np.int32)
        emit_rows = [False] * P
        n_chunk = n_step = n_drafts = 0
        for r, (row, o) in enumerate(zip(rows, offsets)):
            i = row["slot"]
            s = self._slots[i]
            if row["kind"] == "chunk":
                n_chunk += 1
                n, start = row["n"], row["start"]
                toks[o:o + n] = s["prompt"][start:start + n]
                seg[o:o + n] = r
                pos[o:o + n] = np.arange(start, start + n, dtype=np.int32)
                sample_idx[r] = o + n - 1  # every readout clamps there
                if s["t_pre0"] is None:
                    s["t_pre0"] = time.perf_counter()
                if row["done"]:
                    # the next token samples here: a dlen 0 row at the
                    # slot's PRNG step (0, or len(gen0) on a resume)
                    dlen[r] = 0
                    row_slot[r] = i
                    steps[r] = len(s["toks"])
                    emit_rows[r] = True
                continue
            n_step += 1
            drafts = row["drafts"]
            k = int(drafts.size)
            n_drafts += k
            seg[o:o + 1 + k] = r
            toks[o + 1:o + 1 + k] = drafts
            if self._async:
                # the decode token, positions and PRNG base step come
                # from the device carry: round N's samples feed round
                # N+1 with no host read
                carry_map[o] = i
                pos[o:o + 1 + k] = np.arange(0, 1 + k, dtype=np.int32)
                pos_map[o:o + 1 + k] = i
                steps_map[r] = i
            else:
                toks[o] = s["toks"][-1]
                pos[o:o + 1 + k] = np.arange(row["wpos"],
                                             row["wpos"] + 1 + k,
                                             dtype=np.int32)
                steps[r] = row["steps"]
            sample_idx[r] = o + np.minimum(np.arange(K1), k)
            dlen[r] = k
            row_slot[r] = i
            emit_rows[r] = True
        return {"rows": rows, "T": T, "P": P, "window": window,
                "toks": toks, "seg": seg, "pos": pos,
                "carry_map": carry_map, "pos_map": pos_map,
                "sample_idx": sample_idx, "dlen": dlen,
                "row_slot": row_slot, "steps_map": steps_map,
                "steps": steps, "emit_rows": emit_rows,
                "n_chunk": n_chunk, "n_step": n_step, "n_drafts": n_drafts}

    def _dispatch_round(self, plan):
        """Run one unified-round dispatch and do the bookkeeping the host
        knows without its outputs (fed positions, counters); the tokens
        wait for `_process_round`. Returns the outputs as
        `_to_host` started them, or None after a failed dispatch (the
        recovery ladder requeued the plan's requests)."""
        rows = plan["rows"]
        updates = []
        for row in rows:
            if row["kind"] == "chunk":
                updates.append((row["seq"], row["start"] + row["n"]))
                continue
            # the last known token writes at wpos, drafts after it; async:
            # the device's write front may be one emitted round ahead of
            # the host's, so grow by that too, within the reservation
            need = row["wpos"] + int(row["drafts"].size) + 1
            if self._async:
                s = self._slots[row["slot"]]
                need = min(need + 1 + self._spec_k,
                           s["pos"] + s["budget"] + self._overrun)
            updates.append((row["seq"], need))
        P = plan["P"]
        slot_rows = [rows[r]["slot"] if r < len(rows) else None
                     for r in range(P)]
        if self._recorder.enabled:
            self._recorder.record(
                "round", packed=plan["T"], rows=len(rows),
                chunk_rows=plan["n_chunk"], step_rows=plan["n_step"],
                proposed=plan["n_drafts"],
                free_blocks=self.cache.available_block_count)
        # chunk rows weigh their fed tokens, step rows their verify
        # positions (drafts + the step token); `_process_round` charges
        # its wait for the outputs to the same rows
        parts = self._attr_begin(
            (self._slots[row["slot"]]["req"],
             row["n"] if row["kind"] == "chunk"
             else row["drafts"].size + 1) for row in rows)
        plan["cost_parts"] = parts
        t0 = time.perf_counter()
        try:
            with _dispatch_span(
                    "round",
                    (self._slots[row["slot"]]["req"].rid for row in rows),
                    packed=plan["T"], segments=len(rows),
                    chunk_rows=plan["n_chunk"], step_rows=plan["n_step"],
                    **self._rattr()):
                self._maybe_fault("slow_dispatch")
                self._maybe_fault("ensure_many")
                self.cache.ensure_many(updates)
                if self.enable_prefix_cache:
                    # copy-on-write: a chunk starting in an attached
                    # block writes to a private copy
                    for row in rows:
                        if row["kind"] == "chunk":
                            self.cache.prepare_write(row["seq"],
                                                     row["start"])
                tables = self._tensor(self.cache.table_array(
                    [rows[r]["seq"] if r < len(rows) else None
                     for r in range(P)], self._m_width))
                sp, mode = self._sp_store.unified_args(
                    slot_rows, plan["emit_rows"], plan["steps"])
                if self._async:
                    ct, cp, cs = self._carry
                else:
                    if self._zero_carry is None:
                        z = self._tensor(np.zeros((self.max_slots,),
                                                  np.int32))
                        self._zero_carry = (z, z, z)
                    ct, cp, cs = self._zero_carry
                args = (self._params, self._tensor(plan["toks"]),
                        self._tensor(plan["seg"]), self._tensor(plan["pos"]),
                        tables, self._tensor(plan["sample_idx"]),
                        self._tensor(plan["dlen"]),
                        self._tensor(plan["row_slot"]),
                        self._tensor(plan["carry_map"]),
                        self._tensor(plan["pos_map"]),
                        self._tensor(plan["steps_map"]), ct, cp, cs,
                        self.cache.k_blocks, self.cache.v_blocks, sp)
                self._maybe_fault("unified_round")
                if self._graphs_on and plan["window"]:
                    (vtok, acc, stopped, _kc, _vc, counts, nct, ncp,
                     ncs) = self._decoder.graphs.unified(mode, *args)
                    with self._lock:
                        self._round_replays += 1
                else:
                    (vtok, acc, stopped, _kc, _vc, counts, nct, ncp,
                     ncs) = self._decoder.unified_round(
                        *args, mode, window=plan["window"])[:9]
                outs = self._to_host((vtok, acc, stopped))
                self._sp_store.swap_counts(counts)
        except Exception as e:  # noqa: BLE001 — the recovery ladder (or,
            # with recovery off, fail this dispatch's requests)
            self._carry = None
            self._dispatch_failure("unified_round", e,
                                   [row["slot"] for row in rows])
            return None
        self._dispatch_ok(row["slot"] for row in rows)
        if self._async:
            self._carry = (nct, ncp, ncs)
        if parts:
            t1 = time.perf_counter()
            self._charge_dispatch(t1 - t0, parts)
            if plan["n_chunk"]:
                self._ledger.note_prefill_cost(
                    int((t1 - t0) * 1e9),
                    sum(row["n"] for row in rows if row["kind"] == "chunk"))
        self._ops_progress += 1
        replay = 0
        for row in rows:
            if row["kind"] == "chunk":
                s = self._slots[row["slot"]]
                s["fed"] = row["start"] + row["n"]
                s["chunks"] += 1
                replay += self._replay_of(s["req"], row["start"], row["n"])
        with self._lock:
            if plan["n_chunk"]:
                self._prefill_dispatches += 1
            if plan["n_step"]:
                self._steps += 1
                self._active_integral += plan["n_step"]
            if mode[0]:
                self._sampled_dispatches += 1
            else:
                self._fastpath_dispatches += 1
            if plan["n_drafts"]:
                self._spec_dispatches += 1
                self._spec_proposed += plan["n_drafts"]
                self._spec_rounds_per_slot += sum(
                    1 for row in rows
                    if row["kind"] == "step" and row["drafts"].size)
            self._decoded_tokens += replay
            self._replayed_tokens += replay
        if plan["n_chunk"]:
            _m_prefill_dispatches.inc()
        if plan["n_drafts"]:
            _m_spec_verify.inc()
            _m_spec_proposed.inc(plan["n_drafts"])
        (_m_sampling_sampled if mode[0] else _m_sampling_fast).inc()
        if replay:
            _m_decoded.inc(replay)
            _m_replayed.inc(replay)
        if _metrics.enabled():
            _m_slots_busy.labels(server="paged").set(
                sum(s is not None for s in self._slots))
        self._note_round(1, mixed=bool(plan["n_chunk"] and plan["n_step"]))
        return outs

    def _process_round(self, plan, outs):
        """Read one unified round's outputs and emit its tokens (async:
        one round late, while its successor runs). Rows whose slot was
        freed or refilled since the plan (async overshoot past a stop the
        host had not seen, or a slot a failure requeued) are discarded
        as replay, so the output is the split round's."""
        t_sync0 = time.perf_counter()
        vtok_h, acc_h, stop_h = self._host_arrays(outs)
        t_now = time.perf_counter()
        if plan.get("cost_parts"):
            # the host's wait for the device here is busy time the
            # dispatch-site charge did not see
            self._charge_dispatch(t_now - t_sync0, plan["cost_parts"])
        self._ops_progress += 1
        accepted = rolled = decoded = discarded = 0
        for r, row in enumerate(plan["rows"]):
            i = row["slot"]
            s = self._slots[i]
            live = s is not None and s["seq"] == row["seq"]
            if row["kind"] == "chunk":
                if not row["done"]:
                    continue
                decoded += 1
                if not live:
                    discarded += 1
                    continue
                self._note_first_token(s, t_now)
                self._slot_token(i, int(vtok_h[r, 0]),
                                 device_stopped=bool(stop_h[r, 0]))
                continue
            a = int(acc_h[r])
            k_r = int(row["drafts"].size)
            decoded += k_r + 1
            if not live:
                rolled += k_r  # async overshoot: its drafts roll back
                discarded += 1
                continue
            if k_r and not self._async:
                # roll back first; the async chain instead overwrites the
                # rejected positions at its later write front
                self.cache.truncate_seq(s["seq"], row["wpos"] + a + 1)
            if k_r:
                rolled += k_r - a
                accepted += a
                _m_spec_accepted.inc(a)
                _m_spec_accept_rate.observe(a / k_r)
            discarded += (a + 1) - self._emit_row(i, vtok_h[r], stop_h[r],
                                                  a + 1, t_now)
        with self._lock:
            self._spec_accepted += accepted
            self._spec_rolled_back += rolled
            self._decoded_tokens += decoded
        _m_decoded.inc(decoded)
        if rolled:
            _m_spec_rolled_back.inc(rolled)
        self._note_replayed(discarded)

    def _slot_token(self, i, tok, device_stopped=False):
        """Record one generated token for slot i; completes the request
        when generation stopped (the slot frees for refill). Stop
        sources, in order: the device stop-token check (EOS or a request
        stop id); the request's stop strings, searched on the host in
        the detokenized last `stop_tail_tokens` tokens (the tokens stay
        in the output); the token budget. Only tokens the host emits
        come here, so only they are journaled."""
        slot = self._slots[i]
        req = slot["req"]
        slot["toks"].append(tok)
        if self._journal is not None:
            self._journal.record_token(req.rid, tok)
        stop_strings = req.sampling.stop_strings
        reason = None
        if device_stopped:
            reason = ("eos" if self.eos >= 0 and tok == self.eos
                      else "stop_token")
        elif stop_strings:
            # the token list spans interruptions (a resumed slot is
            # re-seeded with its earlier tokens), so a stop string
            # straddling one still matches
            try:
                if self._faults is not None:
                    self._maybe_fault("detokenize")
                tail = self._detok(slot["toks"][-self.stop_tail_tokens:])
            except Exception as e:  # noqa: BLE001 — a broken
                # detokenizer implicates exactly ONE request: quarantine
                # it, naming the seam, and keep every co-resident serving
                self._quarantine_slot(i, "detokenize", e, 1)
                return
            if any(x in tail for x in stop_strings):
                reason = "stop_string"
        if reason is None and len(slot["toks"]) >= slot["budget"]:
            reason = "budget"
        cb = req.on_token
        if cb is not None:
            # a broken stream consumer must not kill the loop: its
            # stream is dropped, the request goes on
            try:
                if self._faults is not None:
                    self._maybe_fault("stream_consumer")
                cb(tok, reason)
            except Exception:  # noqa: BLE001 — streams are best-effort
                _logger.exception(
                    "on_token callback failed for request %s (stream "
                    "dropped; generation continues)", req.rid)
                req.on_token = None
        if reason is None:
            return
        self._ops_progress += 1
        self._fault_streak.pop(req.rid, None)
        if self._journal is not None:
            self._journal.record_done(req.rid, reason)
        self._recorder.record("request_done", request_id=req.rid, slot=i,
                              new_tokens=len(slot["toks"]), reason=reason,
                              **self._tr(req))
        cost = (self._ledger.request_done(req.rid, len(slot["toks"]))
                if self._ledger is not None else None)
        _tracing.event("request_done", request_id=req.rid,
                       new_tokens=len(slot["toks"]), ttft_s=req.ttft,
                       reason=reason, cost=cost, **self._tr(req))
        self._slo_avail(req, True)
        with _tracing.span("detokenize", request_id=req.rid,
                           **self._tr(req)):
            out = np.concatenate([req.ids, np.asarray(slot["toks"],
                                                      np.int32)])
            self._release_slot(i)
            t_done = time.perf_counter()
            with self._lock:
                self._lat.append(t_done - req.t_submit)
                self._tokens_out += len(slot["toks"])
                self._stop_reasons[reason] += 1
            _m_slot_releases.labels(reason=reason).inc()
            _m_stop_reason.labels(server="paged", reason=reason).inc()
            _m_requests_done.labels(server="paged").inc()
            _m_request_latency.labels(server="paged").observe(
                t_done - req.t_submit)
            req.future.set_result(out)


class GenerationServer:
    """Dynamic-batching server over one fixed-shape decode program (module
    docstring).

    program: a `jit.load(prefix)` generator, or any callable (ids [B, P]
        int32, seed, temperature, eos, top_p, pad) -> [B, T].
    batch_size / prompt_len: the program's B and P, read from its
        `_meta` when not given (a batch-polymorphic artifact serves B 8).
    pad_token_id: the LEFT-padding id of shorter prompts.
    max_wait_ms: how long a batch waits to fill after its first request.
    temperature, seed, eos_token_id (-1 none), top_p: the program
        arguments of requests submitted without SamplingParams.
    strict_pad_check: raise, not warn, at a full-length prompt holding
        the pad id.
    attribution: keep a `ResourceLedger`: each batch's measured
        dispatch time is split evenly over its rows' tenants
        (`submit(tenant=)`), `cost_report()` exports it.
    """

    def __init__(self, program, batch_size=None, prompt_len=None,
                 pad_token_id=0, max_wait_ms=5.0, temperature=0.0,
                 seed=0, eos_token_id=-1, top_p=1.0,
                 strict_pad_check=False, attribution=False):
        self._program = program
        meta = getattr(program, "_meta", {}) or {}
        prompt_len = prompt_len or meta.get("prompt_len")
        batch_size = batch_size or meta.get("batch_size")
        if not batch_size and prompt_len and meta.get("batch_size", 0) \
                is None:
            batch_size = 8  # a batch-polymorphic artifact: the default
        if not batch_size or not prompt_len:
            raise ValueError(
                "batch_size/prompt_len not given and not recorded in the "
                "artifact meta (re-export with models.gpt2."
                "export_generator, or pass them explicitly)")
        self.batch_size = int(batch_size)
        self.prompt_len = int(prompt_len)
        # the paged server's schema; the dense program's quantization is
        # baked into its artifact (its scales live in the params)
        wq, kq = meta.get("weight_quant"), meta.get("kv_quant")
        self._quant_stats = {
            "enabled": bool(wq or kq),
            "mode": "w8a16" if wq == "int8" else "none",
            "kv_dtype": kq or "native",
            "kv_scale_bytes": 0,
            "kv_pool_bytes_total": 0,
        }
        self.pad_token_id = int(pad_token_id)
        self.strict_pad_check = bool(strict_pad_check)
        self.max_wait_ms = float(max_wait_ms)
        self._defaults = (int(seed) & 0xFFFFFFFF, float(temperature),
                          int(eos_token_id), float(top_p),
                          int(pad_token_id))
        self._lock = threading.Condition()
        self._queue: list = []
        self._stop = False
        self._thread = None
        self._lat = []
        self._tokens_out = 0
        self._batches = 0
        self._batches_at_reset = 0
        self._rows = 0
        self._stop_reasons = dict.fromkeys(STOP_REASONS, 0)
        self._t0 = None
        # the paged server's ledger class: rows of one batch cost the
        # same at fixed B, so a batch's time splits evenly over them
        self._ledger = ResourceLedger() if attribution else None

    def _req_sig(self, sampling):
        """The program signature a batch shares: (temperature, top_p,
        seed or None for the rolling batch seed, eos, eos from the stop
        ids). Fields the program cannot take per row raise here."""
        _seed0, temp0, eos0, top_p0, _ = self._defaults
        if sampling is None:
            return (temp0, top_p0, None, eos0, False)
        s = sampling
        for field_name, bad in (
                ("top_k", s.top_k != 0),
                ("min_p", s.min_p != 0.0),
                ("repetition_penalty", s.repetition_penalty != 1.0),
                ("presence_penalty", s.presence_penalty != 0.0),
                ("frequency_penalty", s.frequency_penalty != 0.0),
                ("stop_strings", bool(s.stop_strings)),
                ("max_new_tokens", s.max_new_tokens is not None)):
            if bad:
                raise ValueError(
                    f"GenerationServer (dense) does not support "
                    f"SamplingParams.{field_name}="
                    f"{getattr(s, field_name)!r}; use "
                    f"PagedGenerationServer")
        if len(s.stop_token_ids) > 1:
            raise ValueError(
                "GenerationServer (dense) supports at most one stop "
                f"token id (the program's eos), got "
                f"{s.stop_token_ids!r}; use PagedGenerationServer")
        eos = int(s.stop_token_ids[0]) if s.stop_token_ids else eos0
        return (s.temperature, s.top_p, s.seed, eos,
                bool(s.stop_token_ids))

    # ---- client API ----------------------------------------------------
    def submit(self, ids, sampling=None, tenant="default"):
        """Enqueue one prompt (length 1..prompt_len). Returns a Future of
        its [prompt_len + new] int32 row (LEFT-padded prompt first).
        `tenant` is the attribution account its device time goes to."""
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, "
                            f"got {type(sampling).__name__}")
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.size == 0 or ids.size > self.prompt_len:
            raise ValueError(
                f"prompt length {ids.size} not in [1, {self.prompt_len}]")
        if ids.size == self.prompt_len and (ids == self.pad_token_id).any():
            # value-equality padding: batched with a padded row, this
            # prompt's pad-valued positions would be masked too
            at = np.flatnonzero(ids == self.pad_token_id).tolist()
            msg = (f"full-length prompt contains pad_token_id="
                   f"{self.pad_token_id} at positions {at}: batched "
                   f"with padded rows those positions would be masked "
                   f"(value-equality padding); use "
                   f"PagedGenerationServer (length masking) or a pad "
                   f"id outside the prompt alphabet")
            if self.strict_pad_check:
                raise ValueError(msg)
            _logger.warning("GenerationServer.submit: %s", msg)
        sig = self._req_sig(sampling)
        row = np.full((self.prompt_len,), self.pad_token_id, np.int32)
        row[self.prompt_len - ids.size:] = ids  # LEFT padding
        req = _DenseReq(ids=row, future=Future(),
                        t_submit=time.perf_counter(),
                        padded=ids.size < self.prompt_len, sig=sig,
                        rid=f"d{next(_req_ids)}", tenant=str(tenant))
        if self._ledger is not None:
            self._ledger.request_begin(req.rid, req.tenant)
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            self._queue.append(req)
            _m_queue_depth.labels(server="dense").set(len(self._queue))
            self._lock.notify()
        _tracing.event("request_submitted", request_id=req.rid,
                       prompt_len=int(ids.size))
        return req.future

    def start(self):
        if self._thread is not None:
            return self
        if self._stop:
            raise RuntimeError(
                "server was stopped; build a new GenerationServer")
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        with self._lock:
            for req in self._queue:  # fail, don't strand, late arrivals
                req.future.set_exception(RuntimeError("server stopped"))
            self._queue.clear()

    def reset_stats(self):
        """Zero the window's counters; the batch count keeps advancing so
        rolling seeds never repeat."""
        with self._lock:
            self._lat.clear()
            self._tokens_out = 0
            self._rows = 0
            self._batches_at_reset = self._batches
            self._stop_reasons = dict.fromkeys(STOP_REASONS, 0)
            self._t0 = time.perf_counter()
        if self._ledger is not None:
            self._ledger.reset()

    def stats(self):
        """Throughput and latency since start() or reset_stats()."""
        with self._lock:
            lat = sorted(self._lat)
            dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
            n = len(lat)
            nb = self._batches - self._batches_at_reset

            def pct(p):
                return lat[min(n - 1, int(p * n))] if n else 0.0

            return {
                "requests": n,
                "batches": nb,
                "batch_fill": self._rows / ((nb or 1) * self.batch_size),
                "new_tokens": self._tokens_out,
                "tokens_per_sec": self._tokens_out / dt if dt else 0.0,
                "p50_ms": pct(0.50) * 1e3,
                "p90_ms": pct(0.90) * 1e3,
                "p99_ms": pct(0.99) * 1e3,
                "stop_reasons": dict(self._stop_reasons),
                "quantization": dict(self._quant_stats),
                # the paged server's schema, zeroed without a ledger
                "attribution": (self._ledger.stats()
                                if self._ledger is not None
                                else disabled_attribution_stats()),
                "wall_s": dt,
            }

    # ---- batcher loop --------------------------------------------------
    def _take_batch(self):
        """Block for the first request, then gather until the batch is
        full or the max_wait deadline; only requests with the head
        request's signature join (the rest keep their order). [] on
        stop."""
        with self._lock:
            while not self._queue and not self._stop:
                self._lock.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
            deadline = time.perf_counter() + self.max_wait_ms * 1e-3
            while len(self._queue) < self.batch_size and not self._stop:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            sig = self._queue[0].sig
            batch = []
            for r in self._queue:
                if len(batch) == self.batch_size:
                    break
                if r.sig == sig:
                    batch.append(r)
            for r in batch:
                self._queue.remove(r)
            _m_queue_depth.labels(server="dense").set(len(self._queue))
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            for r in batch:
                _tracing.event("request_admitted", request_id=r.rid)
            _m_slots_busy.labels(server="dense").set(len(batch))
            rows = [r.ids for r in batch]
            while len(rows) < self.batch_size:  # pad: the same cost
                rows.append(rows[0])
            ids = np.stack(rows)
            temp, top_p, seed, eos, from_stop = batch[0].sig
            # pad masking is by value in the program: engage it only
            # when a row is padded
            pad = self._defaults[-1] if any(r.padded for r in batch) \
                else -1
            if seed is None:
                # a fixed seed would draw the same noise every batch
                seed = (self._defaults[0] + self._batches) & 0xFFFFFFFF
            t_disp = time.perf_counter()
            try:
                with _dispatch_span("decode_dispatch",
                                    (r.rid for r in batch),
                                    batch=len(batch)):
                    out = self._program(ids, int(seed) & 0xFFFFFFFF,
                                        float(temp), int(eos),
                                        float(top_p), int(pad))
                    out = np.asarray(out.cpu()
                                     if isinstance(out, torch.Tensor)
                                     else out)
            except Exception as e:  # noqa: BLE001 — fan the error out
                _m_slots_busy.labels(server="dense").set(0)
                for r in batch:
                    r.future.set_exception(e)
                continue
            t_done = time.perf_counter()
            if self._ledger is not None:
                self._ledger.charge_device(
                    int((t_done - t_disp) * 1e9),
                    [(r.tenant, r.rid, 1) for r in batch])
            new_tokens = out.shape[1] - self.prompt_len
            # the program keeps emitting eos after a hit, so an eos among
            # the generated tokens is exact
            reasons = []
            for i in range(len(batch)):
                gen = out[i, self.prompt_len:]
                if eos >= 0 and (gen == eos).any():
                    reasons.append("stop_token" if from_stop else "eos")
                else:
                    reasons.append("budget")
            with self._lock:
                self._batches += 1
                self._rows += len(batch)
                self._tokens_out += new_tokens * len(batch)
                for i, r in enumerate(batch):
                    self._lat.append(t_done - r.t_submit)
                    self._stop_reasons[reasons[i]] += 1
            _m_slots_busy.labels(server="dense").set(0)
            for i, r in enumerate(batch):
                cost = (self._ledger.request_done(r.rid, new_tokens)
                        if self._ledger is not None else None)
                _tracing.event("request_done", request_id=r.rid,
                               new_tokens=int(new_tokens), cost=cost)
                _m_requests_done.labels(server="dense").inc()
                _m_stop_reason.labels(server="dense",
                                      reason=reasons[i]).inc()
                _m_request_latency.labels(server="dense").observe(
                    t_done - r.t_submit)
                r.future.set_result(out[i])

    def cost_report(self):
        """The `CostReport` of the current window; None when the server
        was built without attribution."""
        return self._ledger.report() if self._ledger is not None else None


@dataclass(eq=False)
class _DenseReq:
    ids: np.ndarray
    future: Future
    t_submit: float
    padded: bool
    sig: tuple
    rid: str = ""
    tenant: str = "default"


def measure_offered_load(server, prompts, offered_rps, duration_s):
    """Drive `server` at `offered_rps` requests a second for `duration_s`
    (prompts cycled), wait for every result; returns the server's stats
    plus the offered and achieved rates (the offer window ends at the
    last submit)."""
    futs = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < duration_s:
        target = t0 + i / offered_rps
        now = time.perf_counter()
        if now < target:
            time.sleep(target - now)
        futs.append(server.submit(prompts[i % len(prompts)]))
        i += 1
    t_submit_end = time.perf_counter()
    for f in futs:
        f.result(timeout=600)
    out = server.stats()
    out["offered_rps"] = offered_rps
    out["achieved_rps"] = i / (t_submit_end - t0)
    return out


__all__ = ["PagedGenerationServer", "GenerationServer", "RequestMeta",
           "measure_offered_load", "STOP_REASONS"]
