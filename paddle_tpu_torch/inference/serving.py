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

Left for later slices: the front door and scheduler seams (preemption,
warm resume, tier prefetch), the recovery ladder and journal, fault
seams, tracing, SLOs and attribution, the bucket pre-warm
(`warm_buckets`), goodput accounting, the operations plane and
sharding.

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
blocks. The server computes nothing itself: the program runs on its own
device. Left out (ROADMAP §A 7): `attribution=` (raises naming it) and
`cost_report`, the tracing events and the metrics. `measure_offered_load`
drives a server at a fixed request rate.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..nn.decode import PagedDecoder
from ..sampling import SamplingParams, SlotParamStore
from ..sampling.buffers import host_to_device
from ..spec_decode import SpecConfig, build_verify_plan
from .kv_cache import PagedKVCache, blocks_for
from .kv_tier import normalize_kv_tier

_logger = logging.getLogger(__name__)

STOP_REASONS = ("eos", "stop_token", "stop_string", "budget")


@dataclass
class _Req:
    ids: np.ndarray
    future: Future
    t_submit: float
    budget: int
    sampling: SamplingParams
    seed: int  # the request's PRNG stream seed (uint32)


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
    device: None -> CUDA (raises when absent); "cpu" for the plain path.
    """

    def __init__(self, model, *, max_slots=4, block_size=16,
                 max_prompt_len=None, max_new_tokens=32, num_blocks=None,
                 eos_token_id=None, temperature=0.0, seed=0,
                 steps_per_dispatch=1, prefill_chunk_tokens=512,
                 pack_align=None, detokenize=None, stop_tail_tokens=16,
                 enable_prefix_cache=False, kv_tier=None, kv_dtype=None,
                 quantization=None, weight_quant=None, speculation=None,
                 unified_round=False, async_rounds=False, device=None):
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
        self._params = {k: v.to(self.device)
                        for k, v in model.flat_params().items()}
        if quantization == "w8a16":
            self._params = model.quantize_weights(self._params)
        dt = self._params["ln_f.weight"].dtype
        self._m_width = blocks_for(
            self.max_prompt_len + self.max_new + self._overrun,
            self.block_size)
        if num_blocks is None:  # worst case: every slot at full horizon
            spare = 1 if self.enable_prefix_cache else 0
            num_blocks = self.max_slots * (self._m_width + spare) + 1
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            block_size=self.block_size, num_blocks=int(num_blocks),
            dtype=dt, kv_dtype=kv_dtype, tier=tier, device=self.device)
        self._decoder = PagedDecoder.for_config(cfg, self.block_size,
                                                kv_dtype=kv_dtype)
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
        # budget, fed, t_last)
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
        self._reset_window()

    # ---- client surface -------------------------------------------------
    def submit(self, ids, max_new_tokens=None, sampling=None):
        """Enqueue one prompt (any length <= max_prompt_len; no padding).
        Returns a Future resolving to the UNPADDED [len + generated]
        int32 sequence. Generation stops at EOS, a stop token id, a stop
        string, or the token budget (`max_new_tokens` arg, else
        `sampling`'s, else the server default)."""
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
        # explicit seeds reproduce tokens whatever the batch; auto seeds
        # give each request its own stream, deterministic given the
        # order of submission
        seed = (sampling.seed if sampling.seed is not None else
                (self._seed0 + 0x9E3779B9 * (1 + next(self._auto_seeds)))
                & 0xFFFFFFFF)
        req = _Req(ids=ids, future=Future(), t_submit=time.perf_counter(),
                   budget=budget, sampling=sampling, seed=seed)
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            self._queue.append(req)
            self._lock.notify()
        return req.future

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

    def stop(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=120)
            self._thread = None
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            # residents of a stopped loop never finish: fail them too
            pending += [s["req"] for s in self._slots if s is not None]
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

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

    def reset_stats(self):
        """Zero the measurement window (latency, TTFT and ITL samples,
        counters) and restart its clock."""
        with self._lock:
            self._reset_window()
            self._t0 = time.perf_counter()

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

            return {
                "requests": len(lat),
                "new_tokens": self._tokens_out,
                "tokens_per_sec": self._tokens_out / dt if dt else 0.0,
                "p50_ms": pct(lat, 0.50) * 1e3,
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
            }

    # ---- admission -------------------------------------------------------
    def _outstanding_blocks(self):
        """Blocks the resident slots may still demand in the worst case."""
        total = 0
        for slot in self._slots:
            if slot is not None:
                held = self.cache.blocks_held(slot["seq"])
                total += max(0, self._worst[slot["seq"]] - held)
        return total

    def _worst_blocks(self, req):
        """Worst-case block reservation for `req` (prompt + budget + the
        multi-step, speculative and async overrun), plus one spare block
        for the (at most one)
        copy-on-write a prefix attach ending mid-block can force."""
        return blocks_for(req.ids.size + req.budget + self._overrun,
                          self.block_size) + (
            1 if self.enable_prefix_cache else 0)

    def _install_slot_locked(self, i, req, worst):
        """Bind `req` to slot `i` (the caller checked the reservation)."""
        seq = self._seq_counter
        self._seq_counter += 1
        self._worst[seq] = worst
        # prefix caching: attach the longest cached chain; those tokens
        # count as fed and the prefill starts at the first uncached one
        cached = 0
        if self.enable_prefix_cache:
            cached = self.cache.attach_prefix(seq, req.ids)
        # fed: prompt tokens already written to the cache — the slot is
        # in its PREFILL phase until fed == prompt length, then decodes
        self._slots[i] = {"seq": seq, "req": req, "toks": [],
                          "prompt": req.ids, "pos": req.ids.size,
                          "budget": req.budget, "fed": cached,
                          "t_last": None}
        # penalty counts seed from the prompt
        self._sp_store.set_slot(i, req.sampling, req.seed, eos=self.eos,
                                prompt_ids=req.ids)

    def _admit_locked(self):
        """Fill idle slots FIFO while the pool can cover each request's
        worst case; head-of-line blocking keeps arrival order under
        pressure."""
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._queue:
                continue
            req = self._queue[0]
            worst = self._worst_blocks(req)
            if self.cache.available_block_count \
                    - self._outstanding_blocks() < worst:
                break
            self._queue.pop(0)
            self._install_slot_locked(i, req, worst)

    # ---- the loop --------------------------------------------------------
    def _loop(self):
        try:
            self._loop_body()
        except Exception as e:  # noqa: BLE001 — the engine thread's
            # boundary: an engine bug must not strand callers on futures
            # that never resolve
            _logger.exception("paged serving loop died")
            with self._lock:
                self._stop = True
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
                    self._admit_locked()
                    idle = all(s is None for s in self._slots)
                    if idle and self._pending is None:
                        self._lock.wait(timeout=0.1)
                        continue
            if stop:
                # async: resolve the round in flight, so no future is
                # left waiting on tokens the device already computed
                self._drain_pending()
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
        d1 = self._dispatches()
        if d1 > d0:
            self._note_round(d1 - d0,
                             mixed=bool(pre_idx) and bool(active_idx))

    def _fail_slot(self, i, e):
        """Fail slot i's request with `e`, return its blocks and free
        the slot."""
        s = self._slots[i]
        if self.cache.has_seq(s["seq"]):
            self.cache.free(s["seq"])
        self._worst.pop(s["seq"], None)
        self._slots[i] = None
        self._sp_store.clear_slot(i)
        s["req"].future.set_exception(e)

    def _dispatch_failure(self, e, slot_idx):
        """A dispatch raised: fail exactly the requests in it, return
        their blocks, and keep serving the rest."""
        _logger.error("dispatch failed for slots %s: %s: %s", slot_idx,
                      type(e).__name__, e)
        for i in slot_idx:
            if self._slots[i] is not None:
                self._fail_slot(i, e)

    def _tensor(self, a):
        return host_to_device(a, self.device)

    def _to_host(self, tensors):
        """Start copying a dispatch's outputs to the host: on the card
        into page-locked buffers by non-blocking copies, with an event
        after them (the outputs may be a graph's, overwritten by its
        next replay: the copies are queued before it). Returns what
        `_host_arrays` reads."""
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

    def _prefill_packed(self, pre_idx):
        """ONE packed ragged prefill dispatch over up to
        prefill_chunk_tokens prompt tokens of the slots still feeding
        their prompts (slot order)."""
        align = self._pack_align
        budget = self.prefill_chunk_tokens
        plan = []  # (slot_idx, start, n, packed_offset)
        off = 0
        for i in pre_idx:
            if budget <= 0:
                break
            s = self._slots[i]
            n = min(s["prompt"].size - s["fed"], budget)
            plan.append((i, s["fed"], n, off))
            off += -(-n // align) * align
            budget -= n
        T, P = off, len(plan)
        toks = np.zeros((T,), np.int32)
        seg = np.zeros((T,), np.int32)
        pos = np.full((T,), -1, np.int32)  # -1 marks packing pad
        sample_idx = np.zeros((P,), np.int32)
        done_rows = []  # (slot_idx, plan_row)
        for r, (i, start, n, o) in enumerate(plan):
            s = self._slots[i]
            toks[o:o + n] = s["prompt"][start:start + n]
            seg[o:o + n] = r
            pos[o:o + n] = np.arange(start, start + n, dtype=np.int32)
            if start + n == s["prompt"].size:
                sample_idx[r] = o + n - 1
                done_rows.append((i, r))
        try:
            # the whole plan's tables grow atomically (reservation-backed,
            # so this cannot exhaust the pool mid-plan)
            self.cache.ensure_many(
                [(self._slots[i]["seq"], start + n)
                 for i, start, n, _ in plan])
            if self.enable_prefix_cache:
                # copy-on-write: a chunk starting in an attached (shared
                # or index-claimed) block writes to a private copy
                for i, start, _n, _o in plan:
                    self.cache.prepare_write(self._slots[i]["seq"], start)
            width = max(blocks_for(start + n, self.block_size)
                        for _, start, n, _ in plan)
            tables = self._tensor(self.cache.table_array(
                [self._slots[i]["seq"] for i, *_ in plan], width))
            # token-0 sampling runs the decode pipeline at PRNG step 0
            done_set = {r for _, r in done_rows}
            sp, mode = self._sp_store.packed_args(
                [i for i, *_ in plan], [r in done_set for r in range(P)])
            tok, stopped, _kc, _vc, counts = self._decoder.packed_prefill(
                self._params, self._tensor(toks), self._tensor(seg),
                self._tensor(pos), tables, self._tensor(sample_idx),
                self.cache.k_blocks, self.cache.v_blocks, sp, mode)
            self._sp_store.swap_counts(counts)
            tok_h = tok.cpu().numpy()
            stopped_h = stopped.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — fail this chunk's
            # requests, keep the engine serving
            self._dispatch_failure(e, [i for i, *_ in plan])
            return
        t_now = time.perf_counter()
        with self._lock:
            self._prefill_dispatches += 1
        for i, start, n, _o in plan:
            self._slots[i]["fed"] = start + n
        for i, r in done_rows:
            s = self._slots[i]
            if self.enable_prefix_cache:
                # every prompt position is written: index the blocks
                self.cache.publish_prefix(s["seq"], s["prompt"])
            with self._lock:
                self._ttft.append(t_now - s["req"].t_submit)
                self._prefills += 1
            s["t_last"] = t_now
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
        with self._lock:
            if mode[0]:
                self._sampled_dispatches += 1
            else:
                self._fastpath_dispatches += 1
        try:
            # grow tables for the incoming token(s) BEFORE the step
            # writes them (k tokens starting at the feed position)
            self.cache.ensure_many(
                [(self._slots[i]["seq"], self._slots[i]["pos"]
                  + len(self._slots[i]["toks"]) - 1 + k)
                 for i in active_idx])
            tables = self._tensor(self.cache.table_array(
                [s["seq"] if s is not None else None for s in self._slots],
                self._m_width))
            args = (self._params, self._tensor(tok), self._tensor(pos),
                    self._tensor(act), tables, self.cache.k_blocks,
                    self.cache.v_blocks, sp)
            if self.device.type == "cuda":  # one graph replay, any k
                toks, stopped, _kc, _vc, counts = self._decoder.graphs(
                    k, mode, *args)
                with self._lock:
                    self._graph_replays += 1
            elif k == 1:
                nxt, stopped, _kc, _vc, counts = self._decoder.step(
                    *args, mode)
                toks, stopped = nxt[None], stopped[None]     # [1, S]
            else:
                toks, stopped, _kc, _vc, counts = self._decoder.multistep(
                    k, mode)(*args)
            toks = toks.cpu().numpy()                     # [k, S]
            stops = stopped.cpu().numpy()
            # the counts are copied out before the next dispatch (a
            # graph's outputs belong to its next replay)
            self._sp_store.swap_counts(counts)
        except Exception as e:  # noqa: BLE001 — fail this dispatch's
            # requests, keep the engine serving
            self._dispatch_failure(e, list(active_idx))
            return
        t_now = time.perf_counter()
        with self._lock:
            self._steps += 1
            self._active_integral += len(active_idx)
        for i in active_idx:  # tokens after a stop are discarded
            self._emit_row(i, toks[:, i], stops[:, i], toks.shape[0], t_now)

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
        with self._lock:
            self._spec_proposed += int(sum(d.size for d in plan.drafts))
            self._spec_rounds_per_slot += sum(1 for d in plan.drafts
                                              if d.size)
        P = plan.dlen.shape[0]
        slot_rows = [plan.slots[r] if r < plan.rows else None
                     for r in range(P)]
        try:
            # every row's table grows to its speculative horizon in one
            # atomic call (the admission reservation covers K positions)
            self.cache.ensure_many(plan.grow_updates(
                [self._slots[i]["seq"] for i in plan.slots]))
            # the decode dispatch's table width: a pinned shape
            tables = self._tensor(self.cache.table_array(
                [self._slots[i]["seq"] if i is not None else None
                 for i in slot_rows], self._m_width))
            sp, mode = self._sp_store.verify_args(slot_rows, plan.steps)
            args = (self._params, self._tensor(plan.toks),
                    self._tensor(plan.seg), self._tensor(plan.pos), tables,
                    self._tensor(plan.sample_idx), self._tensor(plan.dlen),
                    self.cache.k_blocks, self.cache.v_blocks, sp)
            if self.device.type == "cuda":  # one graph replay
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
        except Exception as e:  # noqa: BLE001 — fail this dispatch's
            # requests, keep the engine serving
            self._dispatch_failure(e, list(plan.slots))
            return
        t_now = time.perf_counter()
        with self._lock:
            self._spec_dispatches += 1
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
            self._emit_row(i, vtok_h[r], stop_h[r], a + 1, t_now)

    def _emit_row(self, i, toks, stops, n, t_now):
        """Emit the first n of one dispatch's tokens for slot i (fewer
        when a stop ends the request), with their ITL: the gap since the
        slot's previous emission, amortized over the tokens emitted."""
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
        with self._lock:
            self._itl.extend([per] * consumed)

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
        if not self._async:
            if outs is not None:
                self._process_round(plan, outs)
            return
        pending, self._pending = self._pending, None
        if pending is not None:
            with self._lock:
                self._overlap_s += t1 - t0
            self._process_round(*pending)
        if outs is not None:
            self._pending = (plan, outs)
        else:
            self._carry = None  # the chain broke: reseed from the host

    def _drain_pending(self):
        """Async: process the round in flight now, so the host state is
        authoritative (stop, idle). Breaks the device chain: the carry
        is reseeded from the host at the next plan."""
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
        for i, s in enumerate(self._slots):
            if budget <= 0:
                break
            if s is None or s["fed"] >= s["prompt"].size:
                continue
            n = min(s["prompt"].size - s["fed"], budget)
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
                if row["done"]:
                    # token 0 samples here: a dlen 0 row at step 0
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
        plan's requests are failed and their blocks freed)."""
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
        try:
            self.cache.ensure_many(updates)
            if self.enable_prefix_cache:
                # copy-on-write: a chunk starting in an attached block
                # writes to a private copy
                for row in rows:
                    if row["kind"] == "chunk":
                        self.cache.prepare_write(row["seq"], row["start"])
            tables = self._tensor(self.cache.table_array(
                [rows[r]["seq"] if r < len(rows) else None
                 for r in range(P)], self._m_width))
            sp, mode = self._sp_store.unified_args(
                slot_rows, plan["emit_rows"], plan["steps"])
            if self._async:
                ct, cp, cs = self._carry
            else:
                if self._zero_carry is None:
                    z = self._tensor(np.zeros((self.max_slots,), np.int32))
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
            if self.device.type == "cuda" and plan["window"]:
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
        except Exception as e:  # noqa: BLE001 — fail this dispatch's
            # requests, keep the engine serving
            self._carry = None
            self._dispatch_failure(e, [row["slot"] for row in rows])
            return None
        if self._async:
            self._carry = (nct, ncp, ncs)
        for row in rows:
            if row["kind"] == "chunk":
                self._slots[row["slot"]]["fed"] = row["start"] + row["n"]
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
        self._note_round(1, mixed=bool(plan["n_chunk"] and plan["n_step"]))
        return outs

    def _process_round(self, plan, outs):
        """Read one unified round's outputs and emit its tokens (async:
        one round late, while its successor runs). Rows whose slot was
        freed or refilled since the plan (async overshoot past a stop the
        host had not seen) are discarded, so the output is the split
        round's."""
        vtok_h, acc_h, stop_h = self._host_arrays(outs)
        t_now = time.perf_counter()
        accepted = rolled = 0
        for r, row in enumerate(plan["rows"]):
            i = row["slot"]
            s = self._slots[i]
            live = s is not None and s["seq"] == row["seq"]
            if row["kind"] == "chunk":
                if not (row["done"] and live):
                    continue
                if self.enable_prefix_cache:
                    # every prompt position is written: index the blocks
                    self.cache.publish_prefix(s["seq"], s["prompt"])
                with self._lock:
                    self._ttft.append(t_now - s["req"].t_submit)
                    self._prefills += 1
                s["t_last"] = t_now
                self._slot_token(i, int(vtok_h[r, 0]),
                                 device_stopped=bool(stop_h[r, 0]))
                continue
            a = int(acc_h[r])
            k_r = int(row["drafts"].size)
            if not live:
                rolled += k_r  # async overshoot: its drafts roll back
                continue
            if k_r and not self._async:
                # roll back first; the async chain instead overwrites the
                # rejected positions at its later write front
                self.cache.truncate_seq(s["seq"], row["wpos"] + a + 1)
            if k_r:
                rolled += k_r - a
                accepted += a
            self._emit_row(i, vtok_h[r], stop_h[r], a + 1, t_now)
        with self._lock:
            self._spec_accepted += accepted
            self._spec_rolled_back += rolled

    def _slot_token(self, i, tok, device_stopped=False):
        """Record one generated token for slot i; completes the request
        when generation stopped (the slot frees for refill). Stop
        sources, in order: the device stop-token check (EOS or a request
        stop id); the request's stop strings, searched on the host in
        the detokenized last `stop_tail_tokens` tokens (the tokens stay
        in the output); the token budget."""
        slot = self._slots[i]
        slot["toks"].append(tok)
        stop_strings = slot["req"].sampling.stop_strings
        reason = None
        if device_stopped:
            reason = ("eos" if self.eos >= 0 and tok == self.eos
                      else "stop_token")
        elif stop_strings:
            try:
                tail = self._detok(slot["toks"][-self.stop_tail_tokens:])
            except Exception as e:  # noqa: BLE001 — a broken
                # detokenizer implicates exactly ONE request: fail it,
                # naming the seam, and keep every co-resident serving
                _logger.error("detokenize failed for slot %s: %s: %s", i,
                              type(e).__name__, e)
                err = RuntimeError(f"request failed at seam 'detokenize': "
                                   f"{type(e).__name__}: {e}")
                err.__cause__ = e
                self._fail_slot(i, err)
                return
            if any(x in tail for x in stop_strings):
                reason = "stop_string"
        if reason is None and len(slot["toks"]) >= slot["budget"]:
            reason = "budget"
        if reason is None:
            return
        req = slot["req"]
        out = np.concatenate([req.ids, np.asarray(slot["toks"], np.int32)])
        self.cache.free(slot["seq"])
        del self._worst[slot["seq"]]
        self._slots[i] = None
        self._sp_store.clear_slot(i)
        with self._lock:
            self._lat.append(time.perf_counter() - req.t_submit)
            self._tokens_out += len(slot["toks"])
            self._stop_reasons[reason] += 1
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
    """

    def __init__(self, program, batch_size=None, prompt_len=None,
                 pad_token_id=0, max_wait_ms=5.0, temperature=0.0,
                 seed=0, eos_token_id=-1, top_p=1.0,
                 strict_pad_check=False, attribution=False):
        if attribution:
            raise ValueError(
                "GenerationServer(attribution=True) is not ported "
                "(ROADMAP §A 7: attribution, tracing and metrics)")
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
    def submit(self, ids, sampling=None):
        """Enqueue one prompt (length 1..prompt_len). Returns a Future of
        its [prompt_len + new] int32 row (LEFT-padded prompt first)."""
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
                        padded=ids.size < self.prompt_len, sig=sig)
        with self._lock:
            if self._stop:
                raise RuntimeError("server stopped")
            self._queue.append(req)
            self._lock.notify()
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
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
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
            try:
                out = self._program(ids, int(seed) & 0xFFFFFFFF,
                                    float(temp), int(eos), float(top_p),
                                    int(pad))
                out = np.asarray(out.cpu() if isinstance(out, torch.Tensor)
                                 else out)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for r in batch:
                    r.future.set_exception(e)
                continue
            t_done = time.perf_counter()
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
            for i, r in enumerate(batch):
                r.future.set_result(out[i])


@dataclass
class _DenseReq:
    ids: np.ndarray
    future: Future
    t_submit: float
    padded: bool
    sig: tuple


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


__all__ = ["PagedGenerationServer", "GenerationServer",
           "measure_offered_load", "STOP_REASONS"]
