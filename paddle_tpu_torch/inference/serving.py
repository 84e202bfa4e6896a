"""PagedGenerationServer — continuous batching over the paged KV cache.

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

The packed stream is not bucketed to a power of two as the reference's
is: PyTorch compiles nothing per shape, so a bucket would only add pad
rows to every dispatch.

Left for later slices: prefix cache, speculation, unified/async rounds,
the front door and scheduler seams, W8A16 and int8-KV serving, the
recovery ladder and journal, the operations plane and sharding.
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
from .kv_cache import PagedKVCache, blocks_for

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
        its worst case, + 1).
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
    device: None -> CUDA (raises when absent); "cpu" for the plain path.
    """

    def __init__(self, model, *, max_slots=4, block_size=16,
                 max_prompt_len=None, max_new_tokens=32, num_blocks=None,
                 eos_token_id=None, temperature=0.0, seed=0,
                 steps_per_dispatch=1, prefill_chunk_tokens=512,
                 pack_align=None, detokenize=None, stop_tail_tokens=16,
                 device=None):
        self.device = resolve_device(device)
        cfg = model.cfg
        self.temperature = float(temperature)
        self.max_new = int(max_new_tokens)
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # a multi-step dispatch may write up to k-1 discarded tokens past
        # the budget: the blocks must be reservable
        self._overrun = self.steps_per_dispatch - 1
        self.max_prompt_len = int(
            max_prompt_len or cfg.max_position - self.max_new
            - self._overrun)
        if self.max_prompt_len + self.max_new + self._overrun \
                > cfg.max_position:
            raise ValueError(
                f"max_prompt_len ({self.max_prompt_len}) + max_new_tokens "
                f"({self.max_new}) + overrun slack ({self._overrun}, "
                f"steps_per_dispatch) exceeds max_position "
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
        self._params = {k: v.to(self.device)
                        for k, v in model.flat_params().items()}
        dt = self._params["ln_f.weight"].dtype
        self._m_width = blocks_for(
            self.max_prompt_len + self.max_new + self._overrun,
            self.block_size)
        if num_blocks is None:  # worst case: every slot at full horizon
            num_blocks = self.max_slots * self._m_width + 1
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            block_size=self.block_size, num_blocks=int(num_blocks),
            dtype=dt, device=self.device)
        self._decoder = PagedDecoder.for_config(cfg, self.block_size)
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
        self._stop_reasons = dict.fromkeys(STOP_REASONS, 0)

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
        multi-step overrun)."""
        return blocks_for(req.ids.size + req.budget + self._overrun,
                          self.block_size)

    def _install_slot_locked(self, i, req, worst):
        """Bind `req` to slot `i` (the caller checked the reservation)."""
        seq = self._seq_counter
        self._seq_counter += 1
        self._worst[seq] = worst
        # fed: prompt tokens already written to the cache — the slot is
        # in its PREFILL phase until fed == prompt length, then decodes
        self._slots[i] = {"seq": seq, "req": req, "toks": [],
                          "prompt": req.ids, "pos": req.ids.size,
                          "budget": req.budget, "fed": 0, "t_last": None}
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
                if self._stop:
                    return
                self._admit_locked()
                if all(s is None for s in self._slots):
                    self._lock.wait(timeout=0.1)
                    continue
            self._round_split()

    def _round_split(self):
        """One scheduler round: at most one packed chunk-prefill
        dispatch, then one decode dispatch, so in-flight decode never
        stalls longer than one chunk budget."""
        pre_idx = [i for i, s in enumerate(self._slots)
                   if s is not None and s["fed"] < s["prompt"].size]
        if pre_idx:
            self._prefill_packed(pre_idx)
        active_idx = [i for i, s in enumerate(self._slots)
                      if s is not None and s["fed"] >= s["prompt"].size]
        if active_idx:
            self._decode_plain(active_idx)

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
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
            if k == 1:
                nxt, stopped, _kc, _vc, counts = self._decoder.step(
                    *args, mode)
                toks = nxt.cpu().numpy()[None]        # [1, S]
                stops = stopped.cpu().numpy()[None]
            else:
                toks, stopped, _kc, _vc, counts = self._decoder.multistep(
                    k, mode)(*args)
                toks = toks.cpu().numpy()             # [k, S]
                stops = stopped.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — fail this dispatch's
            # requests, keep the engine serving
            self._dispatch_failure(e, list(active_idx))
            return
        self._sp_store.swap_counts(counts)
        t_now = time.perf_counter()
        with self._lock:
            self._steps += 1
            self._active_integral += len(active_idx)
        for i in active_idx:
            s = self._slots[i]
            t_prev = s["t_last"] if s["t_last"] is not None else t_now
            consumed = 0
            for j in range(toks.shape[0]):
                consumed += 1
                self._slot_token(i, int(toks[j, i]),
                                 device_stopped=bool(stops[j, i]))
                if self._slots[i] is None:  # finished mid-dispatch: the
                    break  # remaining tokens are discarded
            if self._slots[i] is not None:
                self._slots[i]["t_last"] = t_now
            per = max(t_now - t_prev, 0.0) / consumed
            with self._lock:
                self._itl.extend([per] * consumed)

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


__all__ = ["PagedGenerationServer", "STOP_REASONS"]
