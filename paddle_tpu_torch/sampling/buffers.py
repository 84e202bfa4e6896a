"""Struct-of-arrays slot parameter buffers of the serving engine: the port
of `paddle_tpu.sampling.buffers`.

`SlotParamStore` owns each decode slot's `SamplingParams`, its PRNG
seed, its stop-token id set, and the [n_slots, V] int32 token-count
buffer the penalty processors read. Admission scatters a request's
params into its slot row (`set_slot`); release resets the row to greedy
defaults (`clear_slot`), so the dispatch MODE — the (any-sampled,
any-penalties) pair that picks the decoder's variant — reflects the
resident requests only.

`step_args` / `packed_args` / `verify_args` / `unified_args` assemble
the argument dict one dispatch consumes, on the store's device: always
the stop-token matrix (-1 padded, width a power of two); the sampling
columns when any row samples; the penalty columns and the count buffer
when any row uses penalties. On the card the columns go up from
page-locked host memory without blocking the host (`_tensor`), so
assembling a dispatch's arguments never waits for the device.

The count buffer round-trips through the dispatch: the decoder returns
the updated tensor and the server copies it back into the store's
buffer with `swap_counts`, so the buffer keeps its address. It is
allocated on the device once a penalty-using request is admitted
(n_slots * V * 4 bytes: 8 slots of GPT-2's vocabulary are 1.6 MB).

`warm_args` / `warm_unified_args` / `warm_step_args` build all-padding
argument rows under a given mode, shaped like a live dispatch's (the
server's `warm_buckets` captures its graphs with them).
"""
from __future__ import annotations

import numpy as np
import torch

from .params import GREEDY, SamplingParams


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def host_to_device(a, device):
    """A numpy array as a tensor on `device`. To the card it goes from
    page-locked memory with a non-blocking copy: a copy from pageable
    memory would wait for every kernel queued before it. PyTorch's
    page-locked allocator keeps the buffer until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def greedy_args(rows, device):
    """Minimal all-greedy argument dict for direct decoder calls (tests
    and offline paths that want plain argmax with no stop ids)."""
    return {"stop": torch.full((int(rows), 1), -1, dtype=torch.int32,
                               device=device)}


GREEDY_MODE = (False, False)


class SlotParamStore:
    """Per-slot sampling parameters as struct-of-arrays buffers."""

    def __init__(self, n_slots, vocab_size, device):
        self.n = int(n_slots)
        self.V = int(vocab_size)
        self.device = torch.device(device)
        self._params: list[SamplingParams] = [GREEDY] * self.n
        self._seeds = np.zeros((self.n,), np.uint32)
        self._stop_ids: list[tuple] = [()] * self.n
        self._counts = None  # device [n, V] int32, lazy

    # ---- slot lifecycle ------------------------------------------------
    def set_slot(self, i, params, seed, eos=-1, prompt_ids=None):
        """Scatter one request's params into slot row i (admission or
        refill). The server-level EOS id joins the request's stop ids;
        `prompt_ids` seeds the penalty count row when the request uses
        penalties."""
        self._params[i] = params
        self._seeds[i] = np.uint32(int(seed) & 0xFFFFFFFF)
        ids = set(params.stop_token_ids)
        if eos is not None and eos >= 0:
            ids.add(int(eos))
        self._stop_ids[i] = tuple(sorted(ids))
        if params.uses_penalties and prompt_ids is not None:
            self.reset_counts_row(i, prompt_ids)

    def clear_slot(self, i):
        self._params[i] = GREEDY
        self._seeds[i] = 0
        self._stop_ids[i] = ()

    # ---- dispatch mode ---------------------------------------------------
    def mode(self, rows=None):
        """(any row samples, any row uses penalties) over `rows` (default:
        every slot)."""
        ps = (self._params if rows is None
              else [self._params[r] for r in rows])
        return (any(not p.is_greedy for p in ps),
                any(p.uses_penalties for p in ps))

    # ---- count buffer ----------------------------------------------------
    @property
    def counts(self):
        if self._counts is None:
            self._counts = torch.zeros((self.n, self.V), dtype=torch.int32,
                                       device=self.device)
        return self._counts

    def reset_counts_row(self, i, prompt_ids):
        row = np.bincount(np.asarray(prompt_ids, np.int64).reshape(-1),
                          minlength=self.V)[:self.V].astype(np.int32)
        self.counts[i] = self._tensor(row)

    def swap_counts(self, new):
        """Take the count buffer a dispatch returned (None when the
        dispatch ran a variant without penalties). It is copied into the
        store's own buffer, on the device's stream: a decode graph's
        output is overwritten by that graph's next replay."""
        if new is not None and new is not self._counts:
            self.counts.copy_(new)

    # ---- device argument assembly ----------------------------------------
    def _stop_matrix(self, rows):
        w = _pow2(max([len(self._stop_ids[r]) for r in rows] + [1]))
        m = np.full((len(rows), w), -1, np.int32)
        for j, r in enumerate(rows):
            ids = self._stop_ids[r]
            m[j, :len(ids)] = ids
        return m

    def _tensor(self, a):
        return host_to_device(a, self.device)

    def _assemble(self, rows, steps, mode):
        sampled, penalties = mode
        ps = [self._params[r] for r in rows]
        sp = {"stop": self._tensor(self._stop_matrix(rows))}
        if sampled:
            temp = np.array([p.temperature for p in ps], np.float32)
            sp["temperature"] = self._tensor(temp)
            sp["sample"] = self._tensor(temp > 0.0)
            sp["top_k"] = self._tensor(
                np.array([p.top_k for p in ps], np.int32))
            sp["top_p"] = self._tensor(
                np.array([p.top_p for p in ps], np.float32))
            sp["min_p"] = self._tensor(
                np.array([p.min_p for p in ps], np.float32))
            # uint32 seeds travel as int64 (torch's uint32 is partial)
            sp["seeds"] = self._tensor(
                self._seeds[list(rows)].astype(np.int64))
            sp["steps"] = self._tensor(np.asarray(steps, np.int32))
        if penalties:
            sp["rep"] = self._tensor(
                np.array([p.repetition_penalty for p in ps], np.float32))
            sp["pres"] = self._tensor(
                np.array([p.presence_penalty for p in ps], np.float32))
            sp["freq"] = self._tensor(
                np.array([p.frequency_penalty for p in ps], np.float32))
            sp["counts"] = self.counts
        return sp

    def step_args(self, steps):
        """Decode-dispatch arguments: one row per slot (row == slot).
        `steps` [n_slots] int32 = tokens generated so far per slot (the
        PRNG step counter). Returns (sp dict, mode)."""
        mode = self.mode()
        return self._assemble(list(range(self.n)), steps, mode), mode

    def packed_args(self, slot_rows, done_mask, steps=None):
        """Packed-prefill arguments for compact plan rows. `slot_rows`
        maps plan row -> slot index (None = padding row, which aliases
        slot 0's columns); `done_mask` marks rows whose prompt completes
        in this chunk (the only rows whose token-0 sample is real).
        `steps` [P] int32 is each row's PRNG base step (None = all
        zeros: a fresh prompt samples token 0 at step 0). Returns (sp
        dict, mode)."""
        real = [r for r in slot_rows if r is not None]
        mode = self.mode(real)
        rows = [r if r is not None else 0 for r in slot_rows]
        valid = np.array([r is not None for r in slot_rows], bool)
        if steps is None:
            steps = np.zeros((len(rows),), np.int32)
        sp = self._assemble(rows, steps, mode)
        if mode[0]:
            # padding rows must not sample (their seeds alias slot 0)
            sp["sample"] = sp["sample"] & self._tensor(valid)
        if mode[1]:
            sp["crows"] = self._tensor(np.array(rows, np.int32))
            sp["row_done"] = self._tensor(
                np.asarray(done_mask, bool) & valid)
        return sp, mode

    def verify_args(self, slot_rows, steps):
        """Speculative-verification arguments: compact plan rows as
        `packed_args`, plus per-row base PRNG steps. `slot_rows` maps plan
        row -> slot index (None = padding row, which aliases slot 0's
        columns; the verify program masks it by dlen == -1); `steps` [P]
        int32 is each row's generated-token count: verify position j
        samples at step base + j, the counter j sequential decode steps
        would fold in. Returns (sp dict, mode)."""
        real = [r for r in slot_rows if r is not None]
        mode = self.mode(real)
        rows = [r if r is not None else 0 for r in slot_rows]
        sp = self._assemble(rows, np.asarray(steps, np.int32), mode)
        if mode[1]:
            sp["crows"] = self._tensor(np.array(rows, np.int32))
        return sp, mode

    def unified_args(self, slot_rows, emit_rows, steps):
        """Unified-round arguments: compact plan rows as `verify_args`,
        over every row kind the round mixes. `emit_rows` marks rows whose
        samples are real (decode rows, verify rows, prefill rows whose
        prompt completes this round); still-feeding prefill rows and
        padding rows are left out of the MODE, never sample, and are
        masked on the device by dlen == -1. `steps` [P] int32 is each
        row's base PRNG step (the async carry overrides it on the device
        where steps_map names a slot). Returns (sp dict, mode)."""
        emit = list(emit_rows)
        real = [r for r, e in zip(slot_rows, emit) if r is not None and e]
        mode = self.mode(real)
        rows = [r if r is not None else 0 for r in slot_rows]
        sp = self._assemble(rows, np.asarray(steps, np.int32), mode)
        if mode[0]:
            # non-emitting rows must not sample (their seeds may alias
            # another slot's stream, and their token is discarded)
            sp["sample"] = sp["sample"] & self._tensor(
                np.asarray(emit, bool))
        if mode[1]:
            sp["crows"] = self._tensor(np.array(rows, np.int32))
        return sp, mode

    def _all_padding(self, rows, mode):
        """`_assemble` over `rows` at step 0 under `mode`, with no row
        sampling: the part every warm argument dict shares."""
        sp = self._assemble(rows, np.zeros((len(rows),), np.int32), mode)
        if mode[0]:
            sp["sample"] = sp["sample"] & self._tensor(
                np.zeros((len(rows),), bool))
        return sp

    def warm_unified_args(self, n_rows, mode=GREEDY_MODE):
        """`unified_args` SHAPED like a live dispatch for `n_rows`
        all-padding plan rows under `mode`: the same key set as a live
        call, every row masked from sampling."""
        rows = [0] * int(n_rows)
        sp = self._all_padding(rows, mode)
        if mode[1]:
            sp["crows"] = self._tensor(np.array(rows, np.int32))
        return sp

    def warm_args(self, n_rows, mode=GREEDY_MODE):
        """Packed-prefill argument dict SHAPED like a live dispatch for
        `n_rows` plan rows under `mode`, built from idle-slot defaults:
        every key a live `packed_args` call carries for that mode, with
        the same dtype and shape (stop-matrix width 1: the idle or
        single-stop-id case, the width a lone EOS id selects). No row
        samples. The port's packed prefill is eager and unbucketed, so
        `warm_buckets` does not call it (ROADMAP §C 8)."""
        sp = self.warm_unified_args(n_rows, mode)
        if mode[1]:
            sp["row_done"] = self._tensor(np.zeros((int(n_rows),), bool))
        return sp

    def warm_step_args(self, mode=GREEDY_MODE):
        """`step_args` SHAPED like a live decode dispatch (one row a
        slot) under `mode`, no row sampling: the decode graph's
        arguments for `warm_buckets`."""
        return self._all_padding(list(range(self.n)), mode)


__all__ = ["SlotParamStore", "GREEDY_MODE", "greedy_args", "host_to_device"]
