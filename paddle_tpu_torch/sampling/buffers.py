"""Struct-of-arrays slot parameter buffers of the serving engine: the port
of `paddle_tpu.sampling.buffers`.

`SlotParamStore` owns each decode slot's `SamplingParams`, its PRNG
seed, its stop-token id set, and the [n_slots, V] int32 token-count
buffer the penalty processors read. Admission scatters a request's
params into its slot row (`set_slot`); release resets the row to greedy
defaults (`clear_slot`), so the dispatch MODE — the (any-sampled,
any-penalties) pair that picks the decoder's variant — reflects the
resident requests only.

`step_args` / `packed_args` assemble the argument dict one dispatch
consumes, on the store's device: always the stop-token matrix (-1
padded, width a power of two); the sampling columns when any row
samples; the penalty columns and the count buffer when any row uses
penalties.

The count buffer round-trips through the dispatch: the decoder returns
the updated tensor and the server reinstalls it with `swap_counts`. It
is allocated on the device once a penalty-using request is admitted
(n_slots * V * 4 bytes: 8 slots of GPT-2's vocabulary are 1.6 MB).

Left for later slices: `verify_args` (speculation) and `unified_args`
(the unified round), and `warm_args` / `warm_unified_args` (the
shape-bucket pre-warm).
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
        self.counts[i] = torch.from_numpy(row).to(self.device)

    def swap_counts(self, new):
        """Reinstall the count buffer a dispatch returned (None when the
        dispatch ran a variant without penalties)."""
        if new is not None:
            self._counts = new

    # ---- device argument assembly ----------------------------------------
    def _stop_matrix(self, rows):
        w = _pow2(max([len(self._stop_ids[r]) for r in rows] + [1]))
        m = np.full((len(rows), w), -1, np.int32)
        for j, r in enumerate(rows):
            ids = self._stop_ids[r]
            m[j, :len(ids)] = ids
        return m

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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


__all__ = ["SlotParamStore", "GREEDY_MODE", "greedy_args"]
