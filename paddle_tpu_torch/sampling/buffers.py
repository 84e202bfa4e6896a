"""Per-slot sampling state of the serving engine — the greedy subset.

`SlotParamStore` owns each decode slot's `SamplingParams` and stop-token
id set, and assembles the argument dict one decode or packed-prefill
dispatch consumes: the [rows, W] stop-token matrix (-1-padded, W a power
of two), on the store's device. The dispatch MODE — the (any-sampled,
any-penalties) pair the reference uses to pick a compiled variant — is
always the greedy pair here, because the server refuses sampled and
penalized requests at `submit` (they come with the sampling slice).
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


def check_greedy(params):
    """Raise unless `params` decodes greedily without penalties — the
    only requests this slice of the port serves."""
    if not params.is_greedy or params.uses_penalties:
        raise ValueError(
            "this slice of the port serves greedy requests only "
            "(temperature=0, no repetition/presence/frequency penalty); "
            "sampled decoding and penalties come with the sampling slice "
            "(bit-exact threefry streams)")


class SlotParamStore:
    """Per-slot sampling parameters and stop-id sets (greedy subset)."""

    def __init__(self, n_slots, device):
        self.n = int(n_slots)
        self.device = torch.device(device)
        self._params: list[SamplingParams] = [GREEDY] * self.n
        self._stop_ids: list[tuple] = [()] * self.n

    # ---- slot lifecycle ------------------------------------------------
    def set_slot(self, i, params, eos=-1):
        """Scatter one request's params into slot row i; the server-level
        EOS id joins the request's stop ids."""
        check_greedy(params)
        self._params[i] = params
        ids = set(params.stop_token_ids)
        if eos is not None and eos >= 0:
            ids.add(int(eos))
        self._stop_ids[i] = tuple(sorted(ids))

    def clear_slot(self, i):
        self._params[i] = GREEDY
        self._stop_ids[i] = ()

    # ---- device argument assembly --------------------------------------
    def _stop_matrix(self, rows):
        w = _pow2(max([len(self._stop_ids[r]) for r in rows] + [1]))
        m = np.full((len(rows), w), -1, np.int32)
        for j, r in enumerate(rows):
            ids = self._stop_ids[r]
            m[j, :len(ids)] = ids
        return m

    def _assemble(self, rows):
        return {"stop": torch.from_numpy(self._stop_matrix(rows))
                .to(self.device)}

    def step_args(self):
        """Decode-dispatch arguments: one row per slot (row == slot)."""
        return self._assemble(list(range(self.n)))

    def packed_args(self, slot_rows):
        """Packed-prefill arguments for compact plan rows: `slot_rows`
        maps plan row -> slot index (None = padding row, which aliases
        slot 0's stop ids; its sample is discarded)."""
        return self._assemble([r if r is not None else 0
                               for r in slot_rows])


__all__ = ["SlotParamStore", "greedy_args", "check_greedy"]
