"""Host-side verification planning: pack per-slot draft proposals into
the ONE ragged dispatch `nn.decode.packed_verify` scores (the port of
`paddle_tpu.spec_decode.verifier`).

The plan layout mirrors the packed-prefill contract
(inference/serving.py `_prefill_packed`): each speculating slot
contributes a region `[last_token, draft_1 .. draft_k]` of a pinned
width, `align * ceil((K + 1) / align)` tokens, and the plan row count P
is a power of two, so a server captures ONE verify graph per sampling
mode. The server's `align` is 1 (`_verify_align`): the Hopper K1 takes
per-token segments and needs no query-tile alignment, as the reference's
fallback off the TPU. `sample_idx` is the per-row [K1] readout matrix
over the packed stream, and `dlen` carries each row's draft count and
marks padding rows (dlen == -1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class VerifyPlan:
    """One round's packed verification plan.

    slots: plan row -> server slot index (real rows only; the device
        arrays are padded to `P` rows).
    drafts: per real row, the proposed tokens (1..K each).
    write_pos: per real row, the cache position its last emitted token
        is written at — drafts occupy write_pos+1 .. write_pos+k, and
        rollback truncates the sequence to write_pos + accepted + 1.
    toks/seg/pos: the packed [T] stream (pos -1 marks packing pad).
    sample_idx: [P, K1] int32 — packed index of each row's verify
        position (clamped to the region end past the row's drafts).
    dlen: [P] int32 draft counts; 0 is a real row with no drafts this
        round (one verify position = one decode step, so draft-free
        decode slots ride the same dispatch instead of forcing a
        second, plain dispatch into the round); -1 marks a padding row.
    steps: [P] int32 base PRNG step per row (generated-token count).
    """

    slots: list
    drafts: list
    write_pos: list
    toks: np.ndarray
    seg: np.ndarray
    pos: np.ndarray
    sample_idx: np.ndarray
    dlen: np.ndarray
    steps: np.ndarray

    @property
    def rows(self):
        return len(self.slots)

    def grow_updates(self, seqs):
        """(seq, new_len) pairs covering every row's speculative write
        horizon, for one atomic `PagedKVCache.ensure_many`."""
        return [(seqs[r], self.write_pos[r] + len(self.drafts[r]) + 1)
                for r in range(len(self.slots))]


def build_verify_plan(entries, max_draft_tokens, pack_align,
                      min_rows=None):
    """Assemble a `VerifyPlan` from per-slot proposals.

    entries: list of (slot_idx, last_token, write_pos, base_step,
        drafts) — drafts a 1-D int array of <= K proposals (empty =
        the slot rides along draft-free and emits its one plain-decode
        token from the shared dispatch).
    max_draft_tokens: K — fixes the readout width K1 = K + 1 so the
        verify program never specializes per draft-count combination.
    pack_align: the packed-region alignment (the serving engine's
        `_pack_align`).
    min_rows: pad the plan to at least this many rows (the server
        passes max_slots).

    The plan shape is PINNED, not content-sized: every region spans
    `align * ceil(K1 / align)` tokens and the row count buckets to
    pow2(max(rows, min_rows)), so a server captures ONE verify graph
    per sampling mode — verification runs every scheduler round, and
    per-round shape churn would mean a capture per round.

    Returns None when `entries` is empty.
    """
    if not entries:
        return None
    align = int(pack_align)
    K1 = int(max_draft_tokens) + 1
    region = -(-K1 // align) * align
    offsets = [r * region for r in range(len(entries))]
    P = _pow2(max(len(entries), int(min_rows or 1)))
    T = P * region
    toks = np.zeros((T,), np.int32)
    seg = np.zeros((T,), np.int32)
    pos = np.full((T,), -1, np.int32)
    sample_idx = np.zeros((P, K1), np.int32)
    dlen = np.full((P,), -1, np.int32)      # -1 = padding row
    steps = np.zeros((P,), np.int32)
    slots, all_drafts, write_pos = [], [], []
    for r, (slot, last, wpos, step, drafts) in enumerate(entries):
        drafts = np.asarray(drafts, np.int32).reshape(-1)
        k = int(drafts.size)
        o = offsets[r]
        toks[o] = int(last)
        toks[o + 1:o + 1 + k] = drafts
        seg[o:o + 1 + k] = r
        pos[o:o + 1 + k] = np.arange(wpos, wpos + 1 + k, dtype=np.int32)
        # readout j for j <= k; clamped past the region so the gather
        # stays in-bounds (the device masks those positions via dlen)
        sample_idx[r] = o + np.minimum(np.arange(K1), k)
        dlen[r] = k
        steps[r] = int(step)
        slots.append(slot)
        all_drafts.append(drafts)
        write_pos.append(int(wpos))
    return VerifyPlan(slots=slots, drafts=all_drafts,
                      write_pos=write_pos, toks=toks, seg=seg, pos=pos,
                      sample_idx=sample_idx, dlen=dlen, steps=steps)
