"""Logits -> tokens for the greedy serving path, and the device stop check.

The port's slice 1 serves greedy requests only: `sample_tokens` is the
argmax of the float32 logits (ties go to the first maximum, as
`jnp.argmax` — never a sort). Sampled rows and penalties need the
reference's counter-based threefry streams bit for bit, which is a later
slice (the server refuses such requests at submit). `check_stops` and
`update_counts` are the reference's functions on torch tensors.
"""
from __future__ import annotations

import torch


def sample_tokens(logits):
    """[R, V] float32 logits -> [R] int32 greedy tokens (the reference's
    `sample_tokens` with sampled=False, penalties=False)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def update_counts(counts, rows, tok, inc):
    """Scatter-add emitted tokens into the [S, V] count buffer:
    counts[rows[r], tok[r]] += inc[r] (returns a new tensor)."""
    return counts.index_put((rows.long(), tok.long()), inc.to(counts.dtype),
                            accumulate=True)


def check_stops(tok, stop_matrix, active):
    """Device-side stop-token check: [R] tokens against the per-slot
    [R, W] stop-id matrix (-1-padded; generated ids are >= 0, so pad
    never matches). Returns [R] bool."""
    return active & (tok[:, None] == stop_matrix).any(dim=-1)


__all__ = ["sample_tokens", "update_counts", "check_stops"]
