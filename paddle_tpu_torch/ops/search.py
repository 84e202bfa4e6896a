"""Search ops of the port: `topk_impl`, the one top-k the sampling
processors share (the counterpart of `paddle_tpu.ops.search.topk_impl`).

Semantics, as the reference's:
  * largest-k gives values in descending order; ties go to the lower
    index;
  * smallest-k is a stable ascending sort, never a negation (which
    wraps for unsigned dtypes and INT_MIN);
  * in both directions the values are the sort's, so
    `vals == x.gather(axis, idx)` holds by construction.

Both directions are one `torch.sort(..., stable=True)`: `torch.topk`
does not specify its order among equal values. uint16 and uint32 input
is widened to int64 for the sort (torch's support of those dtypes is
partial) and the values come back in the input's dtype.
"""
from __future__ import annotations

import torch

# widened to int64 for the sort, exactly (uint8 sorts as it is)
_WIDEN = (torch.uint16, torch.uint32)


def topk_impl(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    """The k largest (or smallest) entries of `x` along `axis`: (values
    in x's dtype, int32 indices), ordered best first. `sorted` is
    accepted for the reference's signature; the result is always
    sorted."""
    axis = axis % x.ndim
    key = x.to(torch.int64) if x.dtype in _WIDEN else x
    vals, idx = torch.sort(key, dim=axis, descending=largest, stable=True)
    return (vals.narrow(axis, 0, k).to(x.dtype),
            idx.narrow(axis, 0, k).to(torch.int32))


__all__ = ["topk_impl"]
