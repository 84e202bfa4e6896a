"""Search, sort and index ops: the port of `paddle_tpu/ops/search.py`.

`topk_impl` is the one top-k the sampling processors share (the
counterpart of `paddle_tpu.ops.search.topk_impl`); semantics, as the
reference's:
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

The rest as the reference's, index outputs int64 (its are int32):
`argmax` / `argmin` take the first of equal values, `argsort` and `sort`
are stable (descending too), `kthvalue` is the k-th smallest with the
stable sort's index, `mode` the most frequent value (the smallest of
equally frequent ones) with the index of its last occurrence, `median`
the mean of the two middle values of an even count (torch.median takes
the lower one). `unique` and `unique_consecutive` are numpy's, computed
on the host as the reference does (their output shape depends on the
data): sorted values with first-occurrence indices, inverse and counts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod

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


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmax(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(_dt(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmin(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(_dt(dtype))


def argsort(x, axis=-1, descending=False):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    vals, idx = topk_impl(x, k, axis, largest, sorted)
    return vals, idx.long()


def kthvalue(x, k, axis=-1, keepdim=False):
    axis = axis % x.dim()
    vals, idx = torch.sort(x, dim=axis, stable=True)
    val = vals.select(axis, k - 1)
    ind = idx.select(axis, k - 1)
    if keepdim:
        val, ind = val.unsqueeze(axis), ind.unsqueeze(axis)
    return val, ind


def _mode_np(arr):
    """(value, index of its last occurrence) of the most frequent value
    of each row of a 2-D array (the smallest of equally frequent ones)."""
    vals = np.empty(arr.shape[0], arr.dtype)
    idx = np.empty(arr.shape[0], np.int64)
    for r, row in enumerate(arr):
        u, counts = np.unique(row, return_counts=True)
        vals[r] = u[np.argmax(counts)]
        idx[r] = np.flatnonzero(row == vals[r])[-1]
    return vals, idx


def mode(x, axis=-1, keepdim=False):
    axis = axis % x.dim()
    moved = torch.movedim(x, axis, -1)
    flat = moved.detach().cpu().reshape(-1, moved.shape[-1])
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    _, idx = _mode_np(flat.numpy())
    ind = torch.as_tensor(idx, device=x.device).reshape(moved.shape[:-1])
    val = torch.gather(moved, -1, ind.unsqueeze(-1)).squeeze(-1)
    if keepdim:
        val, ind = val.unsqueeze(axis), ind.unsqueeze(axis)
    return val, ind


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                           right=right)


def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def masked_select(x, mask):
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value):
    return torch.where(mask, value, x)


def _host(x):
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _back(arrays, x):
    outs = [torch.as_tensor(np.asarray(a), device=x.device) for a in arrays]
    return tuple(outs) if len(outs) > 1 else outs[0]


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    res = list(res) if isinstance(res, tuple) else [res]
    res[0] = res[0].astype(_host(x).dtype)
    out = _back(res, x)
    if isinstance(out, tuple):
        return (out[0].to(x.dtype),) + out[1:]
    return out.to(x.dtype)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    arr = _host(x)
    if axis is None:
        arr = arr.reshape(-1)
        keep = np.concatenate([[True], arr[1:] != arr[:-1]]) if arr.size \
            else np.zeros(0, bool)
        out, n = arr[keep], arr.size
    else:
        arr_m = np.moveaxis(arr, axis, 0)
        if arr_m.shape[0] == 0:
            keep = np.zeros(0, bool)
        else:
            flat = arr_m.reshape(arr_m.shape[0], -1)
            keep = np.concatenate([[True],
                                   ~(flat[1:] == flat[:-1]).all(axis=1)])
        out, n = np.moveaxis(arr_m[keep], 0, axis), arr_m.shape[0]
    rets = [out]
    if return_inverse:
        rets.append(np.cumsum(keep) - 1)
    if return_counts:
        rets.append(np.diff(np.append(np.flatnonzero(keep), n)))
    res = _back(rets, x)
    if isinstance(res, tuple):
        return (res[0].to(x.dtype),) + res[1:]
    return res.to(x.dtype)


def _float(x):
    return x if x.is_floating_point() else x.to(dtype_mod.convert_dtype(None))


def median(x, axis=None, keepdim=False):
    x = _float(x)
    if axis is None:
        out = torch.quantile(x.reshape(-1), 0.5)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.quantile(x, 0.5, dim=axis, keepdim=keepdim)


def quantile(x, q, axis=None, keepdim=False):
    x = _float(x)
    if axis is None:
        out = torch.quantile(x.reshape(-1), q)
        return out.reshape(out.shape + (1,) * x.dim()) if keepdim else out
    return torch.quantile(x, q, dim=axis, keepdim=keepdim)


def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    x = _float(x)
    if min == 0 and max == 0:
        min, max = float(x.min()), float(x.max())  # noqa: A001
    return torch.histc(x, bins, min, max).long()


__all__ = ["topk_impl", "argmax", "argmin", "argsort", "sort", "topk",
           "kthvalue", "mode", "searchsorted", "bucketize", "nonzero",
           "masked_select", "masked_fill", "unique", "unique_consecutive",
           "median", "quantile", "histogram"]
