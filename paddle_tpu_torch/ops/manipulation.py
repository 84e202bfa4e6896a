"""Shape and layout ops: the port of `paddle_tpu/ops/manipulation.py`,
with the reference's semantics where torch's same-named call differs:

  * `split(x, n)` with an int cuts `n` equal sections (not sections of
    size n), and a list of sizes may hold one -1, inferred
    (`manipulation.py:64-79`);
  * `chunk` cuts like numpy's array_split (the first parts one longer);
  * `gather(x, index, axis)` is an index select along `axis` (an index
    of shape [N, 1] counts as [N]; an N-d index puts its shape at
    `axis`), not torch's elementwise gather (`:139`);
  * `scatter(x, index, updates, overwrite)` writes whole rows of `x`:
    overwrite=True sets them, overwrite=False ADDS the updates to x's
    rows, as the reference's `x.at[index].add` does (`:178`);
  * `pad(x, pad)` with 2·ndim numbers pads every dim in order from dim 0
    ([d0_lo, d0_hi, d1_lo, ...]); a shorter list pads the trailing
    spatial dims from the last back ([left, right, top, bottom, ...]),
    before the channels for a channels-last `data_format` (`:233`);
    "reflect", "replicate" and "circular" pad any dims;
  * `expand` keeps a dim given as -1; `squeeze(axis)` drops only those
    of the given axes that have size 1; `unsqueeze` inserts its axes in
    ascending order of the result's positions;
  * `slice` / `strided_slice` take Python slice bounds per axis (a
    negative stride too).
Index outputs are int64 (the reference's are int32, see core.dtype).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtype_mod


def reshape(x, shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    return torch.reshape(x, tuple(int(s) for s in shape))


def transpose(x, perm):
    return x.permute(*[int(p) for p in perm])


def t(x):
    return x if x.dim() < 2 else x.transpose(-1, -2)


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2):
    return torch.transpose(x, axis1, axis2)


def concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


def stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


def split(x, num_or_sections, axis=0):
    axis = int(axis)
    n = x.shape[axis]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"split: dim {axis} of size {n} does not "
                             f"divide into {num_or_sections} sections")
        return tuple(torch.split(x, n // num_or_sections, dim=axis))
    secs = [int(s) for s in num_or_sections]
    if -1 in secs:
        secs[secs.index(-1)] = n - sum(s for s in secs if s != -1)
    return tuple(torch.split(x, secs, dim=axis))


def chunk(x, chunks, axis=0):
    return tuple(torch.tensor_split(x, chunks, dim=int(axis)))


def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=axis))


unbind = unstack


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    final = x.dim() + len(axes)
    for a in sorted(a % final for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def _index_along(x, axis, sl):
    """x[..., sl, ...] on `axis` for any Python slice (negative steps by
    an index select)."""
    if sl.step is None or sl.step > 0:
        idx = [builtins.slice(None)] * x.dim()
        idx[axis] = sl
        return x[tuple(idx)]
    keep = list(range(x.shape[axis]))[sl]
    return x.index_select(axis, torch.tensor(keep, dtype=torch.long,
                                             device=x.device))


def slice(x, axes, starts, ends):  # noqa: A001
    for a, s, e in zip(axes, starts, ends):
        x = _index_along(x, int(a), builtins.slice(int(s), int(e)))
    return x


def strided_slice(x, axes, starts, ends, strides):
    for a, s, e, st in zip(axes, starts, ends, strides):
        x = _index_along(x, int(a),
                         builtins.slice(int(s), int(e), int(st)))
    return x


def _long(index):
    if not torch.is_tensor(index):
        index = torch.as_tensor(np.asarray(index))
    return index.long()


def gather(x, index, axis=0):
    index = _long(index).to(x.device)
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    axis = int(axis) % x.dim()
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


def gather_nd(x, index):
    index = _long(index).to(x.device)
    return x[tuple(torch.movedim(index, -1, 0))]


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, _long(indices), dim=axis)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    indices = _long(indices)
    if not torch.is_tensor(values):
        values = torch.as_tensor(values, dtype=x.dtype, device=x.device)
    values = torch.broadcast_to(values.to(x.dtype), indices.shape)
    if reduce == "add":
        return x.scatter_add(axis, indices, values)
    return x.scatter(axis, indices, values)


def scatter(x, index, updates, overwrite=True):
    index = _long(index).to(x.device)
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    return x.index_put((index,), updates, accumulate=not overwrite)


def scatter_nd_add(x, index, updates):
    idx = tuple(torch.movedim(_long(index).to(x.device), -1, 0))
    return x.index_put(idx, updates, accumulate=True)


def scatter_nd(index, updates, shape):
    base = torch.zeros(tuple(shape), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


def tile(x, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


def expand(x, shape):
    shape = list(shape)
    x_shape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    out = tuple(x_shape[i] if shape[i] == -1 else int(shape[i])
                for i in range(len(shape)))
    return x.reshape(x_shape).expand(out)


def expand_as(x, y):
    return x.expand_as(y)


def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


def broadcast_tensors(xs):
    return tuple(torch.broadcast_tensors(*xs))


def _pad_widths(nd, pad, data_format):
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    k = len(pad) // 2
    width = [(0, 0)] * nd
    dims = list(range(nd - 1 - k, nd - 1)) if data_format.endswith("C") \
        else list(range(nd - k, nd))
    for i, d in enumerate(reversed(dims)):
        width[d] = (pad[2 * i], pad[2 * i + 1])
    return width


def _pad_index(n, lo, hi, mode):
    """The source index of every position of a dim padded by (lo, hi)."""
    pos = np.arange(-lo, n + hi)
    if mode == "replicate":
        return np.clip(pos, 0, n - 1)
    if mode == "circular":
        return pos % n
    period = 2 * (n - 1)  # reflect, the edge not repeated
    m = np.abs(pos) % period if period else np.zeros_like(pos)
    return np.where(m < n, m, period - m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    if torch.is_tensor(pad):
        pad = pad.tolist()
    width = _pad_widths(x.dim(), [int(p) for p in pad], data_format)
    if mode == "constant":
        flat = []
        for lo, hi in reversed(width):
            flat += [lo, hi]
        return F.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            idx = _pad_index(x.shape[d], lo, hi, mode)
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


def flip(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, tuple(axes))


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, axis)


def cast(x, dtype):
    return x.to(dtype_mod.convert_dtype(dtype))


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def index_select(x, index, axis=0):
    return x.index_select(axis, _long(index).to(x.device).reshape(-1))


def index_sample(x, index):
    return torch.take_along_dim(x, _long(index), dim=1)


def where(condition, x=None, y=None):
    if x is None and y is None:
        raise ValueError("where with only condition: use nonzero")
    return torch.where(condition, x, y)


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    return torch.where(x // size == shard_id, x % size, ignore_value)


def as_real(x):
    return torch.view_as_real(x)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def real(x):
    return torch.real(x)


def imag(x):
    return torch.imag(x)


def conj(x):
    return torch.conj(x)


def crop(x, shape, offsets=None):
    offsets = offsets or [0] * x.dim()
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


def getitem(x, idx):
    return x[idx]


def setitem(x, idx, value):
    """x with x[idx] = value, out of place (x is not changed)."""
    out = x.clone()
    out[idx] = value
    return out


__all__ = ["reshape", "transpose", "t", "moveaxis", "swapaxes", "concat",
           "stack", "split", "chunk", "unstack", "unbind", "squeeze",
           "unsqueeze", "flatten", "slice", "strided_slice", "gather",
           "gather_nd", "take_along_axis", "put_along_axis", "scatter",
           "scatter_nd_add", "scatter_nd", "tile", "expand", "expand_as",
           "broadcast_to", "broadcast_tensors", "pad", "flip", "rot90",
           "roll", "cast", "repeat_interleave", "index_select",
           "index_sample", "where", "shard_index", "as_real", "as_complex",
           "real", "imag", "conj", "crop", "getitem", "setitem"]
