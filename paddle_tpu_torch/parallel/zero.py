"""The data-parallel axis of a mesh: the batch split, the mean of the
gradients, and ZeRO's shards.

Shared by the fleet's train step (`distributed.fleet.meta`: ZeRO stages
1-3) and the hybrid GPT-2's ZeRO-1 (`models.gpt2_hybrid.zero_update`).
A leaf is split on the first dim the dp size divides (the reference's
`_zero_spec`, `paddle_tpu/distributed/fleet/meta.py:181-187`; a leaf
with none stays whole), and each dp rank holds chunk i of it. The
collectives move every split leaf at once: one flat reduce-scatter, one
flat all-gather (`parallel.comm`, staged through the host for CUDA
tensors on gloo).
"""
from __future__ import annotations

import math

import torch

from . import comm
from .mesh import local_slice


def zero_dim(shape, n):
    """The first dim n divides, or None."""
    for i, s in enumerate(shape):
        if s % n == 0 and s >= n:
            return i
    return None


def _rows(t, dim, n):
    """t viewed [n, -1]: row i is chunk i along `dim`, flattened."""
    return t.movedim(dim, 0).reshape(n, -1)


def _unrows(flat, shape, dim):
    """Flat data laid out as `_rows` reads it -> a tensor of `shape`
    (a chunk's or a whole leaf's) whose chunks run along `dim`."""
    moved = [shape[dim]] + [s for i, s in enumerate(shape) if i != dim]
    return flat.reshape(moved).movedim(0, dim)


class DPAxis:
    """The dp axis of `mesh` as this rank sees it: its size `n`, its index
    `i`, its process group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size("dp")
        self.i = mesh.axis_index("dp") if mesh.member else 0
        self.group = mesh.group("dp")

    def rows(self, batch, k=1):
        """This rank's rows of the global batch {name: [B, ...]} (with
        k > 1, its rows of each of k microbatches: [k, B/k/n, ...])."""
        out = {}
        for name, x in batch.items():
            if k > 1:
                x = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
                out[name] = local_slice(x, (None, "dp"), self.mesh.coords,
                                        self.mesh.shape)
            else:
                out[name] = local_slice(x, ("dp",), self.mesh.coords,
                                        self.mesh.shape)
        return out

    def chunk(self, t, dim):
        """This rank's chunk of `t` along `dim` (a view)."""
        c = t.shape[dim] // self.n
        return t.narrow(dim, self.i * c, c)

    def mean_(self, tensors):
        """All-reduce the tensors' mean over dp in place (one buffer)."""
        if self.group is None or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        comm.all_reduce_(flat, self.group)
        flat.div_(self.n)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        return tensors

    def reduce_scatter_mean(self, grads, dims):
        """{name: full grad} -> {name: this rank's chunk of the mean over
        dp}, along each leaf's dim."""
        if self.group is None:
            return dict(grads)
        names = list(grads)
        rows = torch.cat([_rows(grads[n], dims[n], self.n) for n in names],
                         1)
        mine = comm.reduce_scatter(rows, self.group).div_(self.n)
        out, off = {}, 0
        for n in names:
            shape = list(grads[n].shape)
            shape[dims[n]] //= self.n
            k = math.prod(shape)
            out[n] = _unrows(mine[off:off + k], shape, dims[n])
            off += k
        return out

    def gather(self, chunks, dims):
        """{name: this rank's chunk} -> {name: the whole leaf}."""
        if self.group is None:
            return dict(chunks)
        names = list(chunks)
        flat = torch.cat([chunks[n].movedim(dims[n], 0).reshape(-1)
                          for n in names])
        parts = torch.stack(comm.all_gather(flat, self.group))
        out, off = {}, 0
        for n in names:
            k = chunks[n].numel()
            full = list(chunks[n].shape)
            full[dims[n]] *= self.n
            out[n] = _unrows(parts[:, off:off + k].reshape(-1), full,
                             dims[n])
            off += k
        return out

    def norm_fn(self):
        """fn(chunk) -> the norm of the whole leaf whose chunks the dp
        ranks hold (the squared norms all-reduced): Lamb's and Lars'
        trust ratios under ZeRO (`functional_update(norms=)`)."""
        def norm(x):
            sq = torch.sum(x * x).reshape(1)
            comm.all_reduce_(sq, self.group)
            return torch.sqrt(sq[0])
        return norm


__all__ = ["zero_dim", "DPAxis"]
