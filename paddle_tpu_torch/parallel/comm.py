"""Collectives over a mesh's axes, raw and differentiable.

The port's own module. Inside `shard_map` the reference gets the
gradients of its collectives from JAX's transpose rules; here each
collective that sits inside a differentiated computation is a
`torch.autograd.Function` with its backward written out:

  * `ppermute(tensors, axis)` — every rank sends to the next rank along
    `axis` and receives from the previous one (a ring); the gradients go
    back along the reverse ring. One `batch_isend_irecv` a call, for all
    the tensors it moves.
  * `reduce_from(x, axis)` — all-reduce forward, identity backward
    (Megatron's g: the partial sums of a split computation enter a
    computation every rank of `axis` repeats, and each rank then holds the
    full gradient of the repeated part);
  * `copy_to(x, axis)` — identity forward, all-reduce backward
    (Megatron's f: a tensor every rank holds enters a computation split
    over `axis`, whose ranks each hold part of its gradient);
  * `psum(x, axis)` — all-reduce both ways (JAX's psum and its
    transpose); `pmax(x, axis)` — the all-reduced max, detached (the
    reference detaches it, `gpt2_hybrid.py:259-263`: the softmax
    gradient is exact for any constant shift);
  * `all_to_all(x, axis, split_dim, concat_dim)` — the reference's tiled
    `lax.all_to_all`; its backward is the reverse all-to-all;
  * `scatter_to(x, axis, dim)` / `gather_from(x, axis, dim)` — this rank's
    chunk forward with an all-gather backward, and the reverse;
  * `mean_over(x, axes)` — the value averaged over `axes` (all-reduce),
    with a backward that only divides by their size: a loss every rank
    computes on its own data, whose gradients the caller sums over those
    axes afterwards.

Every function takes the mesh axis (a name or a tuple) and an optional
mesh (default: the current one). An axis of size 1, and the world of
one, make each of them the identity.

**Order.** A collective blocks until every rank of its group has entered
it, so every rank must issue its collectives in one order. Forward code
is SPMD: every rank runs the same Python, with rank-dependent values but
never rank-dependent collectives. In the backward, torch's engine runs
the ready node with the highest sequence number; the design keeps the
collectives of a backward on one chain, so that no two are ever ready at
once: the pipeline moves one activation a tick (tick t + 1's stage needs
the ppermute of tick t), the attention of a layer needs its MLP's
gradient, and ring attention's backward is explicit code inside one
Function (`parallel.ring_attention`), not autograd through its
ppermutes. A rotation moves k and v (and their gradients) in one
ppermute, so a ring is one chain, not two. Gradient reductions run after
the backward, in a fixed order over the leaves (`reduce_gradients`).

**Transport.** NCCL needs a card per rank; ranks that share a card run
gloo (`distributed.collective.resolve_backend`). Gloo takes CUDA tensors
only for `all_reduce` and `broadcast` (`GLOO_CUDA_OPS`); for every other
collective on a gloo group a CUDA tensor is staged through page-locked
host memory: copied out, moved on the host, copied back. `STAGED`
counts those calls, their bytes and their seconds; `transport(group)`
names what a group uses.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import resolve_mesh

GLOO_CUDA_OPS = ("all_reduce", "broadcast")
STAGED = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_staged():
    STAGED.update(calls=0, bytes=0, seconds=0.0)


def _backend(group):
    return dist.get_backend(group if group is not None else
                            dist.group.WORLD)


def _staged(group, tensor, op):
    return tensor.is_cuda and _backend(group) == "gloo" \
        and op not in GLOO_CUDA_OPS


def transport(group=None):
    """"nccl", or "gloo" with CUDA tensors staged through the host for
    every collective but all_reduce and broadcast."""
    b = _backend(group)
    return b if b != "gloo" else "gloo (host-staged but all_reduce/" \
        "broadcast)"


class _Stage:
    """Page-locked host copies of CUDA tensors, page-locked receive
    buffers, and their way back."""

    def __init__(self, tensors):
        self.t0 = time.perf_counter()
        self.device = tensors[0].device
        self.host = []
        for t in tensors:
            h = self.buffer(t)
            h.copy_(t)
            self.host.append(h)
            STAGED["bytes"] += t.numel() * t.element_size()

    @staticmethod
    def buffer(like):
        """An empty page-locked host tensor of `like`'s shape and dtype."""
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def back(self, outs):
        """Copy the host tensors `outs` into new device tensors."""
        res = [o.to(self.device, non_blocking=True) for o in outs]
        STAGED["calls"] += 1
        STAGED["seconds"] += time.perf_counter() - self.t0
        return res


# ---- raw collectives (no autograd) ------------------------------------------

def all_reduce_(x, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of `x` over `group` (None: identity; gloo
    takes CUDA tensors here)."""
    if group is None:
        return x
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x, group):
    """[tensor of each rank of `group`, in group order]."""
    if group is None:
        return [x]
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _staged(group, x, "all_gather"):
        st = _Stage([x])
        outs = [st.buffer(x) for _ in range(n)]
        dist.all_gather(outs, st.host[0], group=group)
        return st.back(outs)
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=group)
    return outs


def all_to_all_single(x, group):
    """x [n, ...]: row j goes to rank j of `group`; returns [n, ...] whose
    row i came from rank i."""
    if group is None:
        return x
    x = x.contiguous()
    if _staged(group, x, "all_to_all"):
        st = _Stage([x])
        out = st.buffer(x)
        dist.all_to_all_single(out, st.host[0], group=group)
        return st.back([out])[0]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def reduce_scatter(x, group):
    """x [n, ...] on every rank of `group` (n its size): the sum over the
    ranks of row i, on rank i. NCCL runs `reduce_scatter_tensor`; gloo,
    which has none, runs an all-to-all (staged for CUDA tensors) and
    sums the rows it received in rank order."""
    if group is None:
        return x[0]
    x = x.contiguous()
    if _backend(group) == "nccl":
        out = torch.empty_like(x[0])
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    return all_to_all_single(x, group).sum(0)


def broadcast_(x, src, group):
    """In-place broadcast from global rank `src` over `group`."""
    if group is None:
        return x
    dist.broadcast(x, src=src, group=group)
    return x


def shift(tensors, mesh, axis, step=1):
    """Send each tensor to the rank `step` ahead along `axis` and receive
    the same shapes from the rank `step` behind: one batch_isend_irecv.
    Returns the received tensors (the inputs when the axis has one rank)."""
    ranks = mesh.group_ranks(axis)
    n = len(ranks)
    if n == 1:
        return list(tensors)
    i = mesh.axis_index(axis)
    nxt, prv = ranks[(i + step) % n], ranks[(i - step) % n]
    tensors = [t.contiguous() for t in tensors]
    st = _Stage(tensors) if _staged(None, tensors[0], "p2p") else None
    send = st.host if st else tensors
    recv = [st.buffer(t) if st else torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt) for t in send] + \
        [dist.P2POp(dist.irecv, t, prv) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return st.back(recv) if st else recv


# ---- differentiable collectives ----------------------------------------------

class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, step, *tensors):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return tuple(shift(tensors, mesh, axis, step))

    @staticmethod
    def backward(ctx, *grads):
        back = shift(grads, ctx.mesh, ctx.axis, -ctx.step)
        return (None, None, None, *back)


def ppermute(tensors, axis, mesh=None, step=1):
    """The reference's `lax.ppermute` with perm [(j, j + 1 mod n)]: each
    tensor of `tensors` (one tensor or a tuple) moves to the next rank
    along `axis`; differentiable (the gradients move back)."""
    mesh = resolve_mesh(mesh)
    single = torch.is_tensor(tensors)
    ts = (tensors,) if single else tuple(tensors)
    if mesh.size(axis) == 1:
        return tensors
    out = _Shift.apply(mesh, axis, step, *ts)
    return out[0] if single else out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce_(x.clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def reduce_from(x, axis, mesh=None):
    """Megatron's g: all-reduce (sum) forward, identity backward."""
    g = resolve_mesh(mesh).group(axis)
    return x if g is None else _ReduceFrom.apply(x, g, dist.ReduceOp.SUM)


def copy_to(x, axis, mesh=None):
    """Megatron's f: identity forward, all-reduce (sum) backward."""
    g = resolve_mesh(mesh).group(axis)
    return x if g is None else _CopyTo.apply(x, g)


def psum(x, axis, mesh=None):
    """All-reduce (sum) forward and backward: JAX's psum and transpose."""
    g = resolve_mesh(mesh).group(axis)
    return x if g is None else _PSum.apply(x, g)


def pmax(x, axis, mesh=None):
    """The max over `axis`, detached (no gradient)."""
    g = resolve_mesh(mesh).group(axis)
    x = x.detach()
    return x if g is None else all_reduce_(x.clone(), g, dist.ReduceOp.MAX)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_reduce_(x.detach().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def mean_over(x, axes, mesh=None):
    """The mean of `x` over the ranks of `axes` (the value every rank of
    the slice then holds); its backward divides the gradient by their
    count and moves nothing — each rank differentiates its own share."""
    mesh = resolve_mesh(mesh)
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if mesh.size(a) > 1)
    if not axes:
        return x
    return _MeanOver.apply(x, mesh.group(axes), mesh.size(axes))


def _a2a(x, mesh, axis, split_dim, concat_dim):
    """Tiled all-to-all: split `split_dim` into n chunks, chunk j to rank
    j; concatenate what rank i sent at position i of `concat_dim`."""
    n = mesh.size(axis)
    shp = list(x.shape)
    c = shp[split_dim] // n
    # [n, ...] with the chunk index leading
    xs = x.reshape(shp[:split_dim] + [n, c] + shp[split_dim + 1:])
    xs = xs.movedim(split_dim, 0).contiguous()
    ys = all_to_all_single(xs, mesh.group(axis))
    # ys[i]: rank i's chunk for me (x's shape, split_dim of size c); put
    # the rank index just before concat_dim and merge the two
    ys = ys.movedim(0, concat_dim)
    shp = list(ys.shape)
    return ys.reshape(shp[:concat_dim] + [shp[concat_dim] *
                                          shp[concat_dim + 1]]
                      + shp[concat_dim + 2:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _a2a(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return _a2a(g, mesh, axis, concat_dim, split_dim), None, None, \
            None, None


def all_to_all(x, axis, split_dim, concat_dim, mesh=None):
    """The reference's `lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)`; differentiable."""
    mesh = resolve_mesh(mesh)
    if mesh.size(axis) == 1:
        return x
    if x.shape[split_dim] % mesh.size(axis):
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over "
                         f"{mesh.size(axis)} ranks")
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def _chunk(x, mesh, axis, dim):
    n = mesh.size(axis)
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * c, c)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _chunk(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return torch.cat(all_gather(g, mesh.group(axis)), dim), None, None, \
            None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return torch.cat(all_gather(x, mesh.group(axis)), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _chunk(g, mesh, axis, dim).contiguous(), None, None, None


def scatter_to(x, axis, dim, mesh=None):
    """This rank's chunk of `x` along `dim`; backward all-gathers."""
    mesh = resolve_mesh(mesh)
    return x if mesh.size(axis) == 1 else \
        _ScatterTo.apply(x, mesh, axis, dim)


def gather_from(x, axis, dim, mesh=None):
    """Every rank's `x` concatenated along `dim`; backward keeps this
    rank's chunk."""
    mesh = resolve_mesh(mesh)
    return x if mesh.size(axis) == 1 else \
        _GatherFrom.apply(x, mesh, axis, dim)


@torch.no_grad()
def reduce_gradients(grads, axes_of, mesh=None):
    """Sum gradients over mesh axes, in place. grads: {name: tensor};
    axes_of(name) -> the axes to sum that leaf over. Leaves with the same
    axes go in one flat buffer (one all-reduce per set of axes), in the
    order of `grads` — the same on every rank."""
    mesh = resolve_mesh(mesh)
    buckets = {}
    for name, g in grads.items():
        axes = tuple(a for a in axes_of(name) if mesh.size(a) > 1)
        if axes:
            buckets.setdefault((axes, g.dtype, g.device), []).append(name)
    for (axes, _dt, _dev), names in buckets.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        all_reduce_(flat, mesh.group(axes))
        off = 0
        for n in names:
            k = grads[n].numel()
            grads[n].copy_(flat[off:off + k].view_as(grads[n]))
            off += k
    return grads


__all__ = ["GLOO_CUDA_OPS", "STAGED", "reset_staged", "transport",
           "all_reduce_", "all_gather", "all_to_all_single", "reduce_scatter",
           "broadcast_",
           "shift", "ppermute", "reduce_from", "copy_to", "psum", "pmax",
           "mean_over", "all_to_all", "scatter_to", "gather_from",
           "reduce_gradients"]
