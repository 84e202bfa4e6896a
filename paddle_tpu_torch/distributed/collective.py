"""Distributed collectives.

The port of `paddle_tpu/distributed/collective.py`. The reference runs
SPMD inside one process, where a "process group" is a partition of a
mesh axis (`axis_index_groups`) and eager calls outside a trace are the
identity. The port is one process per rank over torch.distributed:

  * `init_parallel_env` joins the world (rank and size from the
    arguments, or PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM, or RANK /
    WORLD_SIZE; the rendezvous from `init_method`, PADDLE_DIST_INIT_METHOD
    or env://). `backend=None` resolves to NCCL when every rank has a card
    of its own and to gloo when ranks share one card or run on the CPU;
    NCCL asked for on a shared card raises, naming the fix. Without it
    the world is one rank and every collective the identity.
  * `new_group(ranks)` keeps the reference's partition: the members form
    one group and the other ranks another (`axis_index_groups`), or, for
    gather-style collectives, blocks of the group's size; a group that
    does not divide the world evenly is refused for those ("equal-sized",
    `test_distributed.py:614`). It is collective: every rank calls it.
  * Each collective acts on the caller's block of that partition: a
    member with its group, another rank with its own block, as the
    reference's SPMD lowering does. `reduce` leaves every rank but `dst`
    (a global rank) with its input; `scatter` delivers `tensor_list[i]`
    of the source rank to rank i of the group (non-members keep theirs).

The quantized all-reduce (EQuARX pattern) and its wire-byte accounting
are the reference's algorithms over the mesh axes of `parallel.comm`.
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist

from ..parallel import comm
from ..parallel.mesh import resolve_mesh


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX:
              dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


def _initialized():
    return dist.is_available() and dist.is_initialized()


def _pg(ranks):
    """The torch group of `ranks` (None for one rank); collective."""
    from ..parallel.mesh import _group
    return _group(sorted(ranks))


class Group:
    """A process group over global `ranks`, with the reference's
    partition of the world: `axis_index_groups` = [ranks, the rest] (the
    rest reduce among themselves) and `uniform_axis_index_groups` (blocks
    of the group's size, or None when the rest does not divide)."""

    def __init__(self, ranks, gid):
        world = get_world_size()
        self.ranks = sorted(int(r) for r in ranks)
        if any(r < 0 or r >= world for r in self.ranks):
            raise ValueError(f"ranks {ranks} outside world of size {world}")
        self.id = gid
        self.nranks = len(self.ranks)
        rest = [r for r in range(world) if r not in self.ranks]
        self.axis_index_groups = [self.ranks] + ([rest] if rest else [])
        n = self.nranks
        if len(rest) % n == 0:
            self.uniform_axis_index_groups = [self.ranks] + [
                rest[i:i + n] for i in range(0, len(rest), n)]
        else:
            self.uniform_axis_index_groups = None
        self._pgs = {}
        if _initialized():
            for blocks in (self.axis_index_groups,
                           self.uniform_axis_index_groups or []):
                for b in blocks:
                    self._pgs[tuple(b)] = _pg(b)

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self

    def block(self, uniform=False):
        """(global ranks, torch group) of this rank's block."""
        blocks = self.uniform_axis_index_groups if uniform else \
            self.axis_index_groups
        if blocks is None:
            raise ValueError(
                f"group of {self.nranks} ranks cannot partition a world of "
                f"{get_world_size()} into equal-sized replica groups — "
                f"gather-style collectives need len(world) % len(group) "
                f"== 0")
        me = get_rank()
        for b in blocks:
            if me in b:
                return b, self._pgs.get(tuple(b))
        return [me], None

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_group_registry = {}
_WORLD_GROUP_ID = 0


def new_group(ranks=None, backend=None, timeout=None):
    """A group over `ranks` (global). Every rank calls it."""
    if ranks is None:
        ranks = list(range(get_world_size()))
    gid = len(_group_registry) + 1
    g = Group(ranks, gid)
    _group_registry[gid] = g
    return g


def get_group(gid=0):
    if gid == _WORLD_GROUP_ID:
        return Group(range(get_world_size()), _WORLD_GROUP_ID)
    return _group_registry.get(gid)


def _block(group, uniform=False):
    """(global ranks, torch group) the caller's collective runs over."""
    if group is None:
        world = get_world_size()
        return list(range(world)), (dist.group.WORLD if world > 1 else None)
    return group.block(uniform)


class ParallelEnv:
    def __init__(self):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.local_rank = int(os.environ.get("LOCAL_RANK", self.rank))
        self.device_id = self.local_rank % max(1, torch.cuda.device_count()) \
            if torch.cuda.is_available() else 0
        self.nranks = self.world_size

    @property
    def dev_id(self):
        return self.device_id


def rank_device(device=None):
    """This rank's device: `device` if given, else cuda:{LOCAL_RANK %
    device_count}; raises without a card (pass "cpu")."""
    from ..device import resolve_device
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _local_world():
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("PADDLE_TRAINERS_NUM",
                                             get_world_size())))


def resolve_backend(backend=None, device=None):
    """The backend for ranks on `device`: NCCL when every local rank has
    a card of its own, gloo when they share one or run on the CPU. NCCL
    asked for on a shared card raises."""
    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"
    shared = on_card and _local_world() > torch.cuda.device_count()
    if backend is None:
        return "nccl" if on_card and not shared else "gloo"
    if backend == "nccl" and shared:
        raise RuntimeError(
            f"backend 'nccl' with {_local_world()} ranks on "
            f"{torch.cuda.device_count()} card(s): NCCL refuses two ranks "
            f"on one device ('Duplicate GPU detected'); pass backend=None "
            f"or 'gloo' when ranks share a card")
    return backend


def init_parallel_env(backend=None, init_method=None, rank=None,
                      world_size=None, device=None, timeout=None):
    """Join the world (module docstring) and return the ParallelEnv. A
    second call, or a world of one, only returns it. The backend follows
    `device` (None: this rank's card, `rank_device`, which raises
    without one; pass "cpu" for a gloo world on the CPU)."""
    if _initialized():
        return ParallelEnv()
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID",
                                  os.environ.get("RANK", 0)))
    if world_size is None:
        world_size = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                        os.environ.get("WORLD_SIZE", 1)))
    if world_size > 1:
        init_method = init_method or os.environ.get(
            "PADDLE_DIST_INIT_METHOD", "env://")
        # the backend reads the local world from the environment; a join
        # that fails leaves the environment as it found it
        set_here = "PADDLE_TRAINERS_NUM" not in os.environ
        os.environ.setdefault("PADDLE_TRAINERS_NUM", str(world_size))
        try:
            b = resolve_backend(backend, rank_device(device))
            kw = {} if timeout is None else {"timeout": timeout}
            dist.init_process_group(b, init_method=init_method, rank=rank,
                                    world_size=world_size, **kw)
        except BaseException:
            if set_here:
                del os.environ["PADDLE_TRAINERS_NUM"]
            raise
        atexit.register(_leave)
    return ParallelEnv()


def _leave():
    """At exit, destroy the default group in order: left to the
    interpreter's teardown, a rank whose peer has already gone can abort
    in gloo's threads ("terminate called without an active exception")
    after its work is done."""
    if _initialized():
        dist.destroy_process_group()


def is_initialized():
    return _initialized()


def get_rank(group=None):
    r = dist.get_rank() if _initialized() else \
        int(os.environ.get("PADDLE_TRAINER_ID", 0))
    if group is not None:
        return group.get_group_rank(r)
    return r


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))


def _unwrap(t):
    return t if torch.is_tensor(t) else torch.as_tensor(t)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce over the caller's block (uneven groups
    allowed: the members reduce together, the rest among themselves)."""
    ranks, pg = _block(group)
    comm.all_reduce_(tensor, pg, _TORCH_OPS.get(op, dist.ReduceOp.SUM))
    if op == ReduceOp.AVG and pg is not None:
        tensor.div_(len(ranks))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    ranks, pg = _block(group, uniform=True)
    parts = comm.all_gather(_unwrap(tensor), pg)
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(parts)
        return tensor_list
    return parts


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Replicate `src`'s value over the group (src a global rank); a rank
    outside it takes the same slot of its own block."""
    ranks, pg = _block(group, uniform=True)
    slot = group.get_group_rank(src) if group is not None else src
    return comm.broadcast_(tensor, ranks[slot], pg)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to `dst` (a global rank): dst holds the reduced value, every
    other rank keeps its input."""
    red = all_reduce(tensor.clone(), op, group)
    if get_rank() == dst:
        tensor.copy_(red)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives `tensor_list[i]` of rank `src`; ranks
    outside the group keep their input."""
    if group is not None and get_rank() not in group.ranks:
        return tensor
    ranks, pg = _block(group, uniform=False)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[max(get_rank(group), 0)])
        return tensor
    host = tensor.is_cuda
    out = tensor.cpu() if host else tensor
    parts = None
    if get_rank() == src:
        parts = [(_unwrap(t).cpu() if host else _unwrap(t)).contiguous()
                 for t in tensor_list]
    dist.scatter(out, parts, src=src, group=pg)
    if host:
        tensor.copy_(out)
    return tensor


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """The sum over the group of `tensor_list` (one chunk a rank,
    concatenated), rank i keeping chunk i."""
    ranks, pg = _block(group, uniform=True)
    x = torch.cat([_unwrap(t) for t in tensor_list]) \
        if isinstance(tensor_list, (list, tuple)) else _unwrap(tensor_list)
    n = len(ranks)
    chunks = x.reshape((n, -1) + tuple(x.shape[1:]))
    out = comm.all_to_all_single(chunks, pg).sum(0)
    tensor.copy_(out.reshape(tensor.shape))
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Send the i-th input to rank i of the group; receive the i-th output
    from rank i."""
    ranks, pg = _block(group, uniform=True)
    x = torch.stack([_unwrap(t) for t in in_tensor_list])
    out = comm.all_to_all_single(x, pg)
    outs = [out[i] for i in range(out.shape[0])]
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(outs)
        return out_tensor_list
    return outs


def barrier(group=None):
    """A rendezvous of every rank of the caller's block."""
    _ranks, pg = _block(group)
    if pg is not None:
        dist.barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, num_or_sections, axis=0):
    """torch's split with Paddle's argument: a count of equal parts or a
    list of sizes."""
    if isinstance(num_or_sections, int):
        return list(torch.chunk(x, num_or_sections, dim=axis))
    return list(torch.split(x, list(num_or_sections), dim=axis))


# ---- quantized all-reduce (EQuARX pattern) ----------------------------------

def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


def quantize_symmetric(x, scale, bits=8):
    """x -> int8/int16 codes with a symmetric scale (the reference's
    `slim.quantize_symmetric`)."""
    qm = _qmax(bits)
    dt = torch.int8 if bits <= 8 else torch.int16
    safe = torch.clamp_min(scale, 1e-12)
    return torch.clamp(torch.round(x / safe * qm), -qm, qm).to(dt)


def dequantize(q, scale, bits=8):
    return q.float() * (scale / _qmax(bits))


def quantized_all_reduce(x, axis_name, bits=8, block=256, mesh=None):
    """Bandwidth-compressed all-reduce over `axis_name` of the mesh: each
    rank quantizes every chunk with per-block scales and all-to-alls them
    (rank j gets every rank's chunk j), sums them dequantized in float32,
    requantizes the reduced chunk once and all-gathers it. Tensors below
    n * block elements take the plain float32 sum."""
    mesh = resolve_mesh(mesh)
    n = mesh.size(axis_name)
    group = mesh.group(axis_name)
    if x.numel() < n * block:
        return comm.all_reduce_(x.clone(), group)
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % (n * block)
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1, block)

    def quant(v):
        scale = torch.clamp_min(v.abs().amax(-1, keepdim=True), 1e-30)
        return quantize_symmetric(v, scale, bits), scale

    def wire(codes):
        # gloo moves no int16: 16-bit codes travel as their bytes
        return codes.view(torch.int8) if codes.dtype == torch.int16 \
            else codes

    def unwire(codes):
        return codes.view(torch.int16) if bits > 8 else codes

    q, s = quant(chunks)
    q_t = unwire(comm.all_to_all_single(wire(q), group))
    s_t = comm.all_to_all_single(s, group)
    reduced = dequantize(q_t, s_t, bits).sum(0)
    rq, rs = quant(reduced)
    gq = unwire(torch.stack(comm.all_gather(wire(rq), group)))
    gs = torch.stack(comm.all_gather(rs, group))
    out = dequantize(gq, gs, bits).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def quantized_allreduce_wire_bytes(size, n, bits=8, block=256):
    """Per-rank wire bytes of `quantized_all_reduce` vs the float32 ring
    all-reduce, for a `size`-element float32 tensor over n ranks (the
    reference's arithmetic)."""
    f32 = 2 * size * 4 * (n - 1) // n
    if size < n * block:
        return f32, f32
    code_bytes = bits // 8
    padded = size + (-size) % (n * block)
    chunk = padded // n
    scale_bytes = (chunk // block) * 4
    a2a = (n - 1) * (chunk * code_bytes + scale_bytes)
    ag = (n - 1) * (chunk * code_bytes + scale_bytes)
    return a2a + ag, f32


def bucketed_quantized_all_reduce(grads, axis_name, bucket_bytes=1 << 25,
                                  bits=8, block=256, mesh=None):
    """Gradient sync in fixed-size buckets of concatenated leaves (each
    leaf padded to a block boundary, so a small leaf never shares a block
    scale with a large neighbour). grads: {name: tensor} or a list.
    Returns the summed leaves in the same structure."""
    names = list(grads) if isinstance(grads, dict) else None
    leaves = [grads[k] for k in names] if names else list(grads)
    buckets, cur, cur_bytes = [], [], 0
    for i, leaf in enumerate(leaves):
        cur.append(i)
        cur_bytes += leaf.numel() * 4
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    out = [None] * len(leaves)
    for idx in buckets:
        padded = []
        for i in idx:
            v = leaves[i].reshape(-1).float()
            pad = (-v.numel()) % block
            padded.append((torch.nn.functional.pad(v, (0, pad)) if pad
                           else v, v.numel() + pad))
        flat = torch.cat([p[0] for p in padded])
        red = quantized_all_reduce(flat, axis_name, bits=bits, block=block,
                                   mesh=mesh)
        off = 0
        for i, (_, n_pad) in zip(idx, padded):
            n_el = leaves[i].numel()
            out[i] = red[off:off + n_el].reshape(leaves[i].shape).to(
                leaves[i].dtype)
            off += n_pad
    return dict(zip(names, out)) if names else out


__all__ = ["ReduceOp", "Group", "new_group", "get_group", "ParallelEnv",
           "init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "rank_device", "resolve_backend", "all_reduce",
           "all_gather", "broadcast", "reduce", "scatter", "reduce_scatter",
           "alltoall", "barrier", "wait", "split", "quantized_all_reduce",
           "quantized_allreduce_wire_bytes", "bucketed_quantized_all_reduce"]
