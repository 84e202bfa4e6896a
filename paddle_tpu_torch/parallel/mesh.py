"""The device mesh over torch.distributed: one process per rank.

The port of `paddle_tpu/parallel/mesh.py`. The reference builds a
`jax.sharding.Mesh` with axes (dp, pp, mp, sp) over the devices of ONE
process and runs SPMD code inside `shard_map`. The port follows
PyTorch's idiom instead: every rank is its own process, and a `Mesh` is
the map from ranks to coordinates plus one process group per slice of
every set of axes.

Ranks map to coordinates row-major in the order (dp, pp, mp, sp), as the
reference reshapes its device list (`mesh.py:65`), so rank r of the port
holds what device r holds in the reference.

`make_mesh()` without an initialised process group is the world of one:
every axis has size 1, every group is None and every collective of
`comm` is the identity — the reference on one device.

Group creation is collective in torch.distributed: every rank of the
world calls `make_mesh` with the same arguments in the same order (SPMD
code does), also the ranks a mesh over `ranks=` leaves out. Groups are
cached by their member ranks, so meshes that share a slice share its
group.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from dataclasses import dataclass

import torch.distributed as dist

AXES = ("dp", "pp", "mp", "sp")

_current_mesh = None
_GROUPS = {}  # tuple of global ranks -> ProcessGroup


class P(tuple):
    """A partition spec: per tensor dim, the mesh axis (or tuple of axes)
    that splits it, or None. `P("dp", None)` splits dim 0 over dp. Equal,
    as a tuple, to the reference's `jax.sharding.PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass
class MeshConfig:
    dp: int = 1
    mp: int = 1
    pp: int = 1
    sp: int = 1

    @property
    def total(self):
        return self.dp * self.mp * self.pp * self.sp


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_coords(position, shape):
    """{axis: index} of the rank at `position` (0-based, row-major over
    the axes in `shape`'s order) in a mesh of `shape` ({axis: size})."""
    out = {}
    for a in reversed(tuple(shape)):
        out[a] = position % shape[a]
        position //= shape[a]
    return {a: out[a] for a in shape}


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def local_slice(x, spec, coords, shape):
    """The block of the global tensor `x` that the rank at `coords` holds
    under `spec` on a mesh of `shape`: each dim named in the spec is cut
    into equal chunks over its axes (row-major when a dim names several)."""
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        n, i = 1, 0
        for a in _axes(axis):
            n, i = n * shape[a], i * shape[a] + coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split into {n} chunks over {axis}")
        c = x.shape[dim] // n
        x = x.narrow(dim, i * c, c)
    return x


def _group(ranks):
    """The process group of `ranks` (None for one rank). Collective: every
    rank of the world calls it, in the same order."""
    ranks = tuple(ranks)
    if len(ranks) == 1:
        return None
    world, _ = _world()
    if ranks == tuple(range(world)):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Ranks `ranks` (global, row-major) as a mesh of `shape` ({axis:
    size}, in axis order: (dp, pp, mp, sp) from `make_mesh`, any names
    when built directly, e.g. Mesh({"ep": 4}, range(4))).

    `coords` this rank's {axis: index} (None when
    the mesh leaves this rank out, `member` False); `group(axes)` the
    process group of this rank's slice along `axes` (a name or a tuple;
    None when the slice is one rank) and `group_ranks(axes)` its global
    ranks, ordered by the coordinate along those axes."""

    def __init__(self, shape, ranks):
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.ranks = tuple(ranks)
        _, self.rank = _world()
        self.member = self.rank in self.ranks
        self.coords = (mesh_coords(self.ranks.index(self.rank), self.shape)
                       if self.member else None)
        self._slices = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.size(axes) > 1:
                    self._make_slices(axes)

    def size(self, axes):
        return math.prod(self.shape.get(a, 1) for a in _axes(axes))

    def _make_slices(self, axes):
        """One group per slice along `axes` (every rank calls this)."""
        fixed = [a for a in self.axis_names if a not in axes]
        for fix in itertools.product(*(range(self.shape[a])
                                       for a in fixed)):
            members = []
            for var in itertools.product(*(range(self.shape[a])
                                           for a in axes)):
                c = dict(zip(fixed, fix))
                c.update(zip(axes, var))
                pos = 0
                for a in self.axis_names:
                    pos = pos * self.shape[a] + c[a]
                members.append(self.ranks[pos])
            g = _group(members)
            if self.member and all(self.coords[a] == v
                                   for a, v in zip(fixed, fix)):
                self._slices[axes] = (g, tuple(members))

    def _slice(self, axes):
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in this mesh "
                               f"(ranks {self.ranks})")
        if self.size(axes) == 1:
            return None, (self.rank,)
        return self._slices[axes]

    def group(self, axes):
        return self._slice(axes)[0]

    def group_ranks(self, axes):
        return self._slice(axes)[1]

    def axis_index(self, axes):
        """This rank's index along `axes` (row-major over several)."""
        i = 0
        for a in self.axis_names:
            if a in _axes(axes):
                i = i * self.shape[a] + self.coords[a]
        return i

    def __repr__(self):
        dims = "x".join(f"{a}{n}" for a, n in self.shape.items())
        return f"Mesh({dims}, ranks={list(self.ranks)})"


def make_mesh(dp=None, mp=1, pp=1, sp=1, ranks=None):
    """A mesh with axes (dp, pp, mp, sp) over `ranks` (default: the whole
    world; the world of one without a process group); dp=None absorbs the
    rest. Every rank of the world calls it (see the module docstring)."""
    world, _ = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if dp is None:
        dp = n // (mp * pp * sp)
    assert dp * mp * pp * sp == n, \
        f"mesh {dp}x{mp}x{pp}x{sp} != {n} ranks"
    return Mesh({"dp": dp, "pp": pp, "mp": mp, "sp": sp}, ranks)


def get_mesh(dp=None, mp=1, pp=1, sp=1):
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh(dp, mp, pp, sp)
    return _current_mesh


def current_mesh():
    return _current_mesh


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


@contextlib.contextmanager
def mesh_guard(mesh):
    global _current_mesh
    old = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = old


def resolve_mesh(mesh=None):
    """`mesh`, else the current mesh, else the world of one."""
    if mesh is not None:
        return mesh
    if _current_mesh is not None:
        return _current_mesh
    return make_mesh(1, 1, 1, 1, ranks=[_world()[1]])


def axis_size(axis_name, mesh=None):
    """Size of the named axis (or tuple of axes) of `mesh` (default: the
    current mesh) — the reference's `axis_size` inside shard_map."""
    return resolve_mesh(mesh).size(axis_name)


__all__ = ["AXES", "P", "Mesh", "MeshConfig", "make_mesh", "get_mesh",
           "current_mesh", "set_mesh", "mesh_guard", "resolve_mesh",
           "axis_size", "mesh_coords", "local_slice"]
