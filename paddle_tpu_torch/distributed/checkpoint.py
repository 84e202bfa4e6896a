"""Sharded distributed checkpointing, in the reference's on-disk format.

The port of `paddle_tpu/distributed/checkpoint.py`. Each rank (a process
here) writes the slabs it holds of each leaf — a replicated slab only by
its replica 0 — with one index a process describing every leaf's global
shape, dtype and saved slabs; `load` reads, for each rank, only the
slabs that overlap the slice it holds under the target mesh and specs, so
a checkpoint loads into another mesh than the one that saved it.

The files are the reference's: `index.p<process>.pkl` (a pickled dict:
"__meta__" {save_id, process_count}; per leaf {"scalar": v} or
{"shape", "dtype", "fmt": "raw1", "shards": [{"starts", "stops",
"file"}]}), keyed by `jax.tree_util.keystr` of the leaf's path
("['w']", "['nested']['b']", ".m" for a namedtuple field), and shard
files `r<process>.<save_id>.<key>-<sha1[:8]>.<starts>.npy` holding the
slab's bytes as a flat uint8 array. Every save stamps a fresh `save_id`
(drawn by rank 0 and broadcast), the index is renamed into place last,
and `load` merges only the index parts of one complete save. So a
checkpoint either package writes loads in the other.

Where a leaf lives: `mesh` and `specs` (a {keystr: spec} dict, or a tree
like `state` whose leaves are `parallel.mesh.P` specs or None) say which
block of the global tensor each rank's local tensor is; without them
every leaf is whole on every rank (replicated) and rank 0 writes it.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import re as _re
import uuid

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import P

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_TORCH = {v: k for k, v in _DTYPES.items()}


def _is_leaf(x):
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, P)


def _flatten(state, prefix=""):
    """[(keystr, leaf)] in jax.tree_util's key syntax (dict keys sorted, as
    jax flattens them); None is an empty subtree."""
    if state is None:
        return []
    if _is_leaf(state):
        return [(prefix, state)]
    out = []
    if isinstance(state, dict):
        for k in sorted(state):
            out += _flatten(state[k], f"{prefix}[{k!r}]")
    elif hasattr(state, "_fields"):
        for f in state._fields:
            out += _flatten(getattr(state, f), f"{prefix}.{f}")
    else:
        for i, v in enumerate(state):
            out += _flatten(v, f"{prefix}[{i}]")
    return out


def _rebuild(like, values, prefix=""):
    """`like`'s structure with each leaf replaced by values[keystr]."""
    if like is None:
        return None
    if _is_leaf(like):
        return values[prefix]
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), values,
                                     f"{prefix}.{f}") for f in like._fields))
    return type(like)(_rebuild(v, values, f"{prefix}[{i}]")
                      for i, v in enumerate(like))


def _specs_by_key(specs):
    if specs is None:
        return {}
    if isinstance(specs, dict) and all(
            isinstance(k, str) and k.startswith(("[", ".")) for k in specs):
        return dict(specs)
    return dict(_flatten(specs))


def _placement(local_shape, spec, mesh):
    """(global shape, starts, replica_id) of a local block under `spec`."""
    spec = tuple(spec or ())
    shape, starts, used = [], [], set()
    for d, n in enumerate(local_shape):
        axes = spec[d] if d < len(spec) else None
        if axes is None:
            shape.append(n)
            starts.append(0)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        k, i = 1, 0
        for a in axes:
            k, i = k * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
            used.add(a)
        shape.append(n * k)
        starts.append(n * i)
    replica = 0
    for a in mesh.axis_names:
        if a not in used:
            replica = replica * mesh.shape[a] + mesh.coords[a]
    return tuple(shape), tuple(starts), replica


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _coordinated_save_id():
    """One save_id for every process of this save: rank 0 draws it."""
    sid = [uuid.uuid4().hex[:12]]
    if _world()[0] > 1:
        dist.broadcast_object_list(sid, src=0)
    return sid[0]


def _safe_key(key):
    safe = key.replace("/", "_").replace("'", "").replace(
        "[", ".").replace("]", "")
    return safe + "-" + hashlib.sha1(key.encode()).hexdigest()[:8]


def save(state, ckpt_dir, mesh=None, specs=None, process_index=None,
         save_id=None, process_count=None):
    """Write this rank's slabs of `state` (a tree of tensors, numpy arrays
    and scalars) under `ckpt_dir`. Every rank calls it; it returns when
    every rank's index is in place. `process_index`,
    `process_count` and `save_id` default to this rank, the world's size
    and an id drawn by rank 0."""
    count, rank = _world()
    if process_count is not None:
        count = process_count
    if process_index is None:
        process_index = rank
    os.makedirs(ckpt_dir, exist_ok=True)
    if save_id is None:
        save_id = _coordinated_save_id()
    elif not _re.fullmatch(r"[0-9a-f]{12}", save_id):
        raise ValueError(
            f"save_id must be 12 lowercase hex chars, got {save_id!r}")
    spec_of = _specs_by_key(specs)
    index = {"__meta__": {"save_id": save_id, "process_count": count}}
    for key, val in _flatten(state):
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(val)
        if not torch.is_tensor(val):
            index[key] = {"scalar": val}
            continue
        if mesh is not None and mesh.member:
            gshape, starts, replica = _placement(val.shape,
                                                 spec_of.get(key), mesh)
        else:
            gshape, starts, replica = tuple(val.shape), \
                (0,) * val.dim(), process_index
        shards = []
        if replica == 0:
            stops = tuple(a + n for a, n in zip(starts, val.shape))
            fname = (f"r{process_index}.{save_id}.{_safe_key(key)}"
                     f".{'_'.join(map(str, starts))}.npy")
            raw = val.detach().contiguous().cpu().reshape(-1)
            raw = raw.view(torch.uint8).numpy() if raw.numel() else \
                np.zeros(0, np.uint8)
            tmp = os.path.join(ckpt_dir, fname + ".tmp")
            with open(tmp, "wb") as f:
                np.save(f, raw)
            os.replace(tmp, os.path.join(ckpt_dir, fname))
            shards.append({"starts": starts, "stops": stops, "file": fname})
        index[key] = {"shape": gshape, "dtype": _DTYPES[val.dtype],
                      "fmt": "raw1", "shards": shards}
    ipath = os.path.join(ckpt_dir, f"index.p{process_index}.pkl")
    with open(ipath + ".tmp", "wb") as f:
        pickle.dump(index, f, protocol=4)
    os.replace(ipath + ".tmp", ipath)
    # best-effort cleanup: this process's files from older saves, and (on
    # process 0) leftovers of ranks beyond the current process count
    for fn in os.listdir(ckpt_dir):
        stale_own = stale_rank = False
        if fn.endswith(".npy"):
            m = _re.match(r"r(\d+)\.([0-9a-f]{12})\.", fn)
            if m:
                r, sid = int(m.group(1)), m.group(2)
                stale_own = r == process_index and sid != save_id
                stale_rank = process_index == 0 and r >= count
        elif fn.startswith("index.p") and fn.endswith(".pkl") \
                and process_index == 0:
            try:
                stale_rank = int(fn[len("index.p"):-len(".pkl")]) >= count
            except ValueError:
                pass
        if stale_own or stale_rank:
            try:
                os.remove(os.path.join(ckpt_dir, fn))
            except OSError:
                pass
    if _world()[0] > 1:
        dist.barrier()  # the save is complete once every index is in place


def _merged_index(ckpt_dir):
    parts = []
    for p in sorted(os.listdir(ckpt_dir)):
        if p.startswith("index.p") and p.endswith(".pkl"):
            with open(os.path.join(ckpt_dir, p), "rb") as f:
                parts.append(pickle.load(f))
    if not parts:
        raise FileNotFoundError(f"no index.p*.pkl in {ckpt_dir}")
    by_id = {}
    for part in parts:
        by_id.setdefault(part["__meta__"]["save_id"], []).append(part)
    complete = [(sid, ps) for sid, ps in by_id.items()
                if len(ps) == ps[0]["__meta__"]["process_count"]]
    if not complete:
        sid, ps = max(by_id.items(), key=lambda kv: len(kv[1]))
        raise ValueError(
            f"checkpoint {ckpt_dir} has no complete save: best candidate "
            f"{sid} has {len(ps)}/{ps[0]['__meta__']['process_count']} "
            "process indexes (crashed save or missing files)")
    if len(complete) > 1:
        raise ValueError(
            f"checkpoint {ckpt_dir} holds {len(complete)} complete saves "
            "— directory was shared between unrelated runs")
    merged = {}
    for part in complete[0][1]:
        for key, meta in part.items():
            if key == "__meta__":
                continue
            if key not in merged:
                merged[key] = dict(meta)
            elif "shards" in meta:
                have = {tuple(s["starts"]) for s in merged[key]["shards"]}
                merged[key]["shards"] = merged[key]["shards"] + [
                    s for s in meta["shards"]
                    if tuple(s["starts"]) not in have]
    return merged


def _read_slab(ckpt_dir, fname, shape, dtype):
    a = np.load(os.path.join(ckpt_dir, fname), mmap_mode="r")
    t = torch.from_numpy(np.array(a, dtype=np.uint8))
    return t.view(dtype).reshape(shape)


def load(ckpt_dir, like, mesh=None, specs=None):
    """`like`'s structure with every tensor leaf read from the checkpoint:
    the block this rank holds under `mesh`/`specs` (the whole leaf
    without them), on the like leaf's device and in its dtype (which must
    be the saved one)."""
    index = _merged_index(ckpt_dir)
    spec_of = _specs_by_key(specs)
    values = {}
    for key, tgt in _flatten(like):
        meta = index.get(key)
        if meta is None:
            raise KeyError(f"checkpoint {ckpt_dir} has no entry '{key}'")
        if "scalar" in meta:
            values[key] = meta["scalar"]
            continue
        was_np = isinstance(tgt, np.ndarray)
        t = torch.from_numpy(tgt) if was_np else tgt
        shape = tuple(meta["shape"])
        if mesh is not None and mesh.member:
            gshape, starts, _ = _placement(t.shape, spec_of.get(key), mesh)
        else:
            gshape, starts = tuple(t.shape), (0,) * t.dim()
        if gshape != shape:
            raise ValueError(f"shape mismatch for '{key}': checkpoint "
                             f"{shape} vs target {gshape}")
        if _DTYPES[t.dtype] != meta["dtype"]:
            raise ValueError(
                f"dtype mismatch for '{key}': checkpoint {meta['dtype']} "
                f"vs target {_DTYPES[t.dtype]} — cast explicitly after load")
        dtype = _TORCH[meta["dtype"]]
        stops = tuple(a + n for a, n in zip(starts, t.shape))
        block = torch.empty(tuple(t.shape), dtype=dtype)
        filled = torch.zeros(tuple(t.shape), dtype=torch.bool)
        for s in meta["shards"]:
            sst, ssp = tuple(s["starts"]), tuple(s["stops"])
            lo = [max(a, b) for a, b in zip(starts, sst)]
            hi = [min(a, b) for a, b in zip(stops, ssp)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            slab = _read_slab(ckpt_dir, s["file"],
                              [b - a for a, b in zip(sst, ssp)], dtype)
            src = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, sst))
            dst = tuple(slice(a - o, b - o)
                        for a, b, o in zip(lo, hi, starts))
            block[dst] = slab[src]
            filled[dst] = True
        if not bool(filled.all()):
            raise ValueError(
                "checkpoint shards do not cover the requested slice "
                "(multi-host load missing files?)")
        values[key] = block.numpy() if was_np else block.to(t.device)
    return _rebuild(like, values)


__all__ = ["save", "load"]
