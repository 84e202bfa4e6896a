"""The sharded server's runtime: the rank that plans, the ranks that
follow, and the capacity arithmetic.

`apply_sharding(server, cfg, pool_kw)` is called from the
`PagedGenerationServer` constructor (an unsharded server never imports
this package) on EVERY rank, with the same arguments: it builds the mesh
(collective), cuts the flat params to the rank's part, builds the rank's
slice of the pool and the decoder the server dispatches through.

Rank 0 plans (see the package docstring): its `ShardedDecoder` sends one
header a dispatch on the world group — the program, its mode, every
host-side input (tokens, seg, pos, block tables, sample indices, the
sampling columns and the penalty counts) as numpy — then runs the
program on its own slices; `PoolMirror` sends every device-side pool
operation the same way. A follower's `serve()` receives each header in
order and does the same on its slices, until rank 0's `close()`. Every
rank then holds the same outputs: the sums and gathers of the programs
give each rank the same values, and under dp the per-row outputs are
combined from the groups that own the rows.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..nn.decode import PagedDecoder
from ..sampling.buffers import GREEDY_MODE
from . import collectives as _coll
from .config import ShardedEngineConfig
from .plan import DecodeShardings, shard_decode_params, vocab_split
from .sp_attention import build_sp_fresh_attention


class DecodeShard:
    """One rank's context for `nn.decode`'s sharded programs."""

    def __init__(self, mesh, cfg, model_cfg, kv_dtype, block_size):
        self.mesh = mesh
        self.tp = cfg.tp
        self.cq = _coll.build_collective_quant(cfg, mesh)
        self.vocab_split = vocab_split(mesh.shape, model_cfg.vocab_size)
        self.v_off = (mesh.coords["mp"] * (model_cfg.vocab_size // cfg.tp)
                      if self.vocab_split else 0)
        self.sp_attn = None
        if cfg.sp > 1 and cfg.sp_attention != "allgather":
            Dh = model_cfg.hidden_size // model_cfg.num_heads
            self.sp_attn = build_sp_fresh_attention(
                mesh, cfg.sp_attention, kv_dtype == "int8", block_size,
                Dh ** -0.5)


_ALL = ("dp", "pp", "mp", "sp")


class _Channel:
    """The header broadcast over the mesh's ranks from its first rank.
    `lock` keeps one operation's header and collectives together when
    several threads of the planning rank touch the pool."""

    def __init__(self, mesh):
        self.src = mesh.ranks[0]
        self.group = mesh.group(_ALL)
        self.lock = threading.RLock()

    def send(self, hdr):
        dist.broadcast_object_list([hdr], src=self.src, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _rank_at(mesh, dp, mp, sp):
    """The world rank at mesh coordinates (dp, pp 0, mp, sp)."""
    s = mesh.shape
    return mesh.ranks[((dp * s["pp"]) * s["mp"] + mp) * s["sp"] + sp]


class ShardedDecoder:
    """The decoder a multi-rank sharded server dispatches through: the
    `PagedDecoder` API (packed_prefill, step, multistep, packed_verify,
    unified_round). On rank 0 each call broadcasts its header, then runs
    the program on rank 0's slices; `execute` is what every rank runs for
    a header. The params, kc and vc a caller passes are rank 0's own and
    are taken from the runtime."""

    def __init__(self, runtime, inner):
        self.rt = runtime
        self.inner = inner
        self.spec = inner.spec

    @property
    def graphs(self):
        return self.inner.graphs

    # ---- the planning rank's API ---------------------------------------
    def _dispatch(self, prog, args, sp, mode, **kw):
        hdr = {"op": "run", "prog": prog, "mode": tuple(mode),
               "args": [_np(a) for a in args],
               "sp": {k: _np(v) for k, v in sp.items()}, **kw}
        rt = self.rt
        with rt.chan.lock:
            rt.chan.send(hdr)
            out = self.execute(hdr)
        rt.account(prog, hdr, mode)
        return out

    def packed_prefill(self, params, toks, seg, pos, tables, sample_idx,
                       kc, vc, sp, mode=GREEDY_MODE):
        return self._dispatch("packed_prefill",
                              (toks, seg, pos, tables, sample_idx), sp, mode)

    def step(self, params, tok, pos, active, tables, kc, vc, sp,
             mode=GREEDY_MODE):
        return self._dispatch("step", (tok, pos, active, tables), sp, mode)

    def multistep(self, n_steps, mode=GREEDY_MODE):
        def multi(params, tok, pos, active, tables, kc, vc, sp):
            return self._dispatch("multistep", (tok, pos, active, tables),
                                  sp, mode, k=int(n_steps))
        return multi

    def packed_verify(self, params, toks, seg, pos, tables, sample_idx,
                      dlen, kc, vc, sp, mode=GREEDY_MODE):
        return self._dispatch(
            "packed_verify", (toks, seg, pos, tables, sample_idx, dlen), sp,
            mode)

    def unified_round(self, params, toks, seg, pos, tables, sample_idx,
                      dlen, row_slot, carry_map, pos_map, steps_map,
                      carry_tok, carry_pos, carry_steps, kc, vc, sp,
                      mode=GREEDY_MODE, window=False):
        return self._dispatch(
            "unified_round",
            (toks, seg, pos, tables, sample_idx, dlen, row_slot, carry_map,
             pos_map, steps_map, carry_tok, carry_pos, carry_steps), sp,
            mode, window=bool(window))

    # ---- every rank ------------------------------------------------------
    def execute(self, hdr):
        """Run one header's program on this rank's slices; the outputs,
        equal on every rank of the mesh."""
        rt = self.rt
        dev = rt.device
        prog, mode = hdr["prog"], tuple(hdr["mode"])
        args = [torch.from_numpy(a).to(dev) for a in hdr["args"]]
        sp = {k: torch.from_numpy(v).to(dev) for k, v in hdr["sp"].items()}
        owner = None
        if rt.groups > 1:  # every program's block tables are its 4th input
            tb = args[3].long()
            owner = tb[:, 0] // rt.gsize
            g = rt.group
            args[3] = torch.where(tb // rt.gsize == g, tb - g * rt.gsize,
                                   torch.zeros_like(tb)).to(torch.int32)
        if prog == "packed_prefill" and rt.sp > 1:
            args = _pad_stream(args, rt.sp)
        dec, p = self.inner, rt.params
        kc, vc = rt.cache.k_blocks, rt.cache.v_blocks
        if prog == "packed_prefill":
            out = dec.packed_prefill(p, *args, kc, vc, sp, mode)
        elif prog == "step":
            out = dec.step(p, *args, kc, vc, sp, mode)
        elif prog == "multistep":
            out = dec.multistep(hdr["k"], mode)(p, *args, kc, vc, sp)
        elif prog == "packed_verify":
            out = dec.packed_verify(p, *args, kc, vc, sp, mode)
        else:
            out = dec.unified_round(p, *args, kc, vc, sp, mode,
                                    window=hdr["window"])
        if owner is not None:
            out = rt.merge(prog, out, owner)
        rt.note_outputs(prog, out)
        return out


def _pad_stream(args, n):
    """packed_prefill's (toks, seg, pos) padded with pad rows (pos -1) to
    a multiple of n, for the sp trunk."""
    toks, seg, pos = args[0], args[1], args[2]
    extra = (-toks.shape[0]) % n
    if not extra:
        return args

    def ext(t, v):
        return torch.cat([t, torch.full((extra,), v, dtype=t.dtype,
                                        device=t.device)])
    return [ext(toks, 0), ext(seg, 0), ext(pos, -1)] + list(args[3:])


class PoolMirror:
    """The planning rank's hook on its `PagedKVCache` (`cache.mirror`):
    every device-side pool operation is sent to the other ranks, which
    replay it on their slices (`ShardedRuntime.apply`)."""

    def __init__(self, runtime):
        self.rt = runtime

    def _send(self, hdr):
        with self.rt.chan.lock:
            self.rt.chan.send(hdr)

    def copy_block(self, src, dst):
        self._send({"op": "copy", "src": int(src), "dst": int(dst)})

    def tier_put(self, h, b, fill):
        self._send({"op": "tier_put", "h": h, "b": int(b),
                    "fill": int(fill)})

    def tier_take(self, h, b, fill):
        self._send({"op": "tier_take", "h": h, "b": int(b),
                    "fill": int(fill)})

    def tier_forget(self, hashes):
        hashes = list(hashes)
        if hashes:
            self._send({"op": "tier_forget", "hashes": hashes})

    def import_blocks(self, blocks, ks, vs):
        self._send({"op": "import", "blocks": [int(b) for b in blocks],
                    "k": list(ks), "v": list(vs)})

    def export_blocks(self, blocks):
        """Every head of `blocks` as numpy, gathered from the ranks that
        hold them."""
        rt = self.rt
        blocks = [int(b) for b in blocks]
        with rt.chan.lock:
            rt.chan.send({"op": "export", "blocks": blocks})
            return rt.export(blocks)


class ShardedRuntime:
    """One rank's share of a sharded server: the mesh, its params and
    pool slice, the decoder, the header channel and the wire-byte
    accounting."""

    def __init__(self, server, cfg, model_cfg, pool_kw):
        from ..inference.kv_cache import PagedKVCache

        self.cfg = cfg
        self.mesh = mesh = cfg.build_mesh()
        if not mesh.member:
            raise RuntimeError(
                f"rank {mesh.rank} is not in the mesh of {cfg} (ranks "
                f"{list(mesh.ranks)}): a rank outside it calls "
                f"cfg.build_mesh() (group creation is collective) and "
                f"builds no server")
        self.device = server.device
        self.multi = len(mesh.ranks) > 1
        self.rank = mesh.rank
        self.leader = self.rank == mesh.ranks[0]
        H = model_cfg.num_heads
        self.tp, self.sp, self.groups = cfg.tp, cfg.sp, cfg.dp
        self.group = mesh.coords["dp"]
        hl = H // cfg.tp
        nb = int(pool_kw["num_blocks"])
        self.gsize = nb // cfg.dp
        self.cache = PagedKVCache(
            **pool_kw, local_heads=hl, head_offset=mesh.coords["mp"] * hl,
            groups=cfg.dp, group=self.group)
        self.cache.set_shard_count(cfg.tp * cfg.dp)
        self.params = shard_decode_params(server._params, mesh, H)
        self.shardings = DecodeShardings(mesh, server._params,
                                         pool_kw.get("kv_dtype"))
        kv_dtype = pool_kw.get("kv_dtype")
        self.shard = DecodeShard(mesh, cfg, model_cfg, kv_dtype,
                                 pool_kw["block_size"])
        inner = PagedDecoder.for_config(
            model_cfg, pool_kw["block_size"], kv_dtype=kv_dtype,
            shard=self.shard if self.multi else None)
        self.chan = _Channel(mesh) if self.multi else None
        self.decoder = ShardedDecoder(self, inner) if self.multi else inner
        if self.multi and self.leader:
            self.cache.mirror = PoolMirror(self)
        self.slot_groups = None
        self._tier_store: dict = {}   # follower: hash -> this slice's rows
        self._digest = hashlib.sha1()
        self.dispatches = 0
        self._wire_lock = threading.Lock()
        self._wire: dict = {}
        self._spec = inner.spec
        self._vocab = model_cfg.vocab_size
        self._itemsize = self.params["ln_f.weight"].element_size()
        self._closed = False

    # ---- dp: combine the per-row outputs of the groups -------------------
    def _combine(self, t, mine, dim=0):
        """t with the entries along `dim` this group does not own zeroed,
        summed over dp: every entry from its owner."""
        from ..parallel import comm

        if t is None:
            return None
        dt = t.dtype
        x = t.to(torch.int32) if dt == torch.bool else t
        shape = [1] * x.dim()
        shape[dim] = mine.shape[0]
        x = torch.where(mine.reshape(shape), x, torch.zeros_like(x))
        comm.all_reduce_(x, self.mesh.group("dp"))
        return x.to(dt)

    def merge(self, prog, out, owner):
        """Each row's outputs from the group owning it (its table row's
        blocks; slot-indexed outputs by the slot's group)."""
        mine = owner == self.group
        slots = torch.as_tensor(self.slot_groups, device=owner.device) \
            == self.group
        out = list(out)
        if prog == "multistep":
            out[0] = self._combine(out[0], mine, dim=1)
            out[1] = self._combine(out[1], mine, dim=1)
            out[4] = self._combine(out[4], slots)
            return tuple(out)
        if prog in ("packed_prefill", "step"):
            rows, counts_at = (0, 1), 4
        else:
            rows, counts_at = (0, 1, 2), 5
        for i in rows:
            out[i] = self._combine(out[i], mine)
        out[counts_at] = self._combine(out[counts_at], slots)
        if prog == "unified_round":
            for i in (6, 7, 8):
                out[i] = self._combine(out[i], slots)
        if len(out) > counts_at + (4 if prog == "unified_round" else 1):
            out[-1] = self._combine(out[-1], mine)     # logits
        return tuple(out)

    def note_outputs(self, prog, out):
        """Fold one dispatch's token outputs into this rank's digest (the
        check that every rank sampled the same tokens)."""
        n = 2 if prog in ("packed_prefill", "step", "multistep") else 3
        for t in out[:n]:
            self._digest.update(np.ascontiguousarray(_np(t)).tobytes())
        self.dispatches += 1

    def digest(self):
        return self._digest.hexdigest()

    # ---- the follower's side ---------------------------------------------
    def apply(self, hdr):
        """Replay one header on this rank."""
        op = hdr["op"]
        c = self.cache
        if op == "run":
            self.decoder.execute(hdr)
        elif op == "copy":
            c.copy_block(hdr["src"], hdr["dst"])
        elif op == "tier_put":
            if hdr["h"] not in self._tier_store:
                self._tier_store[hdr["h"]] = c._tier_grab(hdr["b"],
                                                          hdr["fill"])
        elif op == "tier_take":
            kp, vp = self._tier_store.pop(hdr["h"])
            c._tier_install(hdr["b"], hdr["fill"], kp, vp)
        elif op == "tier_forget":
            for h in hdr["hashes"]:
                self._tier_store.pop(h, None)
        elif op == "import":
            for b, pk, pv in zip(hdr["blocks"], hdr["k"], hdr["v"]):
                c.write_payload_block(b, pk, pv)
        elif op == "export":
            self.export(hdr["blocks"])
        else:
            raise ValueError(f"unknown sharded-serving header {op!r}")

    def serve(self):
        """The follower loop: replay rank 0's headers until it closes.
        Returns {"dispatches", "digest"}."""
        if self.leader:
            raise RuntimeError("serve_follower() is for ranks above the "
                               "mesh's first; rank 0 plans (start/stop)")
        while True:
            hdr = self.chan.recv()
            if hdr["op"] == "stop":
                break
            self.apply(hdr)
        return {"dispatches": self.dispatches, "digest": self.digest()}

    def close(self):
        """Rank 0: release the followers (once)."""
        if self.multi and self.leader and not self._closed:
            self._closed = True
            with self.chan.lock:
                self.chan.send({"op": "stop"})

    # ---- export: gather every head of some blocks ------------------------
    def export(self, blocks):
        c = self.cache
        mine = [None if c.local_block(b) is None or self.mesh.coords["sp"]
                else (c.block_arrays(c.k_blocks, b),
                      c.block_arrays(c.v_blocks, b)) for b in blocks]
        members = self.mesh.group_ranks(_ALL)
        got = [None] * len(members)
        dist.all_gather_object(got, mine, group=self.chan.group)
        ks, vs = [], []
        for j, b in enumerate(blocks):
            g = b // self.gsize
            parts = [got[members.index(_rank_at(self.mesh, g, m, 0))][j]
                     for m in range(self.tp)]
            ks.append(_cat_heads([p[0] for p in parts]))
            vs.append(_cat_heads([p[1] for p in parts]))
        return ks, vs

    # ---- wire-byte accounting (rank 0) -----------------------------------
    def account(self, prog, hdr, mode):
        if self.tp <= 1:
            return
        a = hdr["args"]
        if prog == "packed_prefill":
            rows = (a[0].shape[0], a[4].shape[0])
        elif prog == "step":
            rows = (a[0].shape[0], a[0].shape[0])
        elif prog == "multistep":
            rows = (hdr["k"] * a[0].shape[0], hdr["k"] * a[0].shape[0])
        else:
            rows = (a[0].shape[0], a[4].shape[0] * a[4].shape[1])
        cq = self.shard.cq
        by = _coll.dispatch_wire_bytes(
            spec=self._spec, vocab=self._vocab, tp=self.tp,
            mode=cq.mode if cq is not None else None,
            group=cq.group if cq is not None else 32,
            trunk_rows=int(rows[0]), logit_rows=int(rows[1]),
            greedy_fast=cq is not None and tuple(mode) == GREEDY_MODE,
            base_itemsize=self._itemsize)
        with self._wire_lock:
            for key, nbytes in by.items():
                self._wire[key] = self._wire.get(key, 0) + nbytes
        _coll.record_wire_bytes(by)

    def wire_stats(self):
        with self._wire_lock:
            items = list(self._wire.items())
        total = baseline = 0
        by = {}
        for (name, dtype), nbytes in items:
            if dtype == "baseline":
                baseline += nbytes
            else:
                total += nbytes
                by[name] = by.get(name, 0) + nbytes
        return {"bytes_total": total, "bytes_baseline": baseline,
                "by_collective": by}

    def reset_wire_stats(self):
        with self._wire_lock:
            self._wire.clear()


def _cat_heads(parts):
    """One block's slices (in mp order) joined on the head axis."""
    from ..inference.kv_quant import QuantizedKV

    if hasattr(parts[0], "codes"):
        return QuantizedKV(np.concatenate([p.codes for p in parts], 2),
                           np.concatenate([p.scales for p in parts], 2))
    return np.concatenate(parts, 2)


def apply_sharding(server, cfg, model_cfg, pool_kw):
    """Shard `server` over the mesh of `cfg` (every rank calls it with
    the same arguments): sets `server.cache` (this rank's pool slice),
    `server._params` (this rank's part), `server._decoder`,
    `server.sharding`, `server._mesh` and `server._dist` (the
    `ShardedRuntime`). Under dp the slots are pinned to the block groups
    round-robin (slot i to group i % dp)."""
    if not isinstance(cfg, ShardedEngineConfig):
        raise TypeError(f"sharding must be a ShardedEngineConfig, got "
                        f"{type(cfg).__name__}")
    if cfg.dp > 1 and pool_kw.get("tier") is not None:
        raise ValueError(
            "kv_tier with ShardedEngineConfig(dp > 1) is not supported: a "
            "block demoted by one dp group may be promoted into another, "
            "whose ranks do not hold its rows")
    rt = ShardedRuntime(server, cfg, model_cfg, pool_kw)
    if cfg.dp > 1:
        rt.slot_groups = [i % cfg.dp for i in range(server.max_slots)]
    server.cache = rt.cache
    server._params = rt.params
    server._decoder = rt.decoder
    server.sharding = cfg
    server._mesh = rt.mesh
    server._dist = rt
    return rt


def _block_bytes(num_layers, num_heads, head_dim, block_size,
                 dtype=torch.float32, kv_dtype=None):
    """Device bytes one pool block costs across all layers, K + V (codes
    + per-vector scales under int8)."""
    vecs = num_layers * 2 * block_size * num_heads
    item = (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)
    if kv_dtype == "int8":
        return vecs * (head_dim * 1 + item)
    return vecs * head_dim * item


def pool_blocks_for_budget(cfg_model, block_size, per_device_bytes,
                           tp=1, dp=1, dtype=torch.float32, kv_dtype=None):
    """Largest `num_blocks` (block 0 included) whose per-rank share fits
    `per_device_bytes`: per-rank bytes = total / (tp * dp), so at a fixed
    per-rank budget the pool holds tp * dp times the blocks."""
    bb = _block_bytes(cfg_model.num_layers, cfg_model.num_heads,
                      cfg_model.hidden_size // cfg_model.num_heads,
                      block_size, dtype, kv_dtype)
    return max(2, int(per_device_bytes * tp * dp // bb))


def max_slots_for_budget(cfg_model, block_size, per_device_bytes,
                         tokens_per_request, tp=1, dp=1,
                         dtype=torch.float32, kv_dtype=None,
                         spare_blocks=0):
    """Concurrent slots the admission reservation can back at a fixed
    per-rank pool budget: usable blocks // worst-case blocks a request."""
    from ..inference.kv_cache import blocks_for

    nb = pool_blocks_for_budget(cfg_model, block_size, per_device_bytes,
                                tp=tp, dp=dp, dtype=dtype,
                                kv_dtype=kv_dtype)
    per_req = blocks_for(tokens_per_request, block_size) + spare_blocks
    return (nb - 1) // max(per_req, 1)


__all__ = ["apply_sharding", "pool_blocks_for_budget",
           "max_slots_for_budget", "ShardedDecoder", "ShardedRuntime",
           "PoolMirror", "DecodeShard"]
