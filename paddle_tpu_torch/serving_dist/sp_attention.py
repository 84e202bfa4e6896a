"""Memory-flat sequence-parallel attention of the sp packed-prefill trunk.

The port of `paddle_tpu/serving_dist/sp_attention.py`. The allgather sp
trunk (`nn/decode.py`) all-gathers the whole fresh K/V stream onto every
sp rank before the pool write: its peak live fresh-K/V bytes a rank are
O(chunk). Two modes keep them O(block):

* ring — each rank cuts its fresh K/V rows into fixed `block_tokens`-row
  sub-blocks that rotate around the sp ranks (`parallel.comm.shift`);
  every rank writes each visiting block into its replica of the paged
  pool (the pool is replicated over sp) and folds it into an online
  softmax. Peak cross-rank fresh K/V a rank: the held block and the one
  in flight.
* ulysses — one all-to-all a sub-block swaps sequence and head sharding:
  each rank attends its head slice over the whole gathered sub-block
  (global row order recovered by index arithmetic); the pool write still
  rides the ring rotation, since every sp replica needs all its mp-local
  heads. Needs the mp-local head count divisible by sp.

Masking is the segment-causal contract of K1: a query at (qseg, qpos)
sees keys with kseg == qseg and 0 <= kpos <= qpos. seg/pos are
replicated, so a visiting block's metadata follows from its origin rank.
The fresh pass covers positions [start, qpos] (start: the segment's
first position written THIS dispatch, `segment_starts`); the pool pass
covers the resident columns < start with the numerics of the plain
paged attention (scores float32, weights in the model dtype, int8 scales
folded after the contraction). The union is the allgather path's key set.

Pad rows (pos -1) write nothing that matters: their K/V payload is
zeroed before rotation and they all land in the trash block, so every
rotation order leaves the sp replicas equal.

The reference computes these bodies in XLA; the port runs the same math
in torch over the mesh's collectives (there is no kernel to port). The
pool is written in place, so the reference's functional layer
write-back (`kv_set_layer`) has no counterpart.
"""
from __future__ import annotations

import torch

from .config import SP_ATTENTION_MODES

#: Rotation sub-block length (tokens): fixed, not a function of chunk
#: length, so the ring/ulysses peak bytes are constant over any sweep.
DEFAULT_BLOCK_TOKENS = 512

NEG_INF = -1e30


def _sub_block(local_tokens, block_tokens):
    """`block_tokens` halved until it divides the rank-local length."""
    bc = max(1, min(int(block_tokens), int(local_tokens)))
    while local_tokens % bc:
        bc //= 2
    return bc


def sp_attention_peak_bytes(mode, chunk_tokens, sp, tp, num_heads,
                            head_dim, kv_quant=False, itemsize=4,
                            scale_itemsize=4,
                            block_tokens=DEFAULT_BLOCK_TOKENS):
    """Peak CROSS-RANK fresh-K/V bytes one sp rank materializes to
    attend a packed stream of `chunk_tokens` (host arithmetic, exact on
    any device):

    allgather: 2 * chunk * (H/tp) * Dh * eff     (linear in chunk)
    ring:      4 * block * (H/tp) * Dh * eff     (constant)
    ulysses:   8 * block * (H/tp) * Dh * eff     (constant)
    eff = itemsize, or for int8 KV 1 + scale_itemsize/Dh. Not counted:
    the rank-local projections and the pool, equal in every mode."""
    if mode not in SP_ATTENTION_MODES:
        raise ValueError(f"sp_attention={mode!r} must be one of "
                         f"{SP_ATTENTION_MODES}")
    t = int(chunk_tokens)
    local_heads = max(1, int(num_heads) // max(1, int(tp)))
    eff = (1.0 + float(scale_itemsize) / float(head_dim)) if kv_quant \
        else float(itemsize)
    per_tok = local_heads * int(head_dim) * eff
    if mode == "allgather" or int(sp) <= 1:
        return int(round(2 * t * per_tok))
    bc = _sub_block(max(1, t // int(sp)), block_tokens)
    ring = 4 * bc * per_tok
    if mode == "ring":
        return int(round(ring))
    return int(round(2 * ring))


def sp_attention_flat_bound(mode, tp, num_heads, head_dim,
                            kv_quant=False, itemsize=4,
                            scale_itemsize=4,
                            block_tokens=DEFAULT_BLOCK_TOKENS):
    """The chunk-length-independent ceiling of the ring/ulysses peak
    bytes (a sub-block never exceeds `block_tokens` rows): what the
    server asserts every ring/ulysses dispatch stays under."""
    eff = (1.0 + float(scale_itemsize) / float(head_dim)) if kv_quant \
        else float(itemsize)
    per_tok = max(1, int(num_heads) // max(1, int(tp))) * int(head_dim) \
        * eff
    mult = 4 if mode == "ring" else 8
    return int(round(mult * int(block_tokens) * per_tok))


def segment_starts(seg, pos, num_segments):
    """starts[b] = the smallest valid pos of segment b in this stream (a
    huge sentinel when it feeds no rows): pool columns < starts[qseg]
    were written by earlier dispatches, fresh rows cover the rest."""
    big = 2 ** 30
    p = torch.where(pos >= 0, pos.long(), torch.full_like(pos.long(), big))
    out = torch.full((int(num_segments),), big, dtype=torch.long,
                     device=pos.device)
    return out.scatter_reduce(0, seg.long(), p, reduce="amin")


def build_sp_fresh_attention(mesh, mode, kv_quant, block_size, scale,
                             block_tokens=DEFAULT_BLOCK_TOKENS):
    """The attention of the sp trunk in ring or ulysses mode:

        attend(q, k, v, kc_i, vc_i, tables, seg, pos, starts) -> o

    q/k/v: [T/sp, H_mp, Dh] this rank's rows of the fresh projections;
    kc_i/vc_i: one layer of this rank's pool ([N, BS, H_mp, Dh], or an
    int8 `QuantizedKV`), written in place with the whole stream's rows;
    tables/seg/pos/starts: the replicated stream metadata ([B, M], [T],
    [T], [B]). o: [T/sp, H_mp, Dh], this rank's rows."""
    from ..inference.kv_quant import QuantizedKV, kv_encode
    from ..parallel import comm

    if mode not in ("ring", "ulysses"):
        raise ValueError(f"build_sp_fresh_attention: mode={mode!r} "
                         f"(allgather is the trunk's own path)")
    BS = int(block_size)
    quant = bool(kv_quant)

    def _pool_partial(qh, qseg, qcap, kc_i, vc_i, tables):
        """Unnormalized (o, m, l) of queries qh [Hq, Tq, Dh] against the
        resident pool columns < qcap."""
        hq, tq, dh = qh.shape
        b, mmax = tables.shape
        c = mmax * BS
        tb = tables.long()
        if quant:
            k = kc_i.codes[tb].reshape(b, c, hq, dh)
            v = vc_i.codes[tb].reshape(b, c, hq, dh)
            ks = kc_i.scales[tb].reshape(b, c, hq).permute(2, 0, 1)
            vs = vc_i.scales[tb].reshape(b, c, hq).permute(2, 0, 1)
        else:
            k = kc_i[tb].reshape(b, c, hq, dh)
            v = vc_i[tb].reshape(b, c, hq, dh)
        k = k.permute(2, 0, 1, 3).to(qh.dtype)          # [Hq, B, C, Dh]
        v = v.permute(2, 0, 1, 3).to(qh.dtype)
        s = torch.einsum("htd,hbcd->htbc", qh, k).float() * scale
        if quant:
            s = s * ks[:, None].float()
        dev = qh.device
        own = qseg.long()[:, None] == torch.arange(b, device=dev)[None]
        ok = torch.arange(c, device=dev)[None, :] < qcap[:, None]
        mask = own[:, :, None] & ok[:, None, :]
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
        sf = s.reshape(hq, tq, b * c)
        m = sf.amax(-1)
        p = torch.exp(sf - m[..., None])
        l = p.sum(-1)
        w = p.reshape(hq, tq, b, c).to(qh.dtype)
        if quant:
            w = w * vs[:, None].to(qh.dtype)
        o = torch.einsum("htbc,hbcd->htd", w, v).float()
        return o, m, l

    def _attend_block(qh, qseg, qpos, kb, vb, kseg, kpos, acc):
        """Fold one visiting fresh sub-block into the online softmax."""
        o, m, l = acc
        if quant:
            k = kb[0].transpose(0, 1).to(qh.dtype)       # [Hq, Bc, Dh]
            v = vb[0].transpose(0, 1).to(qh.dtype)
            ksh, vsh = kb[1].transpose(0, 1), vb[1].transpose(0, 1)
        else:
            k, v = kb.transpose(0, 1), vb.transpose(0, 1)
        s = torch.einsum("htd,hcd->htc", qh, k).float() * scale
        if quant:
            s = s * ksh[:, None].float()
        mask = (qseg.long()[:, None] == kseg.long()[None, :]) \
            & (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        w = p.to(qh.dtype)
        if quant:
            w = w * vsh[:, None].to(qh.dtype)
        pv = torch.einsum("htc,hcd->htd", w, v).float()
        return o * alpha[..., None] + pv, m_new, l * alpha + p.sum(-1)

    def _scatter(kc_i, vc_i, kb, vb, kseg, kpos, tables):
        """Write one visiting sub-block's rows into this rank's pool
        replica (pads to the trash block 0)."""
        valid = kpos >= 0
        p0 = torch.where(valid, kpos, torch.zeros_like(kpos)).long()
        blk = torch.where(valid, tables[kseg.long(), p0 // BS].long(),
                          torch.zeros_like(p0))
        off = p0 % BS
        if quant:
            kc_i.codes.index_put_((blk, off), kb[0])
            kc_i.scales.index_put_((blk, off), kb[1])
            vc_i.codes.index_put_((blk, off), vb[0])
            vc_i.scales.index_put_((blk, off), vb[1])
        else:
            kc_i.index_put_((blk, off), kb.to(kc_i.dtype))
            vc_i.index_put_((blk, off), vb.to(vc_i.dtype))

    def _fresh_payload(k, v, valid, scales_dtype):
        """Pad rows zeroed, encoded once when quantized (per row, as the
        trunk's own write encodes)."""
        kz = torch.where(valid[:, None, None], k, torch.zeros_like(k))
        vz = torch.where(valid[:, None, None], v, torch.zeros_like(v))
        if quant:
            return kv_encode(kz, scales_dtype), kv_encode(vz, scales_dtype)
        return kz, vz

    def _cut(t, c, bc):
        if quant:
            return tuple(x[c * bc:(c + 1) * bc] for x in t)
        return t[c * bc:(c + 1) * bc]

    def _rotate(kb, vb):
        flat = (list(kb) + list(vb)) if quant else [kb, vb]
        out = comm.shift(flat, mesh, "sp", 1)
        if quant:
            return tuple(out[:2]), tuple(out[2:])
        return out[0], out[1]

    def _ring_scatter(kc_i, vc_i, kb, vb, c, bc, tl, seg, pos, tables,
                      n, j, acc=None, q=None):
        """The n steps of one sub-block's rotation: write each visiting
        block into the pool (and fold it into `acc` when given)."""
        for s in range(n):
            base = ((j - s) % n) * tl + c * bc
            kseg, kpos = seg[base:base + bc], pos[base:base + bc]
            _scatter(kc_i, vc_i, kb, vb, kseg, kpos, tables)
            if acc is not None:
                acc = _attend_block(q[0], q[1], q[2], kb, vb, kseg, kpos,
                                    acc)
            if s + 1 < n:
                kb, vb = _rotate(kb, vb)
        return acc

    def ring(q, k, v, kc_i, vc_i, tables, seg, pos, starts):
        n, j = mesh.size("sp"), mesh.axis_index("sp")
        tl = q.shape[0]
        bc = _sub_block(tl, block_tokens)
        qseg, qpos = seg[j * tl:(j + 1) * tl], pos[j * tl:(j + 1) * tl]
        qh = q.transpose(0, 1)                         # [Hl, Tl, Dh]
        qcap = torch.where(qpos >= 0,
                           torch.minimum(starts[qseg.long()],
                                         qpos.long() + 1),
                           torch.zeros_like(qpos.long()))
        acc = _pool_partial(qh, qseg, qcap, kc_i, vc_i, tables)
        sdt = kc_i.scales.dtype if quant else None
        kz, vz = _fresh_payload(k, v, qpos >= 0, sdt)
        for c in range(tl // bc):
            acc = _ring_scatter(kc_i, vc_i, _cut(kz, c, bc), _cut(vz, c, bc),
                                c, bc, tl, seg, pos, tables, n, j, acc,
                                (qh, qseg, qpos))
        o, _m, l = acc
        out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        return out.transpose(0, 1)

    def ulysses(q, k, v, kc_i, vc_i, tables, seg, pos, starts):
        n, j = mesh.size("sp"), mesh.axis_index("sp")
        tl, hl, dh = q.shape
        hu = hl // n
        bc = _sub_block(tl, block_tokens)
        # seq -> head: my head slice over the whole stream, global order
        qh = comm.all_to_all(q, "sp", 1, 0, mesh).transpose(0, 1)
        qcap = torch.where(pos >= 0,
                           torch.minimum(starts[seg.long()],
                                         pos.long() + 1),
                           torch.zeros_like(pos.long()))
        h0 = j * hu
        if quant:
            kc_h = QuantizedKV(kc_i.codes[:, :, h0:h0 + hu],
                               kc_i.scales[:, :, h0:h0 + hu])
            vc_h = QuantizedKV(vc_i.codes[:, :, h0:h0 + hu],
                               vc_i.scales[:, :, h0:h0 + hu])
        else:
            kc_h, vc_h = kc_i[:, :, h0:h0 + hu], vc_i[:, :, h0:h0 + hu]
        acc = _pool_partial(qh, seg, qcap, kc_h, vc_h, tables)
        sdt = kc_i.scales.dtype if quant else None
        kz, vz = _fresh_payload(k, v, pos[j * tl:(j + 1) * tl] >= 0, sdt)
        dev = q.device
        gbase = (torch.arange(n, device=dev)[:, None] * tl
                 + torch.arange(bc, device=dev)[None, :]).reshape(-1)

        def a2a(t):
            if quant:
                return tuple(comm.all_to_all(x, "sp", 1, 0, mesh)
                             for x in t)
            return comm.all_to_all(t, "sp", 1, 0, mesh)

        for c in range(tl // bc):
            kb0, vb0 = _cut(kz, c, bc), _cut(vz, c, bc)
            gidx = gbase + c * bc
            acc = _attend_block(qh, seg, pos, a2a(kb0), a2a(vb0),
                                seg[gidx], pos[gidx], acc)
            _ring_scatter(kc_i, vc_i, kb0, vb0, c, bc, tl, seg, pos,
                          tables, n, j)
        o, _m, l = acc
        on = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        # head -> seq: only the normalized output crosses back
        return comm.all_to_all(on.transpose(0, 1).contiguous(), "sp", 0, 1,
                               mesh)

    return ring if mode == "ring" else ulysses


__all__ = ["DEFAULT_BLOCK_TOKENS", "sp_attention_peak_bytes",
           "sp_attention_flat_bound", "segment_starts",
           "build_sp_fresh_attention"]
