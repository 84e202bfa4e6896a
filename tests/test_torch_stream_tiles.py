"""The bf16 K1's tile algorithm on the CPU (the kernel itself is
`csrc/ragged_stream_sm90.cu` and runs only on the card).

A torch emulation does what the kernel computes: tiles of
`kernels.STREAM_ROWS` query rows of one head; the tile's distinct
segments, in order of first appearance, each a key pass up to its horizon
(the largest position of its rows, capped at M * BS - 1), in which the
rows of other segments see only masked keys; stages of
`kernels.STREAM_KEYS` keys through the block table, block ids clamped
into [0, N) and columns past M read from block 0; the online softmax in
log2 units; int8 codes dequantized where the kernel converts them (code
* scale, rounded to bf16 when the kernel's rounding is emulated); P
rounded to bf16 before P.V when it is. It is held:

* against the JAX package's Pallas kernel
  (`unified_ragged_attention_kernel(..., interpret=True, q_tile=8)`) on
  a stream that keeps the reference's one-segment-per-tile contract,
  which the emulation's 64-row tiles still mix;
* against the port's plain version (`ragged_prefill_attention_plain`) on
  mixed tiles (a segment boundary at every offset mod 8, a segment that
  comes back later in its tile), pad rows of every kind (exact zeros
  here; the plain version's are garbage it discards), a horizon past
  M * BS, BS 4 and 16, Dh 32 and 64, dense and int8.

Inputs are made from a seed with numpy; int8 pools are encoded once by
the reference codec. Tolerances: float32 atol 1e-5 (the same products,
summed in another order). With the kernel's bf16 rounding of P, against
the plain version on the same bf16-representable inputs (int8 pools
handed to it already dequantized to bf16, as the kernel converts them):
bf16's unit roundoff is 2^-8 (8 significant bits), so each weight moves
by at most 2^-8 of itself and the output by at most 2^-8 * max|v|, plus
1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import t

torch.set_num_threads(1)

ATOL = 1e-5
LOG2E = 1.4426950408889634


def _emulate(q, kb, vb, tables, seg, pos, scale, bf16=False):
    """The bf16 K1's arithmetic on CPU tensors. Pools are dense [N, BS, H,
    Dh] or (codes, scales) pairs; with `bf16` the dequantized pool vectors
    and P are rounded to bf16 where the kernel rounds them."""
    from paddle_tpu_torch.ops.kernels import STREAM_KEYS, STREAM_ROWS

    quant = isinstance(kb, tuple)
    kd, vd = (kb[0], vb[0]) if quant else (kb, vb)
    N, BS, H, Dh = kd.shape
    B, M = tables.shape
    cap = M * BS - 1
    T = q.shape[0]
    rnd = (lambda x: x.bfloat16().float()) if bf16 else (lambda x: x)

    def load(pool, rows):  # the stage's vectors, as the kernel holds them
        if not quant:
            return pool.reshape(N * BS, H, Dh)[rows].float()
        codes, scales = pool
        x = codes.reshape(N * BS, H, Dh)[rows].float()
        return rnd(x * scales.reshape(N * BS, H)[rows].float()[..., None])

    out = torch.zeros(T, H, Dh)
    for t0 in range(0, T, STREAM_ROWS):
        rs = seg[t0:t0 + STREAM_ROWS].long()
        rp = pos[t0:t0 + STREAM_ROWS].long()
        pad = (rs < 0) | (rs >= B) | (rp < 0)
        rs, rp = rs.masked_fill(pad, -1), rp.masked_fill(pad, -1)
        passes = []
        for s in rs.tolist():
            if s >= 0 and s not in [p[0] for p in passes]:
                passes.append((s, min(int(rp[rs == s].max()), cap)))
        n = rs.shape[0]
        qt = q[t0:t0 + n].float()
        m = torch.full((n, H), -np.inf)
        l = torch.zeros(n, H)
        acc = torch.zeros(n, H, Dh)
        for s, hz in passes:
            lim = torch.where(rs == s, rp.clamp(max=cap), -1)
            for k0 in range(0, hz + 1, STREAM_KEYS):
                kpos = torch.arange(k0, k0 + STREAM_KEYS)
                col = kpos // BS
                blk = torch.where(col < M,
                                  tables[s, col.clamp(max=M - 1)].long()
                                  .clamp(0, N - 1), 0)
                rows = blk * BS + kpos % BS
                k, v = load(kb if quant else kd, rows), \
                    load(vb if quant else vd, rows)
                x = torch.einsum("nhd,jhd->nhj", qt, k) * (scale * LOG2E)
                x = x.masked_fill(kpos[None, None, :] > lim[:, None, None],
                                  -np.inf)
                m_new = torch.maximum(m, x.max(dim=-1).values)
                m_use = torch.where(m_new == -np.inf, 0.0, m_new)
                alpha = torch.exp2(m - m_use)
                p = torch.exp2(x - m_use[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "nhj,jhd->nhd", rnd(p), v)
                m = m_new
        out[t0:t0 + n] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _encode(x):
    from paddle_tpu.inference.kv_quant import kv_encode

    return tuple(np.asarray(a) for a in kv_encode(jnp.asarray(x)))


def _stream(spec):
    """(seg, pos) of a packing spec: (row, first position, length, pads)
    per segment; row -1 is a pad region of `length` rows."""
    seg, pos = [], []
    for row, p0, n, pads in spec:
        if row < 0:
            seg += [0] * n
            pos += [-1] * n
            continue
        seg += [row] * n + [row] * pads
        pos += list(range(p0, p0 + n)) + [-1] * pads
    return np.array(seg, np.int32), np.array(pos, np.int32)


def _tables(rs, need, bs, m=None):
    """Disjoint random blocks per row, 0-padded (block 0 is trash)."""
    nb = [-(-c // bs) for c in need]
    m = m or max(nb)
    n = 1 + sum(min(k, m) for k in nb)
    perm = rs.permutation(n - 1) + 1
    tab = np.zeros((len(need), m), np.int32)
    o = 0
    for r, k in enumerate(nb):
        k = min(k, m)
        tab[r, :k] = perm[o:o + k]
        o += k
    return tab, n


# ---- against the reference's Pallas kernel ----------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("bs", [4, 16])
def test_emulation_matches_pallas_interpret(bs, quant):
    """A 128-row stream aligned to the reference's 8-row tiles: a chunk
    over a cached prefix, a fresh segment, a partial segment with pads, a
    second cached-prefix chunk and a pad region. The emulation's 64-row
    tiles hold several of these segments each."""
    from paddle_tpu.inference.kv_quant import QuantizedKV as JQ
    from paddle_tpu.ops.pallas.unified_attention import (
        unified_ragged_attention_kernel)

    qt, h, dh = 8, 2, 32
    rs = np.random.RandomState(20 + bs)
    seg, pos = _stream([(0, 24, 40, 0), (1, 0, 24, 0), (2, 0, 13, 3),
                        (3, 100, 32, 0), (-1, 0, 16, 0)])
    tables, n = _tables(rs, [64, 24, 13, 132], bs)
    q = rs.randn(len(seg), h, dh).astype(np.float32)
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    scale = dh ** -0.5
    if quant:
        (ck, sk), (cv, sv) = _encode(kb), _encode(vb)
        jk = JQ(jnp.asarray(ck), jnp.asarray(sk))
        jv = JQ(jnp.asarray(cv), jnp.asarray(sv))
        tk, tv = (t(ck), t(sk)), (t(cv), t(sv))
    else:
        jk, jv = jnp.asarray(kb), jnp.asarray(vb)
        tk, tv = t(kb), t(vb)
    tile_pos = pos[::qt].copy()
    ref = np.asarray(unified_ragged_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(tables),
        jnp.asarray(seg[::qt]), jnp.asarray(tile_pos), scale=scale,
        q_tile=qt, interpret=True))
    out = _emulate(t(q), tk, tv, t(tables), t(seg), t(pos), scale).numpy()
    valid = pos >= 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)
    assert (out[~valid] == 0).all()


# ---- against the port's plain version on mixed tiles ------------------------

def _mixed_case(seed, h, dh, bs):
    """A 200-row stream over 8 table rows: nine 9-row chunks whose
    boundaries fall on every offset mod 8, a segment that comes back later
    in its tile, pad rows of every kind (pos -1, seg -1, seg past the
    table's rows), and a segment whose positions run past M * BS."""
    rs = np.random.RandomState(seed)
    spec = [(r % 5, 9 * r, 9, 0) for r in range(9)]      # boundaries
    spec += [(5, 3, 20, 4), (6, 0, 11, 0), (5, 23, 6, 2)]  # 5 comes back
    spec += [(-1, 0, 7, 0), (7, 90, 30, 0), (6, 11, 5, 0)]
    seg, pos = _stream(spec)
    seg[len(seg) - 30] = -1          # a pad by its segment
    pos[len(seg) - 30] = 12
    seg[len(seg) - 29] = 8           # past the table's rows
    pos[len(seg) - 29] = 12
    pad = np.zeros(200 - len(seg), np.int32)
    seg = np.concatenate([seg, pad])
    pos = np.concatenate([pos, pad - 1])
    need = [0] * 8
    for s, p in zip(seg, pos):
        if 0 <= s < 8 and p >= 0:
            need[s] = max(need[s], int(p) + 1)
    # the table stops short of segment 7's last positions
    m = max(-(-c // bs) for c in need[:7])
    assert m * bs < need[7]
    tables, n = _tables(rs, need, bs, m)
    q = rs.randn(len(seg), h, dh).astype(np.float32)
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    return q, kb, vb, tables, seg, pos


def _passes(seg, pos, b):
    """The key passes of each of the kernel's tiles."""
    from paddle_tpu_torch.ops.kernels import STREAM_ROWS

    out = []
    for t0 in range(0, len(seg), STREAM_ROWS):
        s, p = seg[t0:t0 + STREAM_ROWS], pos[t0:t0 + STREAM_ROWS]
        live = (s >= 0) & (s < b) & (p >= 0)
        out.append(len(set(s[live].tolist())))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("bs", [4, 16])
def test_emulation_matches_plain_on_mixed_tiles(bs, dh, quant):
    from paddle_tpu_torch.inference.kv_quant import QuantizedKV
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention_plain

    q, kb, vb, tables, seg, pos = _mixed_case(40 + bs + dh, 3, dh, bs)
    ends = np.flatnonzero(seg[1:] != seg[:-1]) + 1
    assert set((ends % 8).tolist()) == set(range(8))
    assert max(_passes(seg, pos, tables.shape[0])) >= 5
    scale = dh ** -0.5
    if quant:
        (ck, sk), (cv, sv) = _encode(kb), _encode(vb)
        tk, tv = (t(ck), t(sk)), (t(cv), t(sv))
        pk, pv = QuantizedKV(*tk), QuantizedKV(*tv)
    else:
        tk, tv = pk, pv = t(kb), t(vb)
    out = _emulate(t(q), tk, tv, t(tables), t(seg), t(pos), scale).numpy()
    ref = ragged_prefill_attention_plain(t(q), pk, pv, t(tables), t(seg),
                                         t(pos), scale).numpy()
    valid = (pos >= 0) & (seg >= 0) & (seg < tables.shape[0])
    assert (out[~valid] == 0).all()  # pad rows: exact zeros
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("bs", [4, 16])
def test_emulation_with_bf16_rounding_matches_plain(bs, quant):
    """The kernel's roundings (bf16 P; int8 vectors dequantized to bf16)
    against the plain version in float32 on the same bf16-representable
    inputs, int8 pools given to it already dequantized to bf16."""
    from paddle_tpu_torch.ops.attention import ragged_prefill_attention_plain

    dh = 64
    q, kb, vb, tables, seg, pos = _mixed_case(60 + bs, 2, dh, bs)
    bf = lambda a: t(a).bfloat16().float()  # noqa: E731
    scale = dh ** -0.5
    if quant:
        (ck, sk), (cv, sv) = _encode(kb), _encode(vb)
        sk, sv = bf(sk), bf(sv)
        tk, tv = (t(ck), sk), (t(cv), sv)
        pk = (t(ck).float() * sk[..., None]).bfloat16().float()
        pv = (t(cv).float() * sv[..., None]).bfloat16().float()
    else:
        tk, tv = pk, pv = bf(kb), bf(vb)
    qb = bf(q)
    out = _emulate(qb, tk, tv, t(tables), t(seg), t(pos), scale,
                   bf16=True).numpy()
    ref = ragged_prefill_attention_plain(qb, pk, pv, t(tables), t(seg),
                                         t(pos), scale).numpy()
    valid = (pos >= 0) & (seg >= 0) & (seg < tables.shape[0])
    tol = 2.0 ** -8 * pv.abs().max().item() + ATOL
    assert (out[~valid] == 0).all()
    np.testing.assert_allclose(out[valid], ref[valid], atol=tol)
    # the rounding of P is real: on the same (dequantized) vectors without
    # it the emulation is the plain version
    exact = _emulate(qb, pk, pv, t(tables), t(seg), t(pos), scale).numpy()
    np.testing.assert_allclose(exact[valid], ref[valid], atol=ATOL)
    assert np.abs(out[valid] - exact[valid]).max() > 0
