"""K2's split-KV algorithm on the CPU (the kernel itself is
`csrc/paged_decode_sm90.cu` and runs only on the card).

* `ops.kernels.decode_split_plan` — planned from B, H, M and BS alone —
  covers the cache positions [0, M * BS) exactly once with nonempty
  splits whose length is a multiple of the kernel's 64-key alignment, over
  a grid of shapes that includes BS 4 and BS 128 (the plan does not
  depend on head_dim), and gives serving's decode shape at least two CTAs
  for each of an H100's 132 SMs.
* A torch emulation of what the kernel computes — one float32 partial
  (m, l, acc) per (row, head, split) over the plan's splits, then the
  combine in split order, skipping empty partials — matches the JAX
  package's Pallas kernel (`paged_decode_attention_kernel(...,
  interpret=True)`) within 1e-5 in float32, dense and int8, on rows with
  ctx 0, ctx 1 on the trash block, ctx past M * BS, and contexts that end
  on a split boundary and one key either side of it. Inputs are made from
  a seed with numpy; int8 pools are encoded once by the reference codec.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import t

torch.set_num_threads(1)

ATOL = 1e-5
SMS = 132  # an H100's streaming multiprocessors


# ---- the plan --------------------------------------------------------------

PLAN_GRID = list(itertools.product((1, 8, 128), (4, 12, 25), (1, 7, 50, 64),
                                   (4, 16, 128)))


@pytest.mark.parametrize("b,h,m,bs", PLAN_GRID)
def test_split_plan_covers_the_table_once(b, h, m, bs):
    from paddle_tpu_torch.ops.kernels import SPLIT_ALIGN, decode_split_plan

    splits, chunk = decode_split_plan(b, h, m, bs)
    keys = m * bs
    assert splits >= 1 and chunk % SPLIT_ALIGN == 0
    seen = np.zeros(keys, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, keys)
        assert lo < hi, f"split {s} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,h,m,bs,min_ctas", [
    (8, 12, 50, 16, 2 * SMS),    # chip_smoke phase 5's decode step
    (8, 12, 64, 16, 2 * SMS),    # phase 3's case
    (128, 12, 64, 16, 2 * SMS),  # phase 3's serving-scale case
])
def test_split_plan_fills_the_card(b, h, m, bs, min_ctas):
    from paddle_tpu_torch.ops.kernels import SPLIT_HEADS, decode_split_plan

    splits, _chunk = decode_split_plan(b, h, m, bs)
    assert splits * b * -(-h // min(h, SPLIT_HEADS)) >= min_ctas


# ---- the algorithm against the reference -----------------------------------

def _emulate(q, kb, vb, tables, lens, scale, splits, chunk):
    """The kernel's arithmetic in float32: partials per (b, h, split),
    then the combine in split order. Pools are dense float32 or
    (codes, scales) pairs."""
    quant = isinstance(kb, tuple)
    kd, vd = (kb[0], vb[0]) if quant else (kb, vb)
    N, BS, H, Dh = kd.shape
    B, M = tables.shape
    lmax = M * BS
    out = torch.zeros(B, H, Dh)
    for b in range(B):
        ctx = min(max(int(lens[b]), 0), lmax)
        parts = []
        for s in range(splits):
            lo, hi = s * chunk, min((s + 1) * chunk, lmax, ctx)
            if lo >= hi:
                parts.append((torch.full((H,), -np.inf), torch.zeros(H),
                              torch.zeros(H, Dh)))
                continue
            pos = torch.arange(lo, hi)
            blk = tables[b, pos // BS].long().clamp(0, N - 1)
            rows = blk * BS + pos % BS
            k = kd.reshape(N * BS, H, Dh)[rows].float()   # [n, H, Dh]
            v = vd.reshape(N * BS, H, Dh)[rows].float()
            x = torch.einsum("hd,nhd->hn", q[b], k) * scale
            if quant:
                x = x * kb[1].reshape(N * BS, H)[rows].float().T
            m = x.max(dim=1).values
            p = torch.exp(x - m[:, None])
            l = p.sum(dim=1)
            if quant:
                p = p * vb[1].reshape(N * BS, H)[rows].float().T
            parts.append((m, l, torch.einsum("hn,nhd->hd", p, v)))
        live = [pt for pt in parts if (pt[1] > 0).all()]
        if not live:
            continue  # every split empty: zeros
        mx = torch.stack([pt[0] for pt in live]).max(dim=0).values
        acc, l = torch.zeros(H, Dh), torch.zeros(H)
        for m, ls, a in parts:   # split order; empty partials skipped
            if (ls > 0).all():
                f = torch.exp(m - mx)
                l = l + f * ls
                acc = acc + f[:, None] * a
        out[b] = acc / l.clamp_min(1e-30)[:, None]
    return out


def _case(seed, h, dh, bs, m):
    from paddle_tpu_torch.ops.kernels import decode_split_plan

    rs = np.random.RandomState(seed)
    b = 8
    splits, chunk = decode_split_plan(b, h, m, bs)
    keys = m * bs
    # ctx 0, an idle slot (ctx 1 on the trash block), past the table, on a
    # split boundary and one key either side, inside the first split, and
    # one drawn at random
    lens = np.array([0, 1, keys + 9, chunk, chunk - 1, chunk + 1,
                     min(5, keys), rs.randint(1, keys + 1)], np.int32)
    n = 1 + b * m
    tables = np.zeros((b, m), np.int32)
    perm = rs.permutation(n - 1) + 1
    for r in range(b):
        if r == 1:
            continue   # all trash
        tables[r] = perm[r * m:(r + 1) * m]
    q = rs.randn(b, h, dh).astype(np.float32)
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    return q, kb, vb, tables, lens, splits, chunk


def _encode(x):
    from paddle_tpu.inference.kv_quant import kv_encode

    return tuple(np.asarray(a) for a in kv_encode(jnp.asarray(x)))


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("h,dh,bs,m", [(2, 32, 4, 40), (3, 16, 16, 12),
                                       (2, 8, 128, 2)])
def test_split_emulation_matches_pallas_interpret(h, dh, bs, m, quant):
    from paddle_tpu.inference.kv_quant import QuantizedKV as JQ
    from paddle_tpu.ops.pallas.unified_attention import (
        paged_decode_attention_kernel)

    q, kb, vb, tables, lens, splits, chunk = _case(h * dh + bs, h, dh, bs, m)
    assert splits > 1, "the case must exercise the combine"
    scale = dh ** -0.5
    if quant:
        (ck, sk), (cv, sv) = _encode(kb), _encode(vb)
        jk = JQ(jnp.asarray(ck), jnp.asarray(sk))
        jv = JQ(jnp.asarray(cv), jnp.asarray(sv))
        tk, tv = (t(ck), t(sk)), (t(cv), t(sv))
    else:
        jk, jv = jnp.asarray(kb), jnp.asarray(vb)
        tk, tv = t(kb), t(vb)
    ref = np.asarray(paged_decode_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        scale=scale, interpret=True))
    out = _emulate(t(q), tk, tv, t(tables), lens, scale, splits,
                   chunk).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], 0.0)  # ctx 0: zeros
    np.testing.assert_allclose(out, ref, atol=ATOL)
