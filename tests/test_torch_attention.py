"""The port's paged attention ops (paddle_tpu_torch/ops/attention.py,
plain PyTorch path on the CPU) held to the JAX reference on the same
inputs: the reference XLA ops and its Pallas kernels in interpret mode,
for dense float32 and int8 `QuantizedKV` pools — ragged lengths,
0-padded tables, a cached-prefix chunk (start > 0), a partial segment
plus pads, and a whole pad region.

Tolerance: float32 atol=1e-5 — the two frameworks sum the same products
in different orders. Only non-pad rows are compared; pad rows must be
finite."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_twin_util import t

torch.set_num_threads(1)

ATOL = 1e-5


def _quant_pair(kb, vb):
    """The same int8 pools on both sides: encoded once by the reference
    codec, handed to each framework as arrays."""
    from paddle_tpu.inference.kv_quant import QuantizedKV as JQ, kv_encode

    from paddle_tpu_torch.inference.kv_quant import QuantizedKV as TQ

    ck, sk = (np.asarray(a) for a in kv_encode(jnp.asarray(kb)))
    cv, sv = (np.asarray(a) for a in kv_encode(jnp.asarray(vb)))
    jk = JQ(jnp.asarray(ck), jnp.asarray(sk))
    jv = JQ(jnp.asarray(cv), jnp.asarray(sv))
    return (jk, jv), (TQ(t(ck), t(sk)), TQ(t(cv), t(sv)))


def _pools(kb, vb, quant):
    if quant:
        return _quant_pair(kb, vb)
    return ((jnp.asarray(kb), jnp.asarray(vb)), (t(kb), t(vb)))


# ---- paged decode (K2) ----------------------------------------------------

def _decode_case(seed, dh):
    rs = np.random.RandomState(seed)
    b, h, n, bs = 3, 4, 9, 4
    q = rs.randn(b, h, dh).astype(np.float32)
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 2]], np.int32)
    # ragged: mid-block, 0-padded table tail, exactly the full table
    lens = np.array([11, 5, 16], np.int32)
    return q, kb, vb, tables, lens


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dh", [8, 32])
def test_paged_decode_matches_reference_op(quant, dh):
    from paddle_tpu.ops.attention import paged_decode_attention as jref

    from paddle_tpu_torch.ops.attention import paged_decode_attention

    q, kb, vb, tables, lens = _decode_case(0, dh)
    (jk, jv), (tk, tv) = _pools(kb, vb, quant)
    ref = np.asarray(jref(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                          jnp.asarray(lens)))
    out = paged_decode_attention(t(q), tk, tv, t(tables), t(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_paged_decode_matches_pallas_interpret(quant):
    from paddle_tpu.ops.pallas.paged_attention import (
        paged_decode_attention_kernel)

    from paddle_tpu_torch.ops.attention import paged_decode_attention

    q, kb, vb, tables, lens = _decode_case(1, 8)
    (jk, jv), (tk, tv) = _pools(kb, vb, quant)
    ref = np.asarray(paged_decode_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True))
    out = paged_decode_attention(t(q), tk, tv, t(tables), t(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_paged_decode_ignores_trash_and_tail_rows():
    """Positions >= ctx_len (the trash block, a tail block's dead rows)
    must not influence the output however they are poisoned; an idle
    row (ctx=1 on the trash block) stays finite."""
    from paddle_tpu_torch.ops.attention import paged_decode_attention

    rs = np.random.RandomState(2)
    q = rs.randn(2, 2, 4).astype(np.float32)
    kb = rs.randn(4, 4, 2, 4).astype(np.float32)
    vb = rs.randn(4, 4, 2, 4).astype(np.float32)
    tables = np.array([[1, 2], [0, 0]], np.int32)
    lens = np.array([6, 1], np.int32)
    out1 = paged_decode_attention(t(q), t(kb), t(vb), t(tables),
                                  t(lens)).numpy()
    kb2, vb2 = kb.copy(), vb.copy()
    kb2[0, 1:] = 99.0
    vb2[0, 1:] = -99.0
    kb2[2, 2:] = 7.0
    vb2[2, 2:] = -7.0
    out2 = paged_decode_attention(t(q), t(kb2), t(vb2), t(tables),
                                  t(lens)).numpy()
    np.testing.assert_allclose(out1, out2, atol=1e-6)
    assert np.isfinite(out1).all()


# ---- ragged stream (K1) ---------------------------------------------------

def _stream_case(seed, dh=8):
    """Four 8-row tiles: seg0 a chunk at positions 8..15 over a cached
    prefix, seg1 fresh 0..7, seg2 a partial chunk 0..4 + pads, then a
    whole pad tile."""
    rs = np.random.RandomState(seed)
    n, bs, h = 9, 8, 4
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 0]], np.int32)
    seg = np.array([0] * 8 + [1] * 8 + [2] * 8 + [0] * 8, np.int32)
    pos = np.array(list(range(8, 16)) + list(range(8)) + list(range(5))
                   + [-1] * 3 + [-1] * 8, np.int32)
    q = rs.randn(len(seg), h, dh).astype(np.float32)
    return q, kb, vb, tables, seg, pos


def _unaligned_case(seed):
    """A packing with no tile alignment at all: seg0 resumes mid-prompt
    at 5..10, seg1 0..3, two pads (the reference test's stream)."""
    rs = np.random.RandomState(seed)
    n, bs, h, dh = 7, 4, 4, 8
    kb = rs.randn(n, bs, h, dh).astype(np.float32)
    vb = rs.randn(n, bs, h, dh).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    seg = np.array([0] * 6 + [1] * 4 + [0] * 2, np.int32)
    pos = np.array(list(range(5, 11)) + list(range(4)) + [-1, -1],
                   np.int32)
    q = rs.randn(len(seg), h, dh).astype(np.float32)
    return q, kb, vb, tables, seg, pos


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("case", ["tiles", "unaligned"])
def test_ragged_prefill_matches_reference_op(quant, case):
    from paddle_tpu.ops.attention import ragged_prefill_attention as jref

    from paddle_tpu_torch.ops.attention import ragged_prefill_attention

    q, kb, vb, tables, seg, pos = (_stream_case(3) if case == "tiles"
                                   else _unaligned_case(4))
    (jk, jv), (tk, tv) = _pools(kb, vb, quant)
    ref = np.asarray(jref(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                          jnp.asarray(seg), jnp.asarray(pos)))
    out = ragged_prefill_attention(t(q), tk, tv, t(tables), t(seg),
                                   t(pos)).numpy()
    valid = pos >= 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_ragged_prefill_matches_pallas_interpret(quant):
    from paddle_tpu.ops.pallas.unified_attention import (
        unified_ragged_attention_kernel)

    from paddle_tpu_torch.ops.attention import ragged_prefill_attention

    qt = 8
    q, kb, vb, tables, seg, pos = _stream_case(5)
    (jk, jv), (tk, tv) = _pools(kb, vb, quant)
    ref = np.asarray(unified_ragged_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(tables),
        jnp.asarray(seg[::qt]), jnp.asarray(pos[::qt]), q_tile=qt,
        interpret=True))
    out = ragged_prefill_attention(t(q), tk, tv, t(tables), t(seg),
                                   t(pos)).numpy()
    valid = pos >= 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL)


def test_ragged_prefill_decode_row_equals_paged_decode():
    """A stream row at pos p attends exactly what a decode query with
    ctx p+1 attends: the two ops agree on the same query."""
    from paddle_tpu_torch.ops.attention import (paged_decode_attention,
                                                ragged_prefill_attention)

    q, kb, vb, tables, lens = _decode_case(6, 32)
    seg = np.arange(3, dtype=np.int32)
    out_d = paged_decode_attention(t(q), t(kb), t(vb), t(tables),
                                   t(lens)).numpy()
    out_s = ragged_prefill_attention(t(q), t(kb), t(vb), t(tables), t(seg),
                                     t(lens - 1)).numpy()
    np.testing.assert_allclose(out_s, out_d, atol=ATOL)


def test_cpu_tensors_take_plain_path_without_building_kernels():
    """Dispatch is by device: CPU tensors never touch the kernel
    library (nothing is built or counted here)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.attention import paged_decode_attention

    before = kernels.launch_counts()
    q, kb, vb, tables, lens = _decode_case(7, 32)
    paged_decode_attention(t(q), t(kb), t(vb), t(tables), t(lens))
    assert kernels.launch_counts() == before
    assert kernels._lib is None


def test_mixed_devices_refused():
    from paddle_tpu_torch.ops.attention import _route

    q = torch.zeros(1, 1, 4)
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="span devices"):
        _route(q, meta)
