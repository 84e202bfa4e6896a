"""CPU twins of the port's flash attention (`paddle_tpu_torch.ops.
flash_attention`): the plain versions of K4 (forward with LSE), K6
(delta) and K9 (fused backward) and the eager autograd rule,
held to the JAX package's Pallas kernels `_flash_fwd_lse`, `_delta_rows`,
`_flash_bwd_fused` and its custom-vjp `flash_attention`, run in interpret
mode as tests/test_models.py runs them, on the same float32 inputs made
with numpy.

Tolerances are the reference tests' own: forward rtol 2e-4 / atol 2e-5,
gradients rtol 2e-3 / atol 2e-4 (both sides sum in float32 in another
order). The bf16 backward cases hold the port's plain K9 to the
reference's own bf16 rounding (BF16_REL below), the float16 cases every
plain kernel to the reference's float16 kernels (F16_REL). The reference's LSE is
broadcast over 8 lanes; the port keeps one value per row, compared
against lane 0.

Causal masking: the Pallas kernels align top-left, the reference's
`_reference_attention` bottom-right; they agree at Sq == Sk, which is
every Pallas case here. The Sq != Sk and ragged cases are held to
`_reference_attention` (the port takes bottom-right)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention as fa
from paddle_tpu_torch.ops import flash_attention as pf

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)

CASES = [(b, s, d, causal) for b in (1, 2) for s in (128, 256)
         for d in (32, 64) for causal in (False, True)]


def _ids(c):
    b, s, d, causal = c
    return f"b{b}-s{s}-d{d}-{'causal' if causal else 'full'}"


def _inputs(seed, b, h, sq, sk, d, n=4):
    """q, then n-1 more [b, h, s, d] float32 arrays (k, v at sk; the
    rest at sq) from one numpy stream."""
    rs = np.random.RandomState(seed)
    shapes = [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d)] + \
        [(b, h, sq, d)] * (n - 3)
    return [rs.randn(*sh).astype(np.float32) for sh in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **tol)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fwd_lse_matches_pallas(case):
    b, s, d, causal = case
    q, k, v = _inputs(1, b, 2, s, s, d, 3)
    sc = d ** -0.5
    out_r, lse_r = fa._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), sc, causal, s // 2,
                                     s // 2, True)
    out, lse = pf.flash_fwd_lse(_t(q), _t(k), _t(v), sc, causal)
    assert out.dtype == torch.float32 and lse.shape == (b * 2, s)
    _close(out, out_r, FWD_TOL)
    _close(lse, np.asarray(lse_r)[..., 0], FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_delta_matches_pallas(case):
    b, s, d, _causal = case
    o, do = _inputs(2, b, 2, s, s, d, 3)[:2]
    ref = fa._delta_rows(jnp.asarray(o.reshape(b * 2, s, d)),
                         jnp.asarray(do.reshape(b * 2, s, d)), True)
    delta = pf.flash_delta(_t(o), _t(do))
    assert delta.shape == (b * 2, s) and delta.dtype == torch.float32
    _close(delta, np.asarray(ref)[..., 0], FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fused_bwd_matches_pallas(case):
    """The plain K9 (through `flash_bwd`, which runs the plain K6 first)
    against `_flash_bwd_fused`, both given the reference forward's out
    and lse."""
    b, s, d, causal = case
    q, k, v, g = _inputs(3, b, 2, s, s, d)
    sc = d ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_r, lse_r = fa._flash_fwd_lse(jq, jk, jv, sc, causal, s // 2, s // 2,
                                     True)
    ref = fa._flash_bwd_fused(jq, jk, jv, out_r, lse_r, jg, sc, causal,
                              s // 2, s // 2, True)[:3]
    grads = pf.flash_bwd(_t(q), _t(k), _t(v), _t(out_r),
                         _t(np.asarray(lse_r)[..., 0]), _t(g), sc, causal)
    for port, r in zip(grads, ref):
        _close(port, r, GRAD_TOL)


# bf16 against the reference's own bf16 rounding: its `_tile_p_ds`
# rounds p and ds to bf16 before the products; the port's plain K9
# computes in float32 and rounds only its outputs (the card's bf16 K9
# rounds p and ds as the reference does). Their gap, at most 0.53% of
# the largest gradient at these shapes and seeds, is the basis of the
# card's bf16 limit of 2e-2 of the plain version's magnitude (chip_smoke
# phase 3b); held here to half that limit.
BF16_REL = 1e-2
BF16_CASES = [(1, 256, 64, True), (2, 128, 32, False), (1, 256, 128, True)]


def _bf16(a):
    """A numpy float32 array rounded to bf16, for both frameworks."""
    return torch.from_numpy(a).bfloat16()


def _rel_close(port, ref, tol):
    port = port.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("case", BF16_CASES, ids=_ids)
def test_fused_bwd_bf16_matches_pallas(case):
    """bf16 inputs through `_flash_bwd_fused` (interpret mode) and the
    port's plain `flash_bwd`, both given the reference forward's bf16 out
    and its lse: dq, dk, dv in bf16 within BF16_REL of the reference's
    largest magnitude."""
    b, s, d, causal = case
    tq, tk, tv, tg = (_bf16(x) for x in _inputs(10, b, 2, s, s, d))
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in (tq, tk, tv, tg))
    sc = d ** -0.5
    out_r, lse_r = fa._flash_fwd_lse(jq, jk, jv, sc, causal, 128, 128, True)
    ref = fa._flash_bwd_fused(jq, jk, jv, out_r, lse_r, jg, sc, causal, 128,
                              128, True)[:3]
    out = torch.from_numpy(np.array(jnp.asarray(out_r, jnp.float32)))
    grads = pf.flash_bwd(tq, tk, tv, out.bfloat16(),
                         _t(np.asarray(lse_r)[..., 0]), tg, sc, causal)
    for port, r in zip(grads[:3], ref):
        assert port.dtype == torch.bfloat16
        _rel_close(port, r, BF16_REL)


# float16 against the reference's Pallas kernels on the same float16
# inputs: K4, K6, K9 and the two-pass K7 + K8, each plain and with a
# per-key bias (a padding row). The reference rounds p to v's dtype
# before P.V and its `_tile_p_ds` rounds p and ds to float16; the port's
# plain versions round p and ds in float16 too (`_p_ds`), but keep the
# forward's weights in float32. The largest gap at these cases is 5.6e-4
# of the reference's largest magnitude (K4 bias's out; the backward's
# outputs and dbias at most 2.2e-4, delta 1.2e-7); held to F16_REL, about
# 2x that. The LSE is computed in float32 on both sides from float16
# scores.
F16_REL = 1.2e-3
F16_KERNELS = ["k4", "k4_bias", "k6", "k9", "k9_bias", "k7_k8",
               "k7_k8_bias"]


def _f16(a):
    return torch.from_numpy(a).half()


@pytest.mark.parametrize("kernel", F16_KERNELS)
def test_float16_matches_pallas(kernel):
    """The port's plain K4, K6, K9, K7 and K8 (plain and bias) on float16
    inputs against `_flash_fwd_lse`, `_delta_rows`, `_flash_bwd_fused` and
    `_flash_bwd` in interpret mode on the same float16 inputs, within
    F16_REL of the reference's largest magnitude; outputs in float16."""
    b, h, s, d = 1, 2, 128, 32 if kernel.startswith("k9") else 64
    causal = kernel in ("k4", "k9", "k7_k8")
    tq, tk, tv, tg = (_f16(x) for x in _inputs(20, b, h, s, s, d))
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.float16)
                      for t in (tq, tk, tv, tg))
    sc = d ** -0.5
    bias = None
    if kernel.endswith("bias"):
        bias = np.zeros((b, s), np.float32)
        bias[0, s - 40:] = -1e30
    bias3 = None if bias is None else fa._tile_bias(jnp.asarray(bias), b, h)
    tb = None if bias is None else _t(bias)
    out_r, lse_r = fa._flash_fwd_lse(jq, jk, jv, sc, causal, 64, 64, True,
                                     bias3)
    lse0 = _t(np.asarray(lse_r)[..., 0])
    out16 = torch.from_numpy(np.array(jnp.asarray(out_r, jnp.float32))) \
        .half()
    if kernel.startswith("k4"):
        out, lse = pf.flash_fwd_lse(tq, tk, tv, sc, causal, tb)
        assert out.dtype == torch.float16
        _rel_close(out, out_r, F16_REL)
        np.testing.assert_allclose(lse.numpy(), lse0.numpy(), rtol=1e-4,
                                   atol=1e-4)
        return
    if kernel == "k6":
        ref = fa._delta_rows(jnp.asarray(out_r).reshape(b * h, s, d),
                             jg.reshape(b * h, s, d), True)
        delta = pf.flash_delta(out16, tg)
        assert delta.dtype == torch.float32
        _rel_close(delta, np.asarray(ref)[..., 0], F16_REL)
        return
    bwd = fa._flash_bwd_fused if kernel.startswith("k9") else fa._flash_bwd
    port = pf.flash_bwd if kernel.startswith("k9") else pf.flash_bwd_two_pass
    ref = bwd(jq, jk, jv, out_r, lse_r, jg, sc, causal, 64, 64, True, bias3)
    grads = port(tq, tk, tv, out16, lse0, tg, sc, causal, tb)
    for got, want in zip(grads[:3], ref[:3]):
        assert got.dtype == torch.float16
        _rel_close(got, want, F16_REL)
    if bias is not None:
        db = np.asarray(ref[3]).reshape(b, h, 8, -1)[:, :, 0, :].sum(1)
        _rel_close(grads[3], db, F16_REL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_attention_autograd_matches_pallas(case):
    """`flash_attention` (forward K4, backward K6 + K9) against the
    reference's custom-vjp `flash_attention`: output and the vjp of a
    random cotangent."""
    b, s, d, causal = case
    q, k, v, g = _inputs(4, b, 2, s, s, d)
    out_r, vjp = jax.vjp(
        lambda q, k, v: fa.flash_attention(q, k, v, causal, None, s // 2,
                                           s // 2, True),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = pf.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_t(g))
    _close(out, out_r, FWD_TOL)
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(port, r, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_lanes_variant_forward_equals_port(monkeypatch, causal):
    """K5 (`PADDLE_TPU_FA_LANES=1`, m/l kept over 128 lanes) computes K4's
    function; the port has one forward, and it equals K5's output."""
    q, k, v = _inputs(5, 2, 3, 256, 256, 64, 3)
    sc = 64 ** -0.5
    monkeypatch.setattr(fa, "_FA_LANES", True)
    out_r, lse_r = fa._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), sc, causal, 128, 128,
                                     True)
    out, lse = pf.flash_fwd_lse(_t(q), _t(k), _t(v), sc, causal)
    _close(out, out_r, FWD_TOL)
    _close(lse, np.asarray(lse_r)[..., 0], FWD_TOL)


@pytest.mark.parametrize("sq,sk,causal", [
    (64, 192, True),    # more keys than queries: bottom-right offset
    (192, 64, True),    # more queries: rows 0..127 see no key
    (200, 200, True),   # ragged length (the Pallas gate needs S % 128)
    (200, 200, False),
    (100, 37, False),
])
def test_unaligned_lengths_match_reference_attention(sq, sk, causal):
    """Sq != Sk and S % 128 != 0 against `_reference_attention` and its
    autodiff: bottom-right causal alignment, and a row that sees no key
    averages every value and passes no gradient to q or k."""
    d = 32
    q, k, v, g = _inputs(6, 2, 2, sq, sk, d)
    out_r, vjp = jax.vjp(
        lambda q, k, v: fa._reference_attention(q, k, v, d ** -0.5, causal),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = pf.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_t(g))
    _close(out, out_r, FWD_TOL)
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(port, r, GRAD_TOL)
    if causal and sq > sk:
        dead = sq - sk
        np.testing.assert_allclose(out[:, :, :dead].detach().numpy(),
                                   np.broadcast_to(v.mean(2, keepdims=True),
                                                   (2, 2, dead, d)),
                                   **FWD_TOL)
        assert (tq.grad[:, :, :dead] == 0).all()


def test_sdpa_matches_reference_op():
    """The port's `scaled_dot_product_attention` (prescaled q, kernels at
    scale 1.0) against the reference op on the CPU (its XLA path), with
    gradients."""
    import paddle_tpu.ops.attention as ra

    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention

    q, k, v, g = _inputs(7, 2, 3, 128, 128, 32)
    for causal in (False, True):
        out_r, vjp = jax.vjp(
            lambda q, k, v: ra._xla_attention(q, k, v, None, None,
                                              causal)[0],
            *map(jnp.asarray, (q, k, v)))
        ref = vjp(jnp.asarray(g))
        tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
        out, w = scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
        assert w is None
        out.backward(_t(g))
        _close(out, out_r, FWD_TOL)
        for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
            _close(port, r, GRAD_TOL)


def test_sdpa_prescales_q_in_its_dtype():
    """bf16: the op feeds the kernel (q * scale) rounded to bf16 at scale
    1.0, as the reference does — not q at scale D**-0.5."""
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention

    q, k, v = (_t(x).bfloat16() for x in _inputs(8, 1, 2, 64, 64, 64, 3))
    out, _ = scaled_dot_product_attention(q, k, v, is_causal=True)
    want = pf.flash_attention((q * 64 ** -0.5).bfloat16(), k, v, True, 1.0)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def test_flash_wrappers_take_bh_above_the_grid_limit():
    """B * H past grid y's 65535 is taken (the SIMT kernels launch in
    chunks of bh, the bf16 K4 and K9 put bh on grid x); the shapes are
    checked without memory."""
    from paddle_tpu_torch.ops import kernels

    q = torch.empty(4096, 16, 8, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(4096, 16, 24, 32, dtype=torch.bfloat16, device="meta")
    assert kernels._qkv_shapes("flash_fwd", q, q, q) == (65536, 8, 8, 32)
    assert kernels._qkv_shapes("flash_bwd", q, k, k) == (65536, 8, 24, 32)


def test_wrappers_refuse_cpu_tensors():
    """The flash kernel wrappers launch or raise; the plain versions live
    in ops.flash_attention."""
    from paddle_tpu_torch.ops import kernels

    q = torch.zeros(1, 2, 16, 32)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.flash_fwd(q, q, q, 1.0, True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.flash_delta(q, q)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.flash_bwd(q, q, q, q, lse, lse, 1.0, True)
    bias = torch.zeros(1, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.flash_fwd_bias(q, q, q, bias, 1.0, False)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.flash_bwd_bias(q, q, q, q, lse, lse, bias, 1.0, False)
    with pytest.raises(ValueError, match="head_dim 48"):
        kernels.flash_fwd(torch.zeros(1, 2, 16, 48),
                          torch.zeros(1, 2, 16, 48),
                          torch.zeros(1, 2, 16, 48), 1.0, True)
