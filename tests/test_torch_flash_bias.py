"""CPU twins of the port's per-key-bias flash attention
(`paddle_tpu_torch.ops.flash_attention.flash_attention_bias`: K4 bias
forward, K6 + K9 bias backward; their plain versions on the CPU) and of
the attention op's dispatch, held to tests/test_flash_bias.py's
references on its `_setup` inputs: the JAX package's
`flash_attention_bias` in interpret mode and `_xla_attention` with
`jax.grad`, in float32.

Tolerances: out, dq, dk, dv atol 1e-5 and dbias atol 1e-4 (the
reference test's own); dbias is summed in float32 on both sides here
(the reference's Pallas backward casts ds to k's dtype before summing,
which only matters in bf16).

A FULLY MASKED row (every key carries -1e30) is held to `_xla_attention`
only: the reference's Pallas backward recomputes p = exp(s - lse) = 1
there instead of 1/n (its LSE, -1e30 + log n, rounds to -1e30), so its
gradients are off by about a factor of n; the port follows the XLA path.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention as fa
from paddle_tpu.ops.attention import _xla_attention

from paddle_tpu_torch.ops import attention as pa
from paddle_tpu_torch.ops import flash_attention as pf

torch.set_num_threads(1)

ATOL = 1e-5
DBIAS_ATOL = 1e-4


def _setup(B=2, H=3, S=256, D=32, seed=0, Sk=None):
    """tests/test_flash_bias.py's inputs (Sq == Sk there): batch 0 masks
    its last quarter of keys, batch 1 its last eighth."""
    Sk = S if Sk is None else Sk
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, H, Sk, D).astype(np.float32)
    v = rng.randn(B, H, Sk, D).astype(np.float32)
    bias = np.zeros((B, Sk), np.float32)
    bias[0, -Sk // 4:] = -1e30
    bias[1:, -Sk // 8:] = -1e30
    return q, k, v, bias


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _xla_vjp(q, k, v, bias, g, causal):
    """(out, (dq, dk, dv, dbias)) of `_xla_attention` with the bias as a
    [B|1, 1, 1, Sk] additive mask."""
    out, vjp = jax.vjp(lambda q_, k_, v_, b_: _xla_attention(
        q_, k_, v_, mask=b_[:, None, None, :], causal=causal)[0],
        *map(jnp.asarray, (q, k, v, bias)))
    return out, vjp(jnp.asarray(g))


def _port(q, k, v, bias, g, causal):
    """(out, (dq, dk, dv, dbias)) of the port's flash_attention_bias."""
    tq, tk, tv, tb = (_t(x, True) for x in (q, k, v, bias))
    out = pf.flash_attention_bias(tq, tk, tv, tb, causal=causal)
    out.backward(_t(g))
    return out, (tq.grad, tk.grad, tv.grad, tb.grad)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _check(port, ref):
    out, grads = port
    out_r, grads_r = ref
    _close(out, out_r, ATOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, grads_r):
        assert a.shape == tuple(b.shape), name
        _close(a, b, DBIAS_ATOL if name == "dbias" else ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fwd_and_grads_match_xla(causal):
    q, k, v, bias = _setup(seed=1 if causal else 0)
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    _check(_port(q, k, v, bias, g, causal),
           _xla_vjp(q, k, v, bias, g, causal))


def test_fwd_and_grads_match_pallas():
    """Against the reference's own custom vjp (K4 bias + K9 bias in
    interpret mode): output, the three gradients and dbias."""
    q, k, v, bias = _setup()
    g = np.ones(q.shape, np.float32)  # the reference test's `.sum()`
    out_r, vjp = jax.vjp(lambda q_, k_, v_, b_: fa.flash_attention_bias(
        q_, k_, v_, b_, False, None, 512, 512, True),
        *map(jnp.asarray, (q, k, v, bias)))
    _check(_port(q, k, v, bias, g, False), (out_r, vjp(jnp.asarray(g))))


def test_causal_forward_matches_pallas():
    q, k, v, bias = _setup(seed=1)
    ref = fa.flash_attention_bias(*map(jnp.asarray, (q, k, v, bias)),
                                  causal=True, interpret=True)
    out = pf.flash_attention_bias(_t(q), _t(k), _t(v), _t(bias),
                                  causal=True)
    _close(out, ref, ATOL)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_broadcast_batch_bias_grad(ref):
    """A [1, Sk] bias broadcast over the batch gets a [1, Sk] cotangent
    summed over the batch."""
    q, k, v, _ = _setup()
    bias1 = np.random.RandomState(7).randn(1, q.shape[2]).astype(np.float32)
    g = np.ones(q.shape, np.float32)
    if ref == "pallas":
        gr = jax.grad(lambda b_: fa.flash_attention_bias(
            *map(jnp.asarray, (q, k, v)), b_, False, None, 512, 512,
            True).sum())(jnp.asarray(bias1))
    else:
        gr = _xla_vjp(q, k, v, bias1, g, False)[1][3]
    out, grads = _port(q, k, v, bias1, g, False)
    assert grads[3].shape == (1, q.shape[2])
    _close(grads[3], gr, DBIAS_ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sq_ne_sk_matches_xla(causal):
    """256 queries over 384 keys (causal: bottom-right aligned, as the
    XLA path)."""
    q, k, v, bias = _setup(S=256, Sk=384, seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    _check(_port(q, k, v, bias, g, causal),
           _xla_vjp(q, k, v, bias, g, causal))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fully_masked_row_matches_xla(causal):
    """Batch 0 masks every key (a padded row with no real token): uniform
    weights over the keys each row sees, and softmax's gradients there,
    reaching q, k and the bias. Held to `_xla_attention` only — the
    reference's Pallas backward is off by about a factor of n on such a
    row (see the module docstring)."""
    q, k, v, bias = _setup(B=2, H=2, S=128, D=32, seed=5)
    bias[0] = -1e30
    g = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    port = _port(q, k, v, bias, g, causal)
    _check(port, _xla_vjp(q, k, v, bias, g, causal))
    assert port[1][0][0].abs().max() > 0  # dq of the masked row is live


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_kernels_match_pallas_kernels(causal):
    """The plain K4 bias and K9 bias (the kernels' CPU contract) against
    `_flash_fwd_lse` and `_flash_bwd_fused` with the tiled bias: out, lse,
    dq, dk, dv and the per-(batch, head) dbias rows."""
    q, k, v, bias = _setup(seed=8)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    B, H, S, _ = q.shape
    sc = q.shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    bias3 = fa._tile_bias(jnp.asarray(bias), B, H)
    out_r, lse_r = fa._flash_fwd_lse(jq, jk, jv, sc, causal, 128, 128, True,
                                     bias3)
    dq_r, dk_r, dv_r, db3 = fa._flash_bwd_fused(jq, jk, jv, out_r, lse_r, jg,
                                                sc, causal, 128, 128, True,
                                                bias3)
    out, lse = pf.flash_fwd_lse_plain(_t(q), _t(k), _t(v), sc, causal,
                                      _t(bias))
    _close(out, out_r, ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r)[..., 0],
                               rtol=1e-6, atol=ATOL)
    delta = pf.flash_delta_plain(_t(out_r), _t(g))
    grads = pf.flash_bwd_plain(_t(q), _t(k), _t(v), _t(g),
                               _t(np.asarray(lse_r)[..., 0]), delta, sc,
                               causal, _t(bias))
    assert grads[3].shape == (B * H, S)
    for a, b in zip(grads[:3], (dq_r, dk_r, dv_r)):
        _close(a, b, ATOL)
    _close(grads[3], np.asarray(db3)[:, 0, :], DBIAS_ATOL)


# bf16 against the reference's own bf16 rounding of p and ds (its
# `_tile_p_ds`); the port's plain K9 bias rounds only its outputs. At
# these shapes and seeds the gap is at most 0.72% of the largest gradient;
# held to half the card's bf16 limit (chip_smoke phase 3c: 2e-2 of the
# plain version's magnitude). No fully masked row here: there the
# reference's Pallas backward is off by design (ROADMAP §C 6).
BF16_REL = 1e-2


@pytest.mark.parametrize("causal,D", [(False, 32), (True, 64)],
                         ids=["full-d32", "causal-d64"])
def test_plain_bwd_bf16_matches_pallas_kernels(causal, D):
    """bf16 inputs through `_flash_bwd_fused` with the tiled bias
    (interpret mode) and the port's plain `flash_bwd` with the bias, both
    given the reference forward's bf16 out and its lse: dq, dk, dv in
    bf16, and dbias (the port's summed over heads), within BF16_REL of the
    reference's largest magnitude."""
    q, k, v, bias = _setup(seed=3, D=D)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    B, H, S, _ = q.shape
    sc = D ** -0.5
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in (tq, tk, tv, tg))
    bias3 = fa._tile_bias(jnp.asarray(bias), B, H)
    out_r, lse_r = fa._flash_fwd_lse(jq, jk, jv, sc, causal, 128, 128, True,
                                     bias3)
    ref = fa._flash_bwd_fused(jq, jk, jv, out_r, lse_r, jg, sc, causal, 128,
                              128, True, bias3)
    out = torch.from_numpy(np.array(jnp.asarray(out_r, jnp.float32)))
    port = pf.flash_bwd(tq, tk, tv, out.bfloat16(),
                        _t(np.asarray(lse_r)[..., 0]), tg, sc, causal,
                        _t(bias))
    db_ref = np.asarray(ref[3])[:, 0, :].reshape(B, H, S).sum(1)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), port,
                          (*ref[:3], db_ref)):
        assert a.dtype == (torch.float32 if name == "dbias"
                           else torch.bfloat16), name
        r = np.asarray(jnp.asarray(r, jnp.float32))
        err = np.abs(a.float().numpy() - r).max()
        assert err <= BF16_REL * np.abs(r).max(), (name, err)


def test_bias_of_another_dtype_gets_its_gradient_in_that_dtype():
    q, k, v, bias = _setup(B=2, H=1, S=64, D=32)
    tb = _t(bias).double().requires_grad_(True)
    out = pf.flash_attention_bias(_t(q), _t(k), _t(v), tb)
    out.sum().backward()
    assert tb.grad.dtype == torch.float64 and tb.grad.shape == (2, 64)


def test_bias_shape_is_checked():
    q, k, v, _ = _setup(B=2, H=1, S=64, D=32)
    with pytest.raises(ValueError, match="bias"):
        pf.flash_attention_bias(_t(q), _t(k), _t(v), torch.zeros(3, 64))


# ---- the dispatch of scaled_dot_product_attention --------------------------

def _spy(monkeypatch, module, name, calls, fn=None):
    orig = getattr(module, name)

    @functools.wraps(orig)
    def spy(*a, **kw):
        calls.append(name)
        return (fn or orig)(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("batch", [2, 1], ids=["per-row", "broadcast"])
def test_sdpa_sends_a_per_key_mask_to_the_bias_flash(monkeypatch, batch):
    q, k, v, bias = _setup()
    mask4 = bias[:batch, None, None, :]
    calls = []
    _spy(monkeypatch, pa, "flash_attention_bias", calls)
    _spy(monkeypatch, pa, "dense_attention", calls)
    tq, tm = _t(q, True), _t(mask4, True)
    out, w = pa.scaled_dot_product_attention(tq, _t(k), _t(v), attn_mask=tm)
    assert calls == ["flash_attention_bias"] and w is None
    g = np.ones(q.shape, np.float32)
    out_r, grads_r = _xla_vjp(q, k, v, bias[:batch], g, False)
    _close(out, out_r, ATOL)
    out.backward(_t(g))
    _close(tq.grad, grads_r[0], ATOL)
    assert tm.grad.shape == mask4.shape
    _close(tm.grad[:, 0, 0], grads_r[3], DBIAS_ATOL)


def test_sdpa_sends_a_keys_broadcast_mask_to_the_dense_path(monkeypatch):
    """The twin of `test_sdpa_rejects_keys_broadcast_mask`: a [B,1,1,1]
    mask is not a per-key bias (its last dim is not Sk) and takes the
    dense path."""
    q, k, v, _ = _setup()
    mask1 = np.zeros((q.shape[0], 1, 1, 1), np.float32) - 2.0

    def boom(*a, **kw):
        raise AssertionError("bias flash reached with a broadcast mask")

    monkeypatch.setattr(pa, "flash_attention_bias", boom)
    out, _ = pa.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                             attn_mask=_t(mask1))
    ref, _ = _xla_attention(*map(jnp.asarray, (q, k, v)),
                            mask=jnp.asarray(mask1), causal=False)
    _close(out, ref, ATOL)


def _reference_route(monkeypatch, q, k, v, mask):
    """The reference's choice for these arguments on a TPU: "flash" or
    "dense" (its gate with `_on_tpu` forced True and spies in place of
    its kernels and its XLA path)."""
    import paddle_tpu.ops.attention as A
    from paddle_tpu.core.autograd import functional_trace
    from paddle_tpu.core.tensor import Tensor

    calls = []
    monkeypatch.setattr(A, "_on_tpu", lambda: True)
    for name in ("flash_attention", "flash_attention_bias"):
        monkeypatch.setattr(fa, name, lambda q_, *a, **kw: (
            calls.append("flash"), jnp.zeros_like(q_))[1])
    orig = A._xla_attention
    monkeypatch.setattr(A, "_xla_attention", lambda *a, **kw: (
        calls.append("dense"), orig(*a, **kw))[1])
    with functional_trace():
        A.scaled_dot_product_attention.__raw_fn__(
            *(Tensor(jnp.asarray(x)) for x in (q, k, v)),
            attn_mask=None if mask is None else Tensor(jnp.asarray(mask)))
    assert len(calls) == 1, calls
    return calls[0]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 128, 256])
def test_sdpa_route_follows_the_reference_head_dim_clause(monkeypatch, d,
                                                          masked):
    """The port's flash routes take the head dims its kernels take (32,
    64, 128), as the reference's gate does at S = 128; every other D goes
    to `dense_attention`, where the reference takes `_xla_attention`.
    D 256, which the reference's kernels take, is the stated difference:
    the port sends it to `dense_attention` until its kernels take it."""
    q, k, v, bias = _setup(B=2, H=2, S=128, D=d)
    mask = bias[:, None, None, :] if masked else None
    ref = _reference_route(monkeypatch, q, k, v, mask)
    assert ref == ("flash" if d in (32, 64, 128, 256) else "dense")
    calls = []
    for name in ("flash_attention", "flash_attention_bias",
                 "dense_attention"):
        _spy(monkeypatch, pa, name, calls)
    out, _ = pa.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask))
    want = ("dense_attention" if d not in (32, 64, 128) else
            "flash_attention_bias" if masked else "flash_attention")
    assert calls == [want]
    ref_out, _ = _xla_attention(*map(jnp.asarray, (q, k, v)),
                                mask=None if mask is None
                                else jnp.asarray(mask))
    _close(out, ref_out, ATOL)


def test_masked_sdpa_on_the_card_reaches_the_bias_kernels(monkeypatch):
    """With `_on_card` forced True and the kernel wrappers replaced by
    spies (computing the plain versions), a masked call launches
    `flash_fwd_bias`, `flash_delta` and `flash_bwd_bias` once each and
    never the unbiased kernels."""
    from paddle_tpu_torch.ops import kernels

    calls = []
    monkeypatch.setattr(pf, "_on_card", lambda *t: True)
    _spy(monkeypatch, kernels, "flash_fwd_bias", calls,
         lambda q, k, v, b, sc, c: pf.flash_fwd_lse_plain(q, k, v, sc, c, b))
    _spy(monkeypatch, kernels, "flash_delta", calls, pf.flash_delta_plain)
    _spy(monkeypatch, kernels, "flash_bwd_bias", calls,
         lambda q, k, v, do, lse, dl, b, sc, c: pf.flash_bwd_plain(
             q, k, v, do, lse, dl, sc, c, b))
    for name in ("flash_fwd", "flash_bwd"):
        _spy(monkeypatch, kernels, name, calls)
    q, k, v, bias = _setup(B=2, H=2, S=64, D=32)
    tq = _t(q, True)
    out, _ = pa.scaled_dot_product_attention(
        tq, _t(k), _t(v), attn_mask=_t(bias[:, None, None, :]))
    out.sum().backward()
    assert calls == ["flash_fwd_bias", "flash_delta", "flash_bwd_bias"]
    ref, _ = _xla_attention(*map(jnp.asarray, (q, k, v)),
                            mask=jnp.asarray(bias)[:, None, None, :])
    _close(out, ref, ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sdpa_return_weights_match_xla(causal):
    q, k, v, bias = _setup(B=2, H=2, S=64, D=32, seed=4)
    mask = np.random.RandomState(1).randn(2, 1, 64, 64).astype(np.float32)
    ref, wr = _xla_attention(*map(jnp.asarray, (q, k, v, mask)),
                             causal=causal)
    out, w = pa.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=_t(mask), is_causal=causal,
        return_weights=True)
    _close(out, ref, ATOL)
    _close(w, wr, ATOL)


def test_sdpa_dropout_draws_from_its_generator():
    """dropout_p > 0 takes the dense path with the mask drawn from the
    generator: one seed twice gives the same output twice, and the
    weights it drops differ from no dropout."""
    q, k, v, _ = _setup(B=1, H=2, S=64, D=32)

    def run(seed):
        return pa.scaled_dot_product_attention(
            _t(q), _t(k), _t(v), dropout_p=0.25,
            generator=torch.Generator().manual_seed(seed))[0]

    a, b = run(3), run(3)
    assert torch.equal(a, b)
    plain, _ = pa.scaled_dot_product_attention(_t(q), _t(k), _t(v))
    assert not torch.allclose(a, plain, atol=1e-3)
    assert not torch.equal(a, run(4))
