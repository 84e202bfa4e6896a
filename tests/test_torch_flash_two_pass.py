"""CPU twins of the port's two-pass flash backward
(`paddle_tpu_torch.ops.flash_attention.flash_bwd_two_pass`: K6, then K7
for dq and K8 for dk, dv and dbias; their plain versions on the CPU) and
of the switch that picks it (`uses_two_pass`), held to the JAX package's
`_flash_bwd` in interpret mode (tests/test_models.py and
tests/test_flash_bias.py run it so), `_reference_attention`,
`_xla_attention` with `jax.grad`, and the reference's custom-vjp
backwards `_fa_bwd`/`_fab_bwd`, on the same float32 inputs made with
numpy.

Tolerances are the bias twins': atol 1e-5 for dq, dk and dv and 1e-4 for
dbias (both sides sum in float32, in another order).

Causal masking: the Pallas kernels align top-left and the port
bottom-right; they agree at Sq == Sk, which is every `_flash_bwd` case
here. Sq != Sk is held to `_reference_attention`, and a fully masked row
to `_xla_attention` only (the reference's Pallas backward recomputes
p = 1 instead of 1/n on such a row; see tests/test_torch_flash_bias.py).
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention as fa
from paddle_tpu.ops.attention import _xla_attention

from paddle_tpu_torch.ops import flash_attention as pf
from paddle_tpu_torch.ops import kernels

torch.set_num_threads(1)

ATOL = 1e-5
DBIAS_ATOL = 1e-4


def _inputs(seed, b, h, sq, sk, d, n=4):
    """q, k, v and n-3 more [b, h, sq, d] float32 arrays (k, v at sk) from
    one numpy stream."""
    rs = np.random.RandomState(seed)
    shapes = [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d)] + \
        [(b, h, sq, d)] * (n - 3)
    return [rs.randn(*sh).astype(np.float32) for sh in shapes]


def _padding_bias(b, sk):
    """tests/test_flash_bias.py's mask: batch 0 hides its last quarter of
    keys, the others their last eighth."""
    bias = np.zeros((b, sk), np.float32)
    bias[0, -sk // 4:] = -1e30
    bias[1:, -sk // 8:] = -1e30
    return bias


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _check(port, ref):
    """dq, dk, dv (and dbias when the reference has one)."""
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), port, ref):
        if r is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == tuple(np.shape(r)), name
        _close(a, r, DBIAS_ATOL if name == "dbias" else ATOL)


def _reference_two_pass(q, k, v, g, causal, block, bias=None):
    """`_flash_bwd` in interpret mode given the reference forward's out
    and lse, dbias summed over heads (and a broadcast batch) as `_fab_bwd`
    does. Returns ((dq, dk, dv, dbias or None), out, lse lane 0)."""
    b, h = q.shape[:2]
    sc = q.shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    bias3 = None if bias is None else fa._tile_bias(jnp.asarray(bias), b, h)
    out, lse = fa._flash_fwd_lse(jq, jk, jv, sc, causal, block, block, True,
                                 bias3)
    dq, dk, dv, db3 = fa._flash_bwd(jq, jk, jv, out, lse, jg, sc, causal,
                                    block, block, True, bias3)
    db = None
    if bias is not None:
        db = np.asarray(db3).reshape(b, h, 8, -1)[:, :, 0, :].sum(1)
        if bias.shape[0] == 1:
            db = db.sum(0, keepdims=True)
    return (dq, dk, dv, db), out, np.asarray(lse)[..., 0]


# ---- the two-pass backward against the reference's `_flash_bwd` ------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d,block", [(32, 64), (32, 128), (64, 64),
                                     (64, 128)])
def test_two_pass_matches_reference_flash_bwd(d, block, causal):
    """B 2, H 2, S 256: the twin of tests/test_models.py's
    `test_two_kernel_backward_matches_reference`."""
    q, k, v, g = _inputs(d + block, 2, 2, 256, 256, d)
    ref, out, lse = _reference_two_pass(q, k, v, g, causal, block)
    port = pf.flash_bwd_two_pass(_t(q), _t(k), _t(v), _t(out), _t(lse),
                                 _t(g), None, causal)
    _check(port, ref)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("batch", [2, 1], ids=["per-row", "broadcast"])
def test_two_pass_with_bias_matches_reference_flash_bwd(batch, causal):
    """A [B, Sk] padding mask and a random [1, Sk] bias broadcast over the
    batch, against `_flash_bwd(..., _tile_bias(...))` with `_fab_bwd`'s
    sums over heads (and the batch): the twin of
    tests/test_flash_bias.py's `test_two_kernel_backward_with_bias`."""
    q, k, v, g = _inputs(3 + batch, 2, 3, 256, 256, 32)
    bias = (_padding_bias(2, 256) if batch == 2 else
            np.random.RandomState(7).randn(1, 256).astype(np.float32))
    ref, out, lse = _reference_two_pass(q, k, v, g, causal, 128, bias)
    port = pf.flash_bwd_two_pass(_t(q), _t(k), _t(v), _t(out), _t(lse),
                                 _t(g), None, causal, _t(bias))
    assert port[3].shape == bias.shape
    _check(port, ref)


def test_two_pass_takes_the_lse_it_is_given():
    """Ring attention's use: the LSE of attention over [k0; k1] and the
    global output, the backward run against k1 alone. The reference's
    `_flash_bwd` computes p from the LSE it is given, as the port must."""
    b, h, s, d = 2, 2, 128, 32
    q, k, v, g = _inputs(11, b, h, s, 2 * s, d)
    sc = d ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = fa._flash_fwd_lse(jq, jk, jv, sc, False, 64, 64, True)
    k1, v1 = k[:, :, s:], v[:, :, s:]
    ref = fa._flash_bwd(jq, jnp.asarray(k1), jnp.asarray(v1), out, lse, jg,
                        sc, False, 64, 64, True)
    port = pf.flash_bwd_two_pass(_t(q), _t(k1), _t(v1), _t(out),
                                 _t(np.asarray(lse)[..., 0]), _t(g), sc)
    _check(port[:3], ref[:3])


@pytest.mark.parametrize("with_bias", [False, True], ids=["plain", "bias"])
def test_ring_blocks_sum_to_the_full_backward(with_bias):
    """Split the keys in three blocks and run the two-pass backward on
    each with the global LSE and output (as ring attention does on its
    off-diagonal blocks): dq summed over the blocks, and dk, dv and dbias
    concatenated, are the one-block backward's."""
    b, h, sq, sk, d = 2, 2, 96, 192, 32
    q, k, v, g = map(_t, _inputs(12, b, h, sq, sk, d))
    bias = _t(_padding_bias(b, sk)) if with_bias else None
    out, lse = pf.flash_fwd_lse(q, k, v, None, False, bias)
    full = pf.flash_bwd_two_pass(q, k, v, out, lse, g, None, False, bias)
    cuts = ((0, 64), (64, 128), (128, sk))
    parts = [pf.flash_bwd_two_pass(
        q, k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous(), out,
        lse, g, None, False, None if bias is None else bias[:, lo:hi])
        for lo, hi in cuts]
    _close(sum(p[0] for p in parts), full[0].numpy())
    for i in (1, 2):
        _close(torch.cat([p[i] for p in parts], 2), full[i].numpy())
    if with_bias:
        _close(torch.cat([p[3] for p in parts], 1), full[3].numpy(),
               DBIAS_ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fully_masked_row_matches_xla(causal):
    """Batch 0 masks every key: uniform weights and softmax's gradients,
    reaching q, k and the bias, as `_xla_attention` + jax.grad."""
    q, k, v, g = _inputs(5, 2, 2, 128, 128, 32)
    bias = _padding_bias(2, 128)
    bias[0] = -1e30
    _out_r, vjp = jax.vjp(lambda q_, k_, v_, b_: _xla_attention(
        q_, k_, v_, mask=b_[:, None, None, :], causal=causal)[0],
        *map(jnp.asarray, (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tb = map(_t, (q, k, v, bias))
    out, lse = pf.flash_fwd_lse(tq, tk, tv, None, causal, tb)
    assert (lse.reshape(2, 2, -1)[0] <= pf.MASKED_LSE).all()
    port = pf.flash_bwd_two_pass(tq, tk, tv, out, lse, _t(g), None, causal,
                                 tb)
    _check(port, ref)
    assert port[0][0].abs().max() > 0  # dq of the masked row is live


@pytest.mark.parametrize("sq,sk,causal", [
    (64, 192, True),    # more keys than queries: bottom-right offset
    (192, 64, True),    # more queries: rows 0..127 see no key
    (256, 384, False),
    (100, 37, False),
])
def test_sq_ne_sk_matches_reference_attention(sq, sk, causal):
    d = 32
    q, k, v, g = _inputs(6, 2, 2, sq, sk, d)
    _out_r, vjp = jax.vjp(
        lambda q_, k_, v_: fa._reference_attention(q_, k_, v_, d ** -0.5,
                                                   causal),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = map(_t, (q, k, v))
    out, lse = pf.flash_fwd_lse(tq, tk, tv, None, causal)
    port = pf.flash_bwd_two_pass(tq, tk, tv, out, lse, _t(g), None, causal)
    assert port[3] is None
    _check(port[:3], ref)
    if causal and sq > sk:
        assert (port[0][:, :, :sq - sk] == 0).all()


def test_plain_kernels_are_the_fused_backward_split():
    """K7's and K8's plain versions give exactly K9's plain dq and
    dk/dv/dbias: one `_p_ds`, the products divided between them."""
    q, k, v, g = map(_t, _inputs(8, 2, 2, 96, 80, 32))
    bias = _t(_padding_bias(2, 80))
    out, lse = pf.flash_fwd_lse(q, k, v, 0.2, True, bias)
    delta = pf.flash_delta(out, g)
    fused = pf.flash_bwd_plain(q, k, v, g, lse, delta, 0.2, True, bias)
    dq = pf.flash_bwd_dq_plain(q, k, v, g, lse, delta, 0.2, True, bias)
    dkv = pf.flash_bwd_dkv_plain(q, k, v, g, lse, delta, 0.2, True, bias)
    for a, b in zip((dq,) + dkv, fused):
        assert torch.equal(a, b)


# ---- the switch ----------------------------------------------------------------

BOUNDARIES = [(13107, 64, False), (13108, 64, True), (6553, 128, False),
              (6554, 128, True), (26214, 32, False), (26215, 32, True)]


@pytest.mark.parametrize("sq,d,two_pass", BOUNDARIES)
def test_uses_two_pass_is_the_references_expression(sq, d, two_pass):
    assert pf.uses_two_pass(sq, d) is two_pass
    assert pf.uses_two_pass(sq, d) == (not sq * d * 10 <= 8 * 1024 * 1024)


def _reference_choice(monkeypatch, bwd, sq, d):
    """Which backward the reference's custom-vjp `bwd` (`_fa_bwd` or
    `_fab_bwd`) takes for q [1, 1, sq, d]: both kernels are replaced by
    spies, so nothing of size sq is computed."""
    taken = []

    def spy(name):
        def fn(q, k, *a, **kw):
            taken.append(name)
            z = jnp.zeros((1, 8, k.shape[2]), jnp.float32)
            return None, None, None, z
        return fn

    monkeypatch.setattr(fa, "_flash_bwd_fused", spy("fused"))
    monkeypatch.setattr(fa, "_flash_bwd", spy("two_pass"))
    q = types.SimpleNamespace(shape=(1, 1, sq, d))
    k = types.SimpleNamespace(shape=(1, 1, 8, d))
    if bwd is fa._fa_bwd:
        bwd(False, 1.0, 128, 128, True, (q, k, k, q, None), None)
    else:
        bias = jnp.zeros((1, 8), jnp.float32)
        bwd(False, 1.0, 128, 128, True, (q, k, k, bias, None, q, None), None)
    return taken


@pytest.mark.parametrize("which", ["_fa_bwd", "_fab_bwd"])
@pytest.mark.parametrize("sq,d,two_pass", BOUNDARIES)
def test_uses_two_pass_picks_what_the_reference_picks(monkeypatch, sq, d,
                                                      two_pass, which):
    taken = _reference_choice(monkeypatch, getattr(fa, which), sq, d)
    assert taken == ["two_pass" if two_pass else "fused"]
    assert pf.uses_two_pass(sq, d) is two_pass


def _spy(monkeypatch, module, name, calls, fn=None):
    orig = getattr(module, name)

    @functools.wraps(orig)
    def spy(*a, **kw):
        calls.append(name)
        return (fn or orig)(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("two_pass", [False, True], ids=["fused", "two-pass"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["plain", "bias"])
def test_autograd_takes_the_two_pass_backward_exactly_when_it_holds(
        monkeypatch, with_bias, two_pass):
    """`FlashAttention` and `FlashAttentionBias` ask `uses_two_pass` with
    q's length and width and call `flash_bwd_two_pass` when it holds,
    `flash_bwd` otherwise, with the same gradients either way."""
    q, k, v, g = _inputs(9, 2, 2, 64, 64, 32)
    bias = _padding_bias(2, 64)
    asked, calls = [], []

    def predicate(sq, d):
        asked.append((sq, d))
        return two_pass

    monkeypatch.setattr(pf, "uses_two_pass", predicate)
    _spy(monkeypatch, pf, "flash_bwd_two_pass", calls)
    _spy(monkeypatch, pf, "flash_bwd", calls)
    tq, tk, tv, tb = (_t(x).requires_grad_(True) for x in (q, k, v, bias))
    if with_bias:
        out = pf.flash_attention_bias(tq, tk, tv, tb, causal=True)
    else:
        out = pf.flash_attention(tq, tk, tv, causal=True)
    out.backward(_t(g))
    assert asked == [(64, 32)]
    assert calls == ["flash_bwd_two_pass" if two_pass else "flash_bwd"]
    _out_r, vjp = jax.vjp(lambda q_, k_, v_, b_: _xla_attention(
        q_, k_, v_, mask=b_[:, None, None, :] if with_bias else None,
        causal=True)[0], *map(jnp.asarray, (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))
    grads = (tq.grad, tk.grad, tv.grad, tb.grad if with_bias else None)
    _check(grads, ref[:3] + ((ref[3],) if with_bias else (None,)))


def test_short_sequences_keep_the_fused_backward(monkeypatch):
    """Unpatched, GPT-2 and BERT lengths stay below the switch: the fused
    backward runs."""
    calls = []
    _spy(monkeypatch, pf, "flash_bwd_two_pass", calls)
    _spy(monkeypatch, pf, "flash_bwd", calls)
    q, k, v = (_t(x).requires_grad_(True) for x in _inputs(1, 1, 2, 128, 128,
                                                           64, 3))
    pf.flash_attention(q, k, v, causal=True).sum().backward()
    assert calls == ["flash_bwd"]
    for s, d in ((1024, 64), (512, 64), (13107, 64), (6553, 128)):
        assert not pf.uses_two_pass(s, d)


@pytest.mark.parametrize("with_bias", [False, True], ids=["plain", "bias"])
def test_two_pass_on_the_card_launches_k7_and_k8(monkeypatch, with_bias):
    """With `_on_card` forced True and the kernel wrappers replaced by
    spies that compute the plain versions, the two-pass backward launches
    K6, K7 and K8 (their bias variants with a bias) once each and never
    K9."""
    calls = []
    monkeypatch.setattr(pf, "_on_card", lambda *t: True)
    _spy(monkeypatch, kernels, "flash_delta", calls, pf.flash_delta_plain)
    _spy(monkeypatch, kernels, "flash_bwd_dq", calls,
         lambda *a: pf.flash_bwd_dq_plain(*a))
    _spy(monkeypatch, kernels, "flash_bwd_dkv", calls,
         lambda *a: pf.flash_bwd_dkv_plain(*a)[:2])
    _spy(monkeypatch, kernels, "flash_bwd_dq_bias", calls,
         lambda q, k, v, do, lse, dl, b, sc, c: pf.flash_bwd_dq_plain(
             q, k, v, do, lse, dl, sc, c, b))
    _spy(monkeypatch, kernels, "flash_bwd_dkv_bias", calls,
         lambda q, k, v, do, lse, dl, b, sc, c: pf.flash_bwd_dkv_plain(
             q, k, v, do, lse, dl, sc, c, b))
    for name in ("flash_bwd", "flash_bwd_bias"):
        _spy(monkeypatch, kernels, name, calls)
    q, k, v, g = map(_t, _inputs(4, 2, 2, 64, 64, 32))
    bias = _t(_padding_bias(2, 64)) if with_bias else None
    out, lse = pf.flash_fwd_lse_plain(q, k, v, 0.25, True, bias)
    got = pf.flash_bwd_two_pass(q, k, v, out, lse, g, 0.25, True, bias)
    tag = "_bias" if with_bias else ""
    assert calls == ["flash_delta", "flash_bwd_dq" + tag,
                     "flash_bwd_dkv" + tag]
    monkeypatch.undo()
    want = pf.flash_bwd(q, k, v, out, lse, g, 0.25, True, bias)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b.numpy())


def test_two_pass_wrappers_refuse_cpu_tensors():
    """The K7/K8 wrappers launch or raise; the plain versions live in
    ops.flash_attention."""
    q = torch.zeros(1, 2, 16, 32)
    lse = torch.zeros(2, 16)
    bias = torch.zeros(1, 16)
    for call in (lambda: kernels.flash_bwd_dq(q, q, q, q, lse, lse, 1.0,
                                              True),
                 lambda: kernels.flash_bwd_dkv(q, q, q, q, lse, lse, 1.0,
                                               True),
                 lambda: kernels.flash_bwd_dq_bias(q, q, q, q, lse, lse,
                                                   bias, 1.0, False),
                 lambda: kernels.flash_bwd_dkv_bias(q, q, q, q, lse, lse,
                                                    bias, 1.0, False)):
        with pytest.raises(ValueError, match="CUDA kernel"):
            call()
    names = {k.name for k in kernels.KERNELS}
    assert {"flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_bias",
            "flash_bwd_dkv_bias"} <= names
