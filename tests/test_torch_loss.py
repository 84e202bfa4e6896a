"""CPU twins of the port's losses: `ops.loss.cross_entropy` over the
reference's whole signature and `softmax_with_cross_entropy`
(`paddle_tpu/ops/loss.py:16-90`), and the vocab-chunked
`ops.chunked_xent.chunked_softmax_xent` with the GPT-2 loss's
`PADDLE_TPU_CHUNKED_CE` switch (`paddle_tpu/models/gpt2.py:135-150`),
each held to the JAX package's counterpart on the same numpy inputs:
values and the gradients (torch autograd against jax.grad).

Tolerances, float32: losses within 1e-5 of the reference's (relative, or
absolute below 1), gradients within 1e-5 of each one's largest magnitude
(label smoothing is computed as (1 - eps) nll + eps / k (-sum logp), the
reference's smoothed one-hot sum in another order). The chunked loss
keeps the reference test's limits: 1e-5 on the loss, gradients rtol 2e-4
atol 2e-6 against the plain loss, the model switch's 1e-4 and rtol 5e-3,
and build_train_step's 1e-3. The two grad-sweep twins keep the
reference's finite-difference check (EPS 1e-2, rtol 8e-2, atol 8e-3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops import loss as rloss
from paddle_tpu.ops.chunked_xent import chunked_softmax_xent as ref_chunked

from paddle_tpu_torch.ops import chunked_xent, loss as tloss

torch.set_num_threads(1)


def _raw(out):
    return out._value if hasattr(out, "_value") else out


def _rs(seed):
    return np.random.RandomState(seed)


def _close_rel(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, (what, a, b)


def _grad_close(a, b, tol=1e-5, what=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=what)


def _twin(fn_ref, fn_port, x, *args, **kw):
    """The value and d(sum(out * proj))/dx of the reference op (jax.grad)
    and of the port's (autograd) on one float32 input x; extra arrays in
    args go to both as they are (numpy -> jnp / torch)."""
    ra = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args]
    out_r = np.asarray(_raw(fn_ref(jnp.asarray(x), *ra, **kw)))
    proj = np.asarray(_rs(99).rand(*out_r.shape) + 0.5, np.float32)

    def ref_obj(v):
        return jnp.sum(_raw(fn_ref(v, *ra, **kw)) * proj)

    g_r = np.asarray(jax.grad(ref_obj)(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = fn_port(xt, *ta, **kw)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), out_r, xt.grad.numpy(), g_r


def _hard(seed, n=6, c=5, ignore=()):
    rs = _rs(seed)
    x = rs.randn(n, c).astype(np.float32)
    lbl = rs.randint(0, c, n).astype(np.int64)
    lbl[list(ignore)] = -100
    return x, lbl


def _soft(seed, n=6, c=5):
    rs = _rs(seed)
    x = rs.randn(n, c).astype(np.float32)
    p = rs.rand(n, c).astype(np.float32)
    return x, p / p.sum(-1, keepdims=True)


WEIGHT = np.array([0.5, 1.0, 2.0, 0.25, 1.5], np.float32)

# (id, a function making the inputs, keyword arguments)
CE_CASES = [
    ("hard_mean", lambda: _hard(0), {}),
    ("hard_ignore_mean", lambda: _hard(1, ignore=(0, 3)), {}),
    ("hard_all_ignored", lambda: _hard(2, ignore=range(6)), {}),
    ("hard_sum", lambda: _hard(3, ignore=(2,)), {"reduction": "sum"}),
    ("hard_none", lambda: _hard(4, ignore=(1,)), {"reduction": "none"}),
    ("hard_weight_mean", lambda: _hard(5, ignore=(4,)),
     {"weight": WEIGHT}),
    ("hard_weight_sum", lambda: _hard(6), {"weight": WEIGHT,
                                          "reduction": "sum"}),
    ("hard_weight_none", lambda: _hard(7, ignore=(0,)),
     {"weight": WEIGHT, "reduction": "none"}),
    ("hard_smooth_mean", lambda: _hard(8, ignore=(5,)),
     {"label_smoothing": 0.1}),
    ("hard_smooth_weight_sum", lambda: _hard(9, ignore=(1,)),
     {"label_smoothing": 0.2, "weight": WEIGHT, "reduction": "sum"}),
    ("hard_smooth_none", lambda: _hard(10), {"label_smoothing": 0.1,
                                             "reduction": "none"}),
    ("hard_label_n1", lambda: (lambda x, lbl: (x, lbl[:, None]))(
        *_hard(11)), {}),
    ("hard_other_ignore_index", lambda: (lambda x, lbl: (
        x, np.where(lbl == 2, 7, lbl)))(*_hard(12)), {"ignore_index": 7}),
    ("hard_axis1", lambda: (_rs(13).randn(3, 5, 4).astype(np.float32),
                            _rs(14).randint(0, 5, (3, 4)).astype(np.int64)),
     {"axis": 1}),
    ("hard_axis1_smooth", lambda: (_rs(15).randn(3, 5, 4).astype(
        np.float32), _rs(16).randint(0, 5, (3, 4)).astype(np.int64)),
     {"axis": 1, "label_smoothing": 0.1}),
    ("hard_probs_no_softmax", lambda: (
        (lambda p: p / p.sum(-1, keepdims=True))(
            _rs(17).rand(6, 5).astype(np.float32) + 0.1),
        _rs(18).randint(0, 5, 6).astype(np.int64)),
     {"use_softmax": False}),
    ("hard_no_softmax_smooth", lambda: (
        (lambda p: p / p.sum(-1, keepdims=True))(
            _rs(19).rand(6, 5).astype(np.float32) + 0.1),
        _rs(20).randint(0, 5, 6).astype(np.int64)),
     {"use_softmax": False, "label_smoothing": 0.1}),
    ("soft_mean", lambda: _soft(21), {"soft_label": True}),
    ("soft_sum", lambda: _soft(22), {"soft_label": True,
                                     "reduction": "sum"}),
    ("soft_none", lambda: _soft(23), {"soft_label": True,
                                      "reduction": "none"}),
    ("soft_weight_mean", lambda: _soft(24), {"soft_label": True,
                                             "weight": WEIGHT}),
    ("soft_smooth_mean", lambda: _soft(25), {"soft_label": True,
                                             "label_smoothing": 0.1}),
    ("soft_smooth_weight_none", lambda: _soft(26),
     {"soft_label": True, "label_smoothing": 0.1, "weight": WEIGHT,
      "reduction": "none"}),
]


@pytest.mark.parametrize("make,kw", [c[1:] for c in CE_CASES],
                         ids=[c[0] for c in CE_CASES])
def test_cross_entropy_matches_reference(make, kw):
    x, label = make()
    kw = dict(kw)
    w = kw.pop("weight", None)
    ref_kw = dict(kw, weight=None if w is None else jnp.asarray(w))
    port_kw = dict(kw, weight=None if w is None else torch.from_numpy(w))

    def fn_ref(v, lbl):
        return rloss.cross_entropy(v, lbl, **ref_kw)

    def fn_port(v, lbl):
        return tloss.cross_entropy(v, lbl, **port_kw)

    out, out_r, g, g_r = _twin(fn_ref, fn_port, x, label)
    assert out.shape == out_r.shape
    _close_rel(out, out_r, 1e-5, "loss")
    _grad_close(g, g_r, 1e-5, "grad")


def test_cross_entropy_default_path_is_the_hard_label_mean_bit_for_bit():
    """The default call runs the ops the GPT-2 and BERT losses ran before
    the rest of the signature was ported: the same bits, value and
    gradient."""
    def before(input, label, ignore_index=-100):  # noqa: A002
        logp = torch.log_softmax(input, dim=-1)
        lbl = label.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        loss = -logp.gather(-1, safe[..., None]).squeeze(-1)
        loss = torch.where(valid, loss, 0.0)
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)

    rs = _rs(30)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rs.randn(64, 257).astype(np.float32)).to(dtype)
        lbl = torch.from_numpy(rs.randint(0, 257, 64))
        lbl[::5] = -100
        outs = []
        for fn in (before, tloss.cross_entropy):
            xi = x.clone().requires_grad_(True)
            loss = fn(xi, lbl)
            loss.backward()
            outs.append((loss.detach(), xi.grad))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


SWCE_CASES = [
    ("hard_n", lambda: _hard(40), {}),
    ("hard_n1", lambda: (lambda x, lbl: (x, lbl[:, None]))(*_hard(41)), {}),
    ("hard_ignore", lambda: _hard(42, ignore=(1, 4)), {}),
    ("soft", lambda: _soft(43), {"soft_label": True}),
    ("hard_axis0", lambda: (_rs(44).randn(5, 3).astype(np.float32),
                            _rs(45).randint(0, 5, (1, 3)).astype(np.int64)),
     {"axis": 0}),
]


@pytest.mark.parametrize("make,kw", [c[1:] for c in SWCE_CASES],
                         ids=[c[0] for c in SWCE_CASES])
def test_softmax_with_cross_entropy_matches_reference(make, kw):
    x, label = make()

    def fn_ref(v, lbl):
        return rloss.softmax_with_cross_entropy(v, lbl, **kw)

    def fn_port(v, lbl):
        return tloss.softmax_with_cross_entropy(v, lbl, **kw)

    out, out_r, g, g_r = _twin(fn_ref, fn_port, x, label)
    assert out.shape == out_r.shape
    _close_rel(out, out_r, 1e-5, "loss")
    _grad_close(g, g_r, 1e-5, "grad")


def test_softmax_with_cross_entropy_returns_the_softmax():
    x, lbl = _hard(46)
    loss, sm = tloss.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(lbl), return_softmax=True)
    loss_r, sm_r = rloss.softmax_with_cross_entropy(
        jnp.asarray(x), jnp.asarray(lbl), return_softmax=True)
    _close_rel(loss.numpy(), np.asarray(_raw(loss_r)), 1e-5)
    np.testing.assert_allclose(sm.numpy(), np.asarray(_raw(sm_r)), rtol=0,
                               atol=1e-6)


# ---- the grad-sweep twins (test_op_grad_sweep.py) ----------------------------

EPS, RTOL, ATOL = 1e-2, 8e-2, 8e-3


def _check_grad(fn, x):
    """test_op_grad_sweep.py's check_grad on the port: autograd of
    sum(fn(x) * proj) against central differences; returns the autograd
    gradient."""
    rs = _rs(7)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = fn(xt)
    proj = np.asarray(rs.rand(*tuple(out.shape)), np.float64) + 0.5
    (out * torch.from_numpy(np.asarray(proj, np.float32))).sum().backward()
    analytic = xt.grad.numpy().astype(np.float64)

    def value(a):
        with torch.no_grad():
            o = fn(torch.from_numpy(a)).numpy().astype(np.float64)
        return float((o * proj).sum())

    numeric = np.zeros_like(x, np.float64)
    flat, num_flat = x.reshape(-1), numeric.reshape(-1)
    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + EPS
        up = value(x)
        flat[i] = orig - EPS
        dn = value(x)
        flat[i] = orig
        num_flat[i] = (up - dn) / (2 * EPS)
    np.testing.assert_allclose(analytic, numeric, rtol=RTOL, atol=ATOL)
    return analytic


def _sweep_input():
    return _rs(2).uniform(-1.0, 1.0, (2, 4)).astype(np.float32)


def _ref_tape_grad(fn, x):
    t = paddle.to_tensor(x, stop_gradient=False)
    out = fn(t)
    proj = np.asarray(_rs(7).rand(*tuple(out.shape)), np.float64) + 0.5
    (out * paddle.to_tensor(proj.astype(np.float32))).sum().backward()
    return np.asarray(t.grad.numpy(), np.float64)


def test_cross_entropy_grad_sweep():
    labels = np.array([1, 3])
    g = _check_grad(lambda v: tloss.cross_entropy(v, torch.from_numpy(
        labels)), _sweep_input())
    g_r = _ref_tape_grad(lambda v: paddle.nn.functional.cross_entropy(
        v, paddle.to_tensor(labels)), _sweep_input())
    _grad_close(g, g_r, 1e-5)


def test_softmax_with_cross_entropy_grad_sweep():
    labels = np.array([[1], [2]])
    g = _check_grad(lambda v: tloss.softmax_with_cross_entropy(
        v, torch.from_numpy(labels)), _sweep_input())
    g_r = _ref_tape_grad(
        lambda v: paddle.nn.functional.softmax_with_cross_entropy(
            v, paddle.to_tensor(labels)), _sweep_input())
    _grad_close(g, g_r, 1e-5)


# ---- the chunked CE (test_chunked_ce.py) --------------------------------------

def _xw(seed, n, e, v):
    rs = _rs(seed)
    return (rs.randn(n, e).astype(np.float32) * 0.5,
            rs.randn(v, e).astype(np.float32) * 0.2)


def _chunked_port(x, w, labels, nc):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = chunked_xent.chunked_softmax_xent(xt, wt, torch.from_numpy(
        labels), nc)
    loss.backward()
    return loss.item(), xt.grad.numpy(), wt.grad.numpy()


def _plain_port(x, w, labels):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = tloss.cross_entropy(xt @ wt.T, torch.from_numpy(labels))
    loss.backward()
    return loss.item(), xt.grad.numpy(), wt.grad.numpy()


def _chunked_ref(x, w, labels, nc):
    lbl = jnp.asarray(labels)
    loss = float(ref_chunked(jnp.asarray(x), jnp.asarray(w), lbl, nc))
    g = jax.grad(lambda a, b: ref_chunked(a, b, lbl, nc), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    return loss, np.asarray(g[0]), np.asarray(g[1])


@pytest.mark.parametrize("nc", [2, 4, 7])
def test_chunked_loss_and_grads_match_reference(nc):
    """The twin of TestChunkedXent.test_loss_and_grads_match_reference:
    a prime V (the pad and mask path) against the plain loss, and against
    the reference's chunked loss."""
    x, w = _xw(0, 48, 32, 101)
    labels = _rs(0).randint(0, 101, 48)
    lc, gx, gw = _chunked_port(x, w, labels, nc)
    lp, px, pw = _plain_port(x, w, labels)
    assert abs(lc - lp) < 1e-5
    for a, b in ((gx, px), (gw, pw)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    lr, rx, rw = _chunked_ref(x, w, labels, nc)
    assert abs(lc - lr) < 1e-5
    for a, b in ((gx, rx), (gw, rw)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)


def test_chunked_ignore_index_parity():
    """The twin of TestChunkedXent.test_ignore_index_parity: ignored rows
    add no loss and no gradient, the mean is over the valid rows."""
    x, w = _xw(3, 24, 16, 50)
    labels = _rs(3).randint(0, 50, 24)
    labels[::3] = -100
    lc, gx, gw = _chunked_port(x, w, labels, 4)
    lp, px, pw = _plain_port(x, w, labels)
    assert abs(lc - lp) < 1e-5
    for a, b in ((gx, px), (gw, pw)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    assert np.abs(gx[::3]).max() == 0.0
    lr, rx, rw = _chunked_ref(x, w, labels, 4)
    assert abs(lc - lr) < 1e-5
    np.testing.assert_allclose(gx, rx, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(gw, rw, rtol=2e-4, atol=2e-6)


def _gpt2_pair(seed):
    """The reference's GPT-2 tiny (dropout 0) and the port's on its
    weights."""
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models import gpt2 as tg

    paddle.seed(seed)
    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    ref = GPT2(cfg)
    params = {k: np.asarray(v) for k, v in ref.functional_state()[0].items()}
    tcfg = tg.GPT2Config.tiny()
    tcfg.dropout = 0.0
    return ref, tg.from_reference_params(tcfg, params, device="cpu"), tcfg


def test_chunked_model_flag_parity(monkeypatch):
    """The twin of TestChunkedXent.test_model_flag_parity: GPT2.loss
    under PADDLE_TPU_CHUNKED_CE=4 against the plain loss (and the tied
    embedding's gradient), and against the reference's chunked loss."""
    ref, port, cfg = _gpt2_pair(0)
    rs = _rs(1)
    ids = rs.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lab = rs.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    l_plain = port.loss(torch.from_numpy(ids), torch.from_numpy(lab))
    l_plain.backward()
    g_plain = port.wte.weight.grad.clone()
    port.zero_grad()
    monkeypatch.setenv("PADDLE_TPU_CHUNKED_CE", "4")
    l_ck = port.loss(torch.from_numpy(ids), torch.from_numpy(lab))
    assert l_ck.grad_fn.name() == "ChunkedSoftmaxXentBackward"
    l_ck.backward()
    assert abs(l_ck.item() - l_plain.item()) < 1e-4
    np.testing.assert_allclose(port.wte.weight.grad.numpy(),
                               g_plain.numpy(), rtol=5e-3, atol=1e-6)
    l_ref = ref.loss(paddle.to_tensor(ids), paddle.to_tensor(lab))
    l_ref.backward()
    assert abs(l_ck.item() - float(l_ref.numpy())) < 1e-5
    np.testing.assert_allclose(port.wte.weight.grad.numpy(),
                               np.asarray(ref.wte.weight.grad.numpy()),
                               rtol=5e-3, atol=1e-6)


def test_chunked_bench_path(monkeypatch):
    """The twin of TestChunkedXent.test_bench_path_under_jit: the
    functional build_train_step loss follows the switch (the chunked
    backward runs) and stays within 1e-3 of the plain loss, and equals
    the reference's build_train_step under the switch on its weights."""
    from paddle_tpu.models.gpt2 import GPT2Config, build_train_step

    from paddle_tpu_torch.models import gpt2 as tg

    paddle.seed(2)
    rs = _rs(2)
    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    monkeypatch.setenv("PADDLE_TPU_CHUNKED_CE", "4")
    loss_fn_r, init_r, _ = build_train_step(cfg)
    params = {k: np.asarray(v) for k, v in init_r().items()}
    batch = {"input_ids": rs.randint(0, cfg.vocab_size,
                                     (2, 16)).astype(np.int32),
             "labels": rs.randint(0, cfg.vocab_size,
                                  (2, 16)).astype(np.int32)}
    lr = float(jax.jit(loss_fn_r)(params, batch, jax.random.key(0)))
    tcfg = tg.GPT2Config.tiny()
    tcfg.dropout = 0.0
    loss_fn, _init = tg.build_train_step(tcfg, device="cpu")
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in params.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lc = loss_fn(tparams, tbatch)
    assert lc.grad_fn.name() == "ChunkedSoftmaxXentBackward"
    assert abs(lc.item() - lr) < 1e-5, (lc.item(), lr)
    monkeypatch.delenv("PADDLE_TPU_CHUNKED_CE")
    lp = loss_fn(tparams, tbatch).item()
    assert abs(lc.item() - lp) < 1e-3, (lc.item(), lp)


def test_chunked_switch_needs_tied_embeddings_and_more_than_one_chunk(
        monkeypatch):
    """As the reference: n <= 1 or untied embeddings keep the plain
    loss."""
    from paddle_tpu_torch.models import gpt2 as tg

    rs = _rs(4)
    ids = torch.from_numpy(rs.randint(0, 1024, (2, 8)))
    for tie, n, chunked in ((True, "1", False), (False, "4", False),
                            (True, "2", True)):
        cfg = tg.GPT2Config.tiny()
        cfg.dropout, cfg.tie_embeddings = 0.0, tie
        model = tg.GPT2(cfg, device="cpu")
        monkeypatch.setenv("PADDLE_TPU_CHUNKED_CE", n)
        name = model.loss(ids, ids).grad_fn.name()
        assert (name == "ChunkedSoftmaxXentBackward") == chunked, (tie, n)
