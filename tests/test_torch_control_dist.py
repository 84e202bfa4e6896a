"""CPU twins of the port's control flow (`paddle_tpu_torch.ops.control`)
and distributions (`paddle_tpu_torch.distribution`) against the
reference's: the control-flow and distribution cases of
`test_amp_control_dist.py`, each result equal to the reference's on the
same values; every density, entropy, divergence and probability within
1e-5 of the reference's; draws — torch's bits, not JAX's — held by
their repeatability under one seed, their bounds and their moments
(20000 draws: means within 0.05, deviations within 5%, frequencies
within 0.02).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as rd
import paddle_tpu.ops as rops

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distribution as pd
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.ops import control as pc

torch.set_num_threads(1)
TOL = 1e-5
N = 20000


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x.numpy())


def both(v):
    return paddle.to_tensor(np.asarray(v, np.float32)), \
        torch.tensor(np.asarray(v, np.float32))


# ---- control flow --------------------------------------------------------

@pytest.mark.parametrize("thresh", [1.0, 5.0])
def test_cond(thresh):
    r, p = both([2.0])
    want = rops.cond(r.sum() > thresh, lambda: r * 10, lambda: r * -1)
    got = ptt.cond(p.sum() > thresh, lambda: p * 10, lambda: p * -1)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_cond_runs_only_the_branch_taken():
    calls = []
    pc.cond(torch.tensor(True), lambda: calls.append("t"),
            lambda: calls.append("f"))
    assert calls == ["t"]


def test_while_loop():
    ri, pi = both([0.0])
    rs_, ps = both([0.0])
    want = rops.while_loop(lambda i, s: i.sum() < 5,
                           lambda i, s: [i + 1, s + i], [ri, rs_])
    got = ptt.while_loop(lambda i, s: i.sum() < 5,
                         lambda i, s: [i + 1, s + i], [pi, ps])
    assert isinstance(got, list) and len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert float(got[1]) == 10.0


@pytest.mark.parametrize("index", [-3, 0, 1, 2, 7])
def test_switch_case(index):
    r, p = both([1.0])
    want = rops.switch_case(paddle.to_tensor(np.array(index)), [
        lambda: r * 1, lambda: r * 2, lambda: r * 3])
    got = ptt.switch_case(torch.tensor(index), [
        lambda: p * 1, lambda: p * 2, lambda: p * 3])
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("index", [0, 1, 2, 5])
def test_switch_case_dict_and_default(index):
    r, p = both([1.0])
    want = rops.switch_case(paddle.to_tensor(np.array(index)),
                            {0: lambda: r * 5, 2: lambda: r * 7},
                            default=lambda: r * 9)
    got = ptt.switch_case(index, {0: lambda: p * 5, 2: lambda: p * 7},
                          default=lambda: p * 9)
    np.testing.assert_array_equal(_np(got), _np(want))
    got = ptt.switch_case(index, [(0, lambda: p * 5), (2, lambda: p * 7)],
                          default=lambda: p * 9)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("value", [0.5, 3.0, 9.0])
def test_case(value):
    r, p = both([value])
    want = rops.case([(r.sum() > 5, lambda: r * 0),
                      (r.sum() > 1, lambda: r * 7)], default=lambda: r)
    got = ptt.case([(p.sum() > 5, lambda: p * 0),
                    (p.sum() > 1, lambda: p * 7)], default=lambda: p)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_case_without_default_raises_as_the_reference():
    r, p = both([3.0])
    with pytest.raises(ValueError, match="no default"):
        rops.case([(r.sum() > 1, lambda: r)])
    with pytest.raises(ValueError, match="no default"):
        ptt.case([(p.sum() > 1, lambda: p)])


def test_fori_loop_scan_increment():
    r, p = both([1.0, 2.0])
    want = rops.fori_loop(0, 4, lambda i, s: s * 2 + i, r)
    got = ptt.fori_loop(0, 4, lambda i, s: s * 2 + i, p)
    np.testing.assert_array_equal(_np(got), _np(want))
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    rc, rys = rops.scan(lambda c, x: (c + x, (c * x, x.sum())),
                        paddle.to_tensor(np.zeros(3, np.float32)),
                        paddle.to_tensor(xs))
    pc_, pys = ptt.scan(lambda c, x: (c + x, (c * x, x.sum())),
                        torch.zeros(3), torch.from_numpy(xs))
    np.testing.assert_array_equal(_np(pc_), _np(rc))
    for a, b in zip(pys, rys):
        np.testing.assert_array_equal(_np(a), _np(b))
    from paddle_tpu.ops.control import increment_inplace
    np.testing.assert_array_equal(_np(pc.increment_inplace(p, 2.0)),
                                  _np(increment_inplace(r, 2.0)))


# ---- distributions: densities against the reference ----------------------

def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_normal_and_uniform_densities():
    loc, scale = [0.0, 1.5, -2.0], [1.0, 0.5, 2.0]
    v = [0.3, 1.0, -4.0]
    r, p = rd.Normal(loc, scale), pd.Normal(loc, scale)
    rq, pq = rd.Normal(1.0, 2.0), pd.Normal(1.0, 2.0)
    for name in ("log_prob", "probs"):
        _close(getattr(p, name)(torch.tensor(v)),
               getattr(r, name)(paddle.to_tensor(np.float32(v))))
    _close(p.entropy(), r.entropy())
    _close(p.kl_divergence(pq), r.kl_divergence(rq))
    _close(pd.kl_divergence(p, pq), rd.kl_divergence(r, rq))
    r, p = rd.Uniform([0.0, -1.0], [2.0, 3.0]), pd.Uniform([0.0, -1.0],
                                                           [2.0, 3.0])
    for val in ([1.0, 2.5], [-0.5, 3.0]):  # inside, then outside
        _close(p.log_prob(torch.tensor(val)),
               r.log_prob(paddle.to_tensor(np.float32(val))))
        _close(p.probs(torch.tensor(val)),
               r.probs(paddle.to_tensor(np.float32(val))))
    _close(p.entropy(), r.entropy())


def test_categorical():
    w = np.array([[0.25, 0.25, 0.5], [0.1, 0.6, 0.3]], np.float32)
    o = np.array([[0.3, 0.3, 0.4], [0.2, 0.2, 0.6]], np.float32)
    r, p = rd.Categorical(paddle.to_tensor(w)), pd.Categorical(
        torch.from_numpy(w))
    ro, po = rd.Categorical(paddle.to_tensor(o)), pd.Categorical(
        torch.from_numpy(o))
    _close(p.probs(), r.probs())
    idx = np.array([2, 0])
    _close(p.probs(torch.from_numpy(idx)), r.probs(paddle.to_tensor(idx)))
    _close(p.log_prob(torch.from_numpy(idx)),
           r.log_prob(paddle.to_tensor(idx)))
    _close(p.entropy(), r.entropy())
    _close(p.kl_divergence(po), r.kl_divergence(ro))
    one = pd.Categorical(torch.tensor([1.0, 1.0]))
    _close(one.probs(), rd.Categorical(paddle.to_tensor([1.0, 1.0]))
           .probs())
    assert float(one.entropy()) == pytest.approx(np.log(2), abs=TOL)
    with pytest.raises(ValueError, match="non-negative"):
        pd.Categorical(torch.tensor([1.0, -1.0])).probs()


def test_bernoulli_and_mvn_diag():
    for kw in ({"probs": [0.2, 0.7]}, {"logits": [-1.0, 0.5]}):
        r, p = rd.Bernoulli(**kw), pd.Bernoulli(**kw)
        _close(p.log_prob(torch.tensor([1.0, 0.0])),
               r.log_prob(paddle.to_tensor(np.float32([1.0, 0.0]))))
        _close(p.entropy(), r.entropy())
    loc = np.array([[0.0, 1.0, -1.0]], np.float32)
    diag = np.array([[1.0, 0.5, 2.0]], np.float32)
    full = np.stack([np.diag(d) for d in diag]).astype(np.float32)
    v = np.array([[0.5, 0.5, 0.5]], np.float32)
    for scale in (diag, full):
        r = rd.MultivariateNormalDiag(paddle.to_tensor(loc),
                                      paddle.to_tensor(scale))
        p = pd.MultivariateNormalDiag(torch.from_numpy(loc),
                                      torch.from_numpy(scale))
        _close(p.log_prob(torch.from_numpy(v)),
               r.log_prob(paddle.to_tensor(v)))
        _close(p.entropy(), r.entropy())
        r2 = rd.MultivariateNormalDiag(paddle.to_tensor(loc * 0),
                                       paddle.to_tensor(diag * 2))
        p2 = pd.MultivariateNormalDiag(torch.from_numpy(loc * 0),
                                       torch.from_numpy(diag * 2))
        _close(p.kl_divergence(p2), r.kl_divergence(r2))


# ---- draws: repeatability, bounds, moments -------------------------------

def _twice(fn):
    ptt.seed(17)
    a = _np(fn())
    ptt.seed(17)
    b = _np(fn())
    np.testing.assert_array_equal(a, b)
    return a


def test_normal_and_uniform_draws():
    s = _twice(lambda: pd.Normal([0.0, 3.0], [1.0, 0.5]).sample([N]))
    assert s.shape == (N, 2) and s.dtype == np.float32
    np.testing.assert_allclose(s.mean(0), [0.0, 3.0], atol=0.05)
    np.testing.assert_allclose(s.std(0), [1.0, 0.5], rtol=0.05)
    s = _twice(lambda: pd.Uniform(0.0, 2.0).sample([N]))
    assert 0.0 <= s.min() and s.max() < 2.0
    assert abs(s.mean() - 1.0) < 0.05
    a = _np(pd.Normal(0.0, 1.0).sample([4], seed=5))
    np.testing.assert_array_equal(a, _np(pd.Normal(0.0, 1.0).sample(
        [4], seed=5)))


def test_categorical_bernoulli_sampling_id_draws():
    w = torch.tensor([[0.25, 0.25, 0.5], [0.7, 0.1, 0.2]])
    s = _twice(lambda: pd.Categorical(w).sample([N]))
    assert s.shape == (N, 2) and s.dtype == np.int64
    for row in range(2):
        freq = np.bincount(s[:, row], minlength=3) / N
        np.testing.assert_allclose(freq, _np(w[row]), atol=0.02)
    s = _twice(lambda: pd.Bernoulli(probs=[0.2, 0.7]).sample([N]))
    np.testing.assert_allclose(s.mean(0), [0.2, 0.7], atol=0.02)
    x = torch.tensor([[0.1, 0.9, 0.0]]).repeat(N, 1)
    ids = _twice(lambda: pd.sampling_id(x))
    assert ids.dtype == np.int64
    np.testing.assert_allclose(np.bincount(ids, minlength=3) / N,
                               [0.1, 0.9, 0.0], atol=0.02)
    m = _twice(lambda: pd.MultivariateNormalDiag(
        torch.tensor([1.0, -1.0]), torch.tensor([0.5, 2.0])).sample([N]))
    np.testing.assert_allclose(m.mean(0), [1.0, -1.0], atol=0.05)
    np.testing.assert_allclose(m.std(0), [0.5, 2.0], rtol=0.05)
