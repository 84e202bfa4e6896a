"""CPU twins of the port's initializers (`paddle_tpu_torch.nn.initializer`)
against the JAX package's. The port draws from torch's generators, so it
cannot reproduce JAX's bits; each initializer is held to the reference
by its arithmetic instead:

  * the fans of every weight layout (Linear's [in, out], conv's [out, in,
    *k]) equal the reference's `_fans`;
  * the bound or deviation each one computes equals the reference's
    formula on those fans (checked against the reference's own draws:
    its samples lie within the port's bound, and their moments agree);
  * moments: the sample standard deviation within 3% of the formula's
    (n = 40000), the mean within 3% of the deviation; bounds exact;
  * the deterministic ones (Constant, Assign, Dirac, Bilinear) equal the
    reference's values exactly;
  * the same seed replays the same stream; the layers' default inits
    (Linear, Conv, Embedding, RNN, norms) follow the same rules.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.initializer as RI

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.initializer as PI
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)

N = 40000


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


@pytest.mark.parametrize("shape", [(7,), (30, 50), (16, 8, 3, 3),
                                   (4, 6, 5), (8, 2, 3, 3, 3), ()])
def test_fans_equal_the_reference(shape):
    assert PI._fans(shape) == RI._fans(shape)


def _moments_match(port, ref, std, lo=None, hi=None):
    p = port.double().numpy().ravel()
    r = np.asarray(ref, np.float64).ravel()
    for a in (p, r):
        assert abs(a.std() - std) <= 0.03 * std, (a.std(), std)
        assert abs(a.mean()) <= 0.03 * std
        if lo is not None:
            assert a.min() >= lo - 1e-6 and a.max() <= hi + 1e-6


@pytest.mark.parametrize("cls,kw,shape,expect", [
    ("XavierUniform", {}, (200, 200), ("u", math.sqrt(6 / 400))),
    ("XavierUniform", {"gain": 2.0}, (400, 25, 2, 2),
     ("u", 2 * math.sqrt(6 / (25 * 4 + 400 * 4)))),
    ("XavierNormal", {}, (100, 400), ("n", math.sqrt(2 / 500))),
    ("XavierNormal", {"fan_in": 10, "fan_out": 30}, (200, 200),
     ("n", math.sqrt(2 / 40))),
    ("KaimingUniform", {}, (128, 16, 5, 5), ("u", math.sqrt(2.0) *
                                            math.sqrt(3 / 400))),
    ("KaimingUniform", {"negative_slope": 0.2}, (400, 100),
     ("u", math.sqrt(2 / 1.04) * math.sqrt(3 / 400))),
    ("KaimingNormal", {}, (512, 8, 3, 3),
     ("n", math.sqrt(2.0) / math.sqrt(72))),
    ("Uniform", {"low": -0.3, "high": 0.7}, (200, 200), ("r", -0.3, 0.7)),
    ("Normal", {"mean": 0.0, "std": 0.02}, (200, 200), ("n", 0.02)),
])
def test_random_initializers_follow_the_reference_formula(cls, kw, shape,
                                                          expect):
    ptt.seed(11)
    paddle.seed(11)
    port = getattr(PI, cls)(**kw)(shape)
    ref = getattr(RI, cls)(**kw)(shape, "float32")
    assert list(port.shape) == list(shape) and port.dtype == torch.float32
    assert port.device.type == "cpu"
    kind = expect[0]
    if kind == "u":
        lim = expect[1]
        _moments_match(port, ref, lim / math.sqrt(3), -lim, lim)
        assert getattr(PI, cls)(**kw).limit(shape) == pytest.approx(lim)
    elif kind == "n":
        _moments_match(port, ref, expect[1])
    else:
        lo, hi = expect[1], expect[2]
        p = port.numpy()
        assert p.min() >= lo and p.max() < hi
        assert abs(p.mean() - (lo + hi) / 2) < 0.01
        assert abs(np.asarray(ref).mean() - p.mean()) < 0.01


def test_truncated_normal_cut_at_two_std():
    ptt.seed(1)
    paddle.seed(1)
    port = PI.TruncatedNormal(1.0, 0.5)([N]).numpy()
    ref = np.asarray(RI.TruncatedNormal(1.0, 0.5)([N], "float32"))
    for a in (port, ref):
        assert a.min() >= 0.0 - 1e-6 and a.max() <= 2.0 + 1e-6
        # the std of N(0, 1) cut at ±2 is 0.8796
        assert abs(a.std() - 0.5 * 0.8796) < 0.03 * 0.5
        assert abs(a.mean() - 1.0) < 0.02


def test_deterministic_initializers_equal_the_reference():
    for port, ref, shape in (
            (PI.Constant(0.25), RI.Constant(0.25), (3, 4)),
            (PI.Assign(np.arange(6, dtype=np.float32)),
             RI.Assign(np.arange(6, dtype=np.float32)), (2, 3)),
            (PI.Dirac(2), RI.Dirac(2), (4, 3, 3, 3)),
            (PI.Bilinear(), RI.Bilinear(), (2, 2, 4, 4))):
        np.testing.assert_array_equal(port(shape).numpy(),
                                      np.asarray(ref(shape, "float32")))


def test_orthogonal():
    for shape in ((6, 4), (4, 6), (3, 2, 2)):
        w = PI.Orthogonal(gain=2.0)(shape).reshape(shape[0], -1)
        rows, cols = w.shape
        m = w @ w.T if rows <= cols else w.T @ w
        np.testing.assert_allclose(m.numpy(), 4 * np.eye(min(rows, cols)),
                                   atol=1e-5)


def test_same_seed_same_stream():
    ptt.seed(5)
    a = PI.XavierUniform()((8, 8)).numpy()
    b = PI.Normal()((8,)).numpy()
    ptt.seed(5)
    np.testing.assert_array_equal(PI.XavierUniform()((8, 8)).numpy(), a)
    np.testing.assert_array_equal(PI.Normal()((8,)).numpy(), b)
    g = torch.Generator().manual_seed(3)
    c = PI.KaimingNormal()((4, 4), generator=g).numpy()
    g = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(
        PI.KaimingNormal()((4, 4), generator=g).numpy(), c)


def test_layer_default_inits():
    """The layers' defaults: Linear Xavier-uniform on [in, out], Conv
    normal(0, √(2 / fan_in)), Embedding normal(0, 1), RNNs uniform
    (±1/√hidden), norms one / zero, biases zero."""
    nn = ptt.nn
    ptt.seed(0)
    lin = nn.Linear(300, 100)
    lim = math.sqrt(6 / 400)
    w = lin.weight.detach().numpy()
    assert np.abs(w).max() <= lim and abs(w.std() - lim / math.sqrt(3)) \
        < 0.03 * lim
    assert float(lin.bias.abs().sum()) == 0.0
    conv = nn.Conv2D(16, 64, 3)
    std = math.sqrt(2 / (16 * 9))
    assert abs(conv.weight.detach().std().item() - std) < 0.03 * std
    emb = nn.Embedding(400, 100)
    assert abs(emb.weight.detach().std().item() - 1.0) < 0.03
    gru = nn.GRU(8, 50)
    assert gru.weight_hh_l0.abs().max().item() <= 1 / math.sqrt(50)
    bn = nn.BatchNorm2D(4)
    assert float(bn.weight.sum()) == 4.0 and float(bn.bias.sum()) == 0.0
    ptt.seed(0)
    np.testing.assert_array_equal(nn.Linear(300, 100).weight.detach()
                                  .numpy(), w)


def test_global_initializer_and_gain():
    PI.set_global_initializer(PI.Constant(0.5), PI.Constant(-1.0))
    try:
        lin = ptt.nn.Linear(3, 2)
        assert float(lin.weight.sum()) == 3.0
        assert float(lin.bias.sum()) == -2.0
    finally:
        PI.set_global_initializer(None, None)
    for nl in ("sigmoid", "tanh", "relu", "leaky_relu", "selu"):
        assert PI.calculate_gain(nl) == RI.calculate_gain(nl)
