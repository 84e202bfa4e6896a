"""CPU twins of the port's `jit.to_static` against the reference's: the
two cases of test_to_static_free_function_state.py and the to_static
part of test_layers.py::TestWeightNorm::test_reparam_train_fold, plus the
state rules `jit`'s module docstring states (dropout draws afresh at
each call, hooks run, `ProgramTranslator.enable(False)`, `TracedLayer`).

Tolerances: float32 outputs 1e-5 against the reference (its own); the
port's to_static against its eager forward, bit for bit (the same
eager code runs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as RT

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def carry(ref, port):
    assert load_reference_state(port, {
        k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}) == []


@pytest.mark.parametrize("cls", ["BatchNorm1D", "SyncBatchNorm"])
def test_free_function_no_tracer_leak(cls):
    """A to_static free function over a training BatchNorm gives the
    reference's value and leaks no state: the running statistics are
    unchanged after it, as after the reference's pure jit, and an eager
    call then gives the same value."""
    paddle.seed(0)
    rbn = getattr(paddle.nn, cls)(4)
    bn = getattr(ptt.nn, cls)(4)
    carry(rbn, bn)
    rbn.train()
    bn.train()

    @paddle.jit.to_static
    def rstep(x):
        return (rbn(x) ** 2).sum()

    @ptt.jit.to_static
    def step(x):
        return (bn(x) ** 2).sum()

    xv = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    mean0 = bn._mean.detach().clone()
    s = float(step(torch.from_numpy(xv)))
    assert torch.equal(bn._mean, mean0)
    rs = float(np.asarray(rstep(RT(jnp.asarray(xv))).numpy()))
    np.testing.assert_allclose(s, rs, rtol=1e-5)
    e = float((bn(torch.from_numpy(xv)) ** 2).sum())
    np.testing.assert_allclose(s, e, rtol=1e-5)
    assert isinstance(bn._mean.detach().numpy(), np.ndarray)


def test_layer_path_still_persists_buffers():
    """A to_static layer's running statistics advance, as the reference's
    (it threads its buffers through jit): the reference's new values."""
    paddle.seed(1)

    class RNet(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = paddle.nn.BatchNorm1D(3)

        def forward(self, x):
            return self.bn(x).sum()

    class PNet(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = ptt.nn.BatchNorm1D(3)

        def forward(self, x):
            return self.bn(x).sum()

    ref, port = RNet(), PNet()
    carry(ref, port)
    ref = paddle.jit.to_static(ref)
    net = ptt.jit.to_static(port)
    ref.train()
    net.train()
    before = net.bn._mean.detach().clone()
    xv = np.random.RandomState(2).randn(6, 3).astype(np.float32) + 5
    net(torch.from_numpy(xv))
    ref(RT(jnp.asarray(xv)))
    after = net.bn._mean.detach()
    assert not torch.allclose(before, after)
    np.testing.assert_allclose(after.numpy(),
                               np.asarray(ref.bn._mean.numpy()), rtol=1e-5)


def test_reparam_train_fold_to_static():
    """The to_static part of test_layers.py::test_reparam_train_fold: a
    weight-normed Linear trained 5 SGD steps through g and v, then
    to_static: its output is the eager one, and it reads the LIVE g (the
    hook runs at every call), as the reference's traced hook does."""
    from paddle_tpu.nn.utils import weight_norm as r_weight_norm
    from paddle_tpu_torch.nn.utils import weight_norm
    paddle.seed(0)
    rlin, lin = paddle.nn.Linear(4, 3), ptt.nn.Linear(4, 3)
    carry(rlin, lin)
    r_weight_norm(rlin, "weight", dim=0)
    weight_norm(lin, "weight", dim=0)
    xv = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    x, rx = torch.from_numpy(xv), paddle.to_tensor(xv)
    opt = ptt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    ropt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=rlin.parameters())
    for _ in range(5):
        loss = (lin(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        rloss = (rlin(rx) ** 2).mean()
        rloss.backward()
        ropt.step()
        ropt.clear_grad()
    out_trained = lin(x).detach()
    jitted = ptt.jit.to_static(lin)
    rjitted = paddle.jit.to_static(rlin)
    got = jitted(x).detach()
    assert torch.equal(got, out_trained)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(rjitted(rx).numpy()), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        lin.weight_g.mul_(2.0)
    assert not torch.allclose(jitted(x), out_trained)
    with torch.no_grad():
        lin.weight_g.div_(2.0)
    assert torch.equal(jitted(x).detach(), out_trained)


def test_dropout_varies_per_call_and_hooks_run():
    """A to_static layer in training draws a fresh dropout mask at each
    call (the reference feeds a new key a call), and its forward pre- and
    post-hooks run around it."""
    net = ptt.nn.Sequential(ptt.nn.Linear(8, 8), ptt.nn.Dropout(0.5))
    seen = []
    net.register_forward_pre_hook(lambda layer, inp: seen.append("pre"))
    net.register_forward_post_hook(lambda layer, inp, out:
                                   seen.append("post"))
    net = ptt.jit.to_static(net)
    net.train()
    x = torch.ones(4, 8)
    a, b = net(x), net(x)
    assert not torch.equal(a, b)
    assert seen == ["pre", "post", "pre", "post"]


def test_program_translator_and_traced_layer(tmp_path):
    """enable_to_static(False) makes a to_static function the plain one
    (buffers of a free function then persist); TracedLayer.trace runs
    the layer and saves it with the example inputs."""
    bn = ptt.nn.BatchNorm1D(2)
    bn.train()

    @ptt.jit.to_static
    def f(x):
        return bn(x)

    x = torch.randn(4, 2) + 3
    ptt.jit.enable_to_static(False)
    try:
        before = bn._mean.detach().clone()
        f(x)
        assert not torch.equal(bn._mean, before)
    finally:
        ptt.jit.enable_to_static(True)
    lin = ptt.nn.Linear(3, 2)
    xin = torch.randn(5, 3)
    out, traced = ptt.jit.TracedLayer.trace(lin, [xin])
    assert torch.equal(out, lin(xin)) and torch.equal(traced(xin), out)
    traced.save_inference_model(str(tmp_path / "traced"))
    loaded = ptt.jit.load(str(tmp_path / "traced"), device="cpu")
    assert torch.equal(loaded(xin), lin(xin).detach())
