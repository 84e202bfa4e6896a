"""CPU twin of `test_optimizer_resume.py` on the port's optimizers:
`set_state_dict` restores Adam's moments when the fresh model's
parameter names differ from the saved ones (the same architecture,
matched by order and shape, with a warning), skips a frozen parameter by
shape, refuses another architecture without touching the optimizer, and
AdamW's `apply_decay_param_fun` decays only the leaves it selects.

Each run starts from the reference's weights (carried by
`load_reference_state`) and is also held to the reference's run of the
same steps: weights within rtol 1e-5, atol 1e-6 (float32); the resumed
step equals the uninterrupted one bit for bit, as the reference asserts.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def _carry(ref, port):
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return port


def _build(width=4, ref=None):
    if ref is None:
        net = ptt.nn.Linear(width, 1)
    else:
        net = _carry(ref, ptt.nn.Linear(width, 1))
    return net, ptt.optimizer.Adam(learning_rate=0.05,
                                   parameters=net.parameters())


def _step(net, opt, x):
    loss = (net(x) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _ref_run(seed, steps, x):
    paddle.seed(seed)
    net = paddle.nn.Linear(4, 1)
    opt = paddle.optimizer.Adam(learning_rate=0.05,
                                parameters=net.parameters())
    xr = paddle.to_tensor(x)
    for _ in range(steps):
        loss = (net(xr) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return net


def test_positional_resume_is_exact():
    xa = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    paddle.seed(0)
    ref0 = paddle.nn.Linear(4, 1)
    net, opt = _build(ref=ref0)
    x = torch.from_numpy(xa)
    for _ in range(5):
        _step(net, opt, x)
    saved = {"net": net.state_dict(), "opt": opt.state_dict()}
    net2, opt2 = _build()  # fresh parameter names
    net2.set_state_dict(saved["net"])
    with pytest.warns(UserWarning, match="order and shape"):
        opt2.set_state_dict(saved["opt"])
    for n_, o_ in ((net, opt), (net2, opt2)):
        _step(n_, o_, x)
    assert torch.equal(net.weight, net2.weight)
    ref = _ref_run(0, 6, xa)
    np.testing.assert_allclose(net2.weight.detach().numpy(),
                               ref.weight.numpy(), rtol=1e-5, atol=1e-6)


def test_adamw_apply_decay_param_fun():
    """lr 0 isolates the decoupled decay: the bias (deselected) stays;
    the weight equals the reference's under the same rule."""
    paddle.seed(3)
    ref = paddle.nn.Linear(4, 4)
    lin = _carry(ref, ptt.nn.Linear(4, 4))
    kw = dict(learning_rate=0.0, weight_decay=0.1,
              apply_decay_param_fun=lambda n: "bias" not in n)
    ropt = paddle.optimizer.AdamW(parameters=ref.parameters(), **kw)
    opt = ptt.optimizer.AdamW(parameters=lin.parameters(), **kw)
    b0 = lin.bias.detach().clone()
    x = np.ones((2, 4), np.float32)
    lin(torch.from_numpy(x)).sum().backward()
    opt.step()
    ref(paddle.to_tensor(x)).sum().backward()
    ropt.step()
    assert (lin.bias.detach() - b0).abs().max() < 1e-8
    assert torch.isfinite(lin.weight).all()
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               ref.weight.numpy(), rtol=1e-6, atol=1e-7)


def test_wrong_architecture_rejected_without_mutation():
    net, opt = _build(4)
    x = torch.ones(8, 4)
    _step(net, opt, x)
    saved = opt.state_dict()
    net3, opt3 = _build(6)  # different shape, same parameter count
    step_before = opt3._step_count
    with pytest.raises(ValueError):
        opt3.set_state_dict(saved)
    assert opt3._step_count == step_before
    assert not opt3._slots
    paddle.seed(1)  # the reference refuses the same checkpoint
    r4 = paddle.nn.Linear(4, 1)
    ropt4 = paddle.optimizer.Adam(learning_rate=0.05,
                                  parameters=r4.parameters())
    (r4(paddle.to_tensor(np.ones((8, 4), np.float32))) ** 2).mean() \
        .backward()
    ropt4.step()
    ropt6 = paddle.optimizer.Adam(
        learning_rate=0.05, parameters=paddle.nn.Linear(6, 1).parameters())
    with pytest.raises(ValueError):
        ropt6.set_state_dict(ropt4.state_dict())


def test_frozen_param_resume_skipped_by_shape():
    class Net(ptt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = ptt.nn.Linear(4, 3)
            self.frozen = ptt.nn.Linear(7, 7)
            for p in self.frozen.parameters():
                p.requires_grad_(False)
            self.b = ptt.nn.Linear(3, 1)

        def forward(self, x):
            return self.b(torch.relu(self.a(x)))

    def build():
        net = Net()
        return net, ptt.optimizer.Adam(learning_rate=0.05,
                                       parameters=net.parameters())

    net, opt = build()
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 4)
                         .astype(np.float32))
    for _ in range(3):
        _step(net, opt, x)
    saved = {"net": net.state_dict(), "opt": opt.state_dict()}
    net2, opt2 = build()
    net2.set_state_dict(saved["net"])
    with pytest.warns(UserWarning, match="order and shape"):
        opt2.set_state_dict(saved["opt"])
    for n_, o_ in ((net, opt), (net2, opt2)):
        _step(n_, o_, x)
    assert torch.equal(net.b.weight, net2.b.weight)
    assert torch.equal(net.frozen.weight, net2.frozen.weight)
