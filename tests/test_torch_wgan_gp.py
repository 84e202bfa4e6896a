"""Twin of tests/test_wgan_gp.py: a WGAN-GP critic trained through the
port's `paddle.grad(create_graph=True)` gradient penalty — 12 Adam steps
whose `loss.backward()` runs through the penalty's double grad — held
to the reference test's claim (the critic separates real from fake by
+0.3) and to the reference's run on the same weights and draws: losses
step by step and the final weights within rtol 1e-4 (float32, another
order of summation compounded over 12 steps).

The reference's `paddle.grad` runs a whole backward and leaves the
first-order gradient of its outputs in every parameter's `.grad`
(`paddle_tpu/core/autograd.py:293-323`); the port's writes no `.grad`,
as Paddle's `paddle.grad` documents (ROADMAP §C 48). The reference's
run therefore clears its parameters' gradients after the penalty's
`grad`, so that both runs step on the loss's own gradient."""
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


def _value(t):
    return float(t.detach().numpy() if torch.is_tensor(t)
                 else np.asarray(t.numpy()))


def _train(pkg, critic, steps=12, clear_after_grad=False):
    """The reference test's loop on `pkg` (either package): returns
    (separation before, separation after, losses)."""
    rs = np.random.RandomState(3)
    opt = pkg.optimizer.Adam(learning_rate=5e-3,
                             parameters=critic.parameters())
    real = rs.randn(16, 8).astype(np.float32) + 1.5
    fake = rs.randn(16, 8).astype(np.float32) - 1.5

    def critic_loss():
        eps = rs.rand(16, 1).astype(np.float32)
        xi = pkg.to_tensor(eps * real + (1 - eps) * fake,
                           stop_gradient=False)
        d_real = critic(pkg.to_tensor(real)).mean()
        d_fake = critic(pkg.to_tensor(fake)).mean()
        (gx,) = pkg.grad(critic(xi).sum(), [xi], create_graph=True)
        if clear_after_grad:
            opt.clear_grad()
        gnorm = ((gx * gx).sum(axis=1) + 1e-12).sqrt()
        return d_fake - d_real + 10.0 * ((gnorm - 1.0) ** 2).mean()

    def separation():
        d = critic(pkg.to_tensor(real)).mean() - \
            critic(pkg.to_tensor(fake)).mean()
        return _value(d)

    sep0, losses = separation(), []
    for _ in range(steps):
        loss = critic_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(_value(loss))
    return sep0, separation(), losses


def test_wgan_gp_step_decreases_critic_loss():
    paddle.seed(11)
    rnn = paddle.nn
    ref = rnn.Sequential(rnn.Linear(8, 16), rnn.Tanh(), rnn.Linear(16, 1))
    pnn = ptt.nn
    port = pnn.Sequential(pnn.Linear(8, 16), pnn.Tanh(), pnn.Linear(16, 1))
    assert load_reference_state(port, {
        k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}) == []

    r0, r1, rlosses = _train(paddle, ref, clear_after_grad=True)
    p0, p1, plosses = _train(ptt, port)
    assert all(np.isfinite(plosses))
    assert p1 > p0 + 0.3, (p0, p1)
    np.testing.assert_allclose(p0, r0, rtol=1e-5)
    np.testing.assert_allclose(plosses, rlosses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, r1, rtol=1e-4)
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_grad_leaves_parameter_grads_alone():
    """The decided difference: after `grad(critic(x).sum(), [x])` the
    port's parameters carry no gradient; the reference's carry that
    output's first-order gradient."""
    paddle.seed(11)
    ref = paddle.nn.Linear(8, 1)
    port = ptt.nn.Linear(8, 1)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    xs = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    x = ptt.to_tensor(xs, stop_gradient=False)
    rx = paddle.to_tensor(xs, stop_gradient=False)
    (gx,) = ptt.grad(port(x).sum(), [x], create_graph=True)
    (rgx,) = paddle.grad(ref(rx).sum(), [rx], create_graph=True)
    np.testing.assert_allclose(gx.detach().numpy(), np.asarray(rgx.numpy()),
                               rtol=1e-6)
    assert port.weight.grad is None and port.bias.grad is None
    np.testing.assert_allclose(np.asarray(ref.bias.grad.numpy()), [4.0])
