"""CPU twins of the port's autograd API (`paddle_tpu_torch.autograd` over
torch's engine: `grad`, `backward`, `no_grad`, `enable_grad`,
`set_grad_enabled`, tensor hooks, `PyLayer`) against the JAX package's
tape: every case of `tests/test_autograd.py` and of
`tests/test_double_grad.py`, each run on both sides with the same seeded
numpy inputs. `stop_gradient=False` maps to `requires_grad`.

Tolerances: gradients rtol 1e-5 (float32), the finite-difference checks
of the reference's own tests as there (rtol 1e-2, 2e-2).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import ops as rops

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import ops as pops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def leaf(x):
    return ptt.to_tensor(np.asarray(x, np.float32), stop_gradient=False)


def rleaf(x):
    t = paddle.to_tensor(np.asarray(x, np.float32))
    t.stop_gradient = False
    return t


def g(x):
    return x.detach().numpy()


def rg(x):
    return np.asarray(x.numpy())


class TestBackward:
    def test_simple_chain(self):
        x, rx = leaf([2.0, 3.0]), rleaf([2.0, 3.0])
        (x * x).sum().backward()
        (rx * rx).sum().backward()
        np.testing.assert_allclose(g(x.grad), rg(rx.grad))
        np.testing.assert_allclose(g(x.grad), [4.0, 6.0])

    def test_two_paths(self):
        x = leaf([1.0])
        (x * 2 + x * 3).backward()
        np.testing.assert_allclose(g(x.grad), [5.0])

    def test_matmul_grad(self):
        a0 = np.random.RandomState(0).rand(3, 4)
        b0 = np.random.RandomState(1).rand(4, 2)
        a, b = leaf(a0), leaf(b0)
        ra, rb = rleaf(a0), rleaf(b0)
        pops.matmul(a, b).sum().backward()
        rops.matmul(ra, rb).sum().backward()
        np.testing.assert_allclose(g(a.grad), rg(ra.grad), rtol=1e-5)
        np.testing.assert_allclose(g(b.grad), rg(rb.grad), rtol=1e-5)

    def test_stop_gradient(self):
        x = leaf([1.0])
        c = ptt.to_tensor([2.0])  # stop_gradient=True
        assert not c.requires_grad
        (x * c).sum().backward()
        assert c.grad is None
        np.testing.assert_allclose(g(x.grad), [2.0])

    def test_detach(self):
        x = leaf([3.0])
        y = x * x
        (y.detach() * x).sum().backward()
        np.testing.assert_allclose(g(x.grad), [9.0])

    def test_accumulation_and_clear(self):
        x = leaf([1.0])
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        np.testing.assert_allclose(g(x.grad), [5.0])
        opt = ptt.optimizer.SGD(0.1, parameters=[x])
        opt.clear_grad()
        assert x.grad is None

    def test_no_grad(self):
        x = leaf([1.0])
        with ptt.no_grad():
            y = x * 2
        assert not y.requires_grad and y.grad_fn is None

        @ptt.no_grad()
        def f(v):
            return v * 3
        assert not f(x).requires_grad
        with ptt.no_grad():
            with ptt.enable_grad():
                assert (x * 2).requires_grad
        with ptt.set_grad_enabled(False):
            assert not ptt.is_grad_enabled()
        assert ptt.is_grad_enabled()

    def test_grad_api(self):
        x, rx = leaf([2.0]), rleaf([2.0])
        (gp,) = ptt.grad(x * x * x, x, retain_graph=True)
        (gr,) = paddle.grad(rx * rx * rx, rx, retain_graph=True)
        np.testing.assert_allclose(g(gp), rg(gr), rtol=1e-5)
        np.testing.assert_allclose(g(gp), [12.0], rtol=1e-5)
        assert x.grad is None  # functional: no side effects

    def test_grad_unused_and_several_outputs(self):
        x, y = leaf([2.0]), leaf([5.0])
        rx, ry = rleaf([2.0]), rleaf([5.0])
        gp = ptt.grad([x * x, x * 3], [x, y])
        gr = paddle.grad([rx * rx, rx * 3], [rx, ry])
        for a, b in zip(gp, gr):
            np.testing.assert_allclose(g(a), rg(b))
        assert ptt.grad(x * 2, [x, y], allow_unused=True)[1] is None
        gout = ptt.grad(x * 2, [x], grad_outputs=[ptt.to_tensor([3.0])])
        np.testing.assert_allclose(g(gout[0]), [6.0])

    def test_multi_output_op(self):
        x = leaf(np.array([[1.0, 5.0, 3.0]]))
        vals, idx = pops.topk(x, 2)
        vals.sum().backward()
        np.testing.assert_allclose(g(x.grad), [[0.0, 1.0, 1.0]])

    def test_softmax_ce_grad_matches_analytic(self):
        lg = np.random.RandomState(2).rand(4, 5).astype(np.float32)
        logits = leaf(lg)
        labels = ptt.to_tensor(np.array([0, 1, 2, 3]))
        pops.cross_entropy(logits, labels).backward()
        p = np.exp(lg) / np.exp(lg).sum(1, keepdims=True)
        onehot = np.eye(5)[[0, 1, 2, 3]]
        np.testing.assert_allclose(g(logits.grad), (p - onehot) / 4,
                                   rtol=1e-4, atol=1e-6)

    def test_backward_nonscalar_with_grad(self):
        x = leaf([1.0, 2.0])
        (x * 3).backward(ptt.to_tensor([1.0, 10.0]))
        np.testing.assert_allclose(g(x.grad), [3.0, 30.0])
        y = leaf([1.0, 2.0])
        ptt.autograd.backward([y * 2], [ptt.to_tensor([1.0, 1.0])])
        np.testing.assert_allclose(g(y.grad), [2.0, 2.0])

    def test_hook(self):
        x = leaf([1.0])
        seen = []
        h = ptt.autograd.register_hook(x, lambda gr: seen.append(g(gr)))
        (x * 2).sum().backward()
        assert len(seen) == 1 and seen[0][0] == 2.0
        h.remove()
        x.register_hook(lambda gr: gr * 10)
        x.grad = None
        (x * 2).sum().backward()
        np.testing.assert_allclose(g(x.grad), [20.0])

    def test_conv_grad_finite_diff(self):
        x0 = np.random.RandomState(3).rand(1, 2, 5, 5).astype(np.float32)
        w0 = (np.random.RandomState(4).rand(3, 2, 3, 3) * 0.1) \
            .astype(np.float32)
        x, w = leaf(x0), leaf(w0)
        rx, rw = rleaf(x0), rleaf(w0)
        pops.conv2d(x, w, padding=1).sum().backward()
        rops.conv2d(rx, rw, padding=1).sum().backward()
        np.testing.assert_allclose(g(w.grad), rg(rw.grad), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g(x.grad), rg(rx.grad), rtol=1e-4,
                                   atol=1e-5)
        eps = 1e-3
        wp, wm = w0.copy(), w0.copy()
        wp[0, 0, 0, 0] += eps
        wm[0, 0, 0, 0] -= eps
        lp = float(pops.conv2d(ptt.to_tensor(x0), ptt.to_tensor(wp),
                               padding=1).sum())
        lm = float(pops.conv2d(ptt.to_tensor(x0), ptt.to_tensor(wm),
                               padding=1).sum())
        np.testing.assert_allclose(g(w.grad)[0, 0, 0, 0],
                                   (lp - lm) / (2 * eps), rtol=1e-2)


class TestLayerTraining:
    def test_linear_regression_converges(self):
        ptt.seed(0)
        true_w = np.array([[2.0], [-3.0]], np.float32)
        x_data = np.random.RandomState(0).rand(64, 2).astype(np.float32)
        y_data = x_data @ true_w + 0.5
        lin = ptt.nn.Linear(2, 1)
        opt = ptt.optimizer.SGD(learning_rate=0.5,
                                parameters=lin.parameters())
        for _ in range(200):
            loss = ((lin(ptt.to_tensor(x_data)) - ptt.to_tensor(y_data))
                    ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        assert float(loss) < 1e-3
        np.testing.assert_allclose(g(lin.weight), true_w, atol=0.05)

    def test_mlp_classification_matches_reference(self):
        """The same MLP, weights carried across, 20 Adam steps on both
        sides: the losses agree step for step."""
        from paddle_tpu_torch.nn.layer.layers import load_reference_state
        paddle.seed(1)
        n = 128
        x_data = np.random.RandomState(1).randn(n, 4).astype(np.float32)
        y_data = (x_data.sum(1) > 0).astype(np.int64)
        ref = paddle.nn.Sequential(paddle.nn.Linear(4, 16),
                                   paddle.nn.ReLU(),
                                   paddle.nn.Linear(16, 2))
        model = ptt.nn.Sequential(ptt.nn.Linear(4, 16), ptt.nn.ReLU(),
                                  ptt.nn.Linear(16, 2))
        load_reference_state(model, {k: np.asarray(v.numpy()) for k, v in
                                     ref.state_dict().items()})
        r_opt = paddle.optimizer.Adam(0.01, parameters=ref.parameters())
        opt = ptt.optimizer.Adam(0.01, parameters=model.parameters())
        ce, rce = ptt.nn.CrossEntropyLoss(), paddle.nn.CrossEntropyLoss()
        losses = []
        for _ in range(20):
            loss = ce(model(ptt.to_tensor(x_data)), ptt.to_tensor(y_data))
            rloss = rce(ref(paddle.to_tensor(x_data)),
                        paddle.to_tensor(y_data))
            np.testing.assert_allclose(float(loss), float(rloss.numpy()),
                                       rtol=1e-4)
            losses.append(float(loss))
            loss.backward()
            opt.step()
            opt.clear_grad()
            rloss.backward()
            r_opt.step()
            r_opt.clear_grad()
        assert losses[-1] < losses[0]


# ---- the cases of tests/test_double_grad.py ----------------------------------

def test_second_and_third_order():
    x = ptt.to_tensor([2.0], stop_gradient=False)
    (g1,) = ptt.grad(x * x * x, [x], create_graph=True)
    np.testing.assert_allclose(g(g1), [12.0])
    (g2,) = ptt.grad(g1, [x], create_graph=True)
    np.testing.assert_allclose(g(g2), [12.0])
    (g3,) = ptt.grad(g2, [x])
    np.testing.assert_allclose(g(g3), [6.0])


def test_gradient_penalty_pattern():
    x = ptt.to_tensor([2.0], stop_gradient=False)
    rx = paddle.to_tensor([2.0], stop_gradient=False)
    (h,) = ptt.grad(x * x * x, [x], create_graph=True)
    (rh,) = paddle.grad(rx * rx * rx, [rx], create_graph=True)
    (hp,) = ptt.grad((h * h).sum(), [x])
    (rhp,) = paddle.grad((rh * rh).sum(), [rx])
    np.testing.assert_allclose(g(hp), rg(rhp), rtol=1e-5)
    np.testing.assert_allclose(g(hp), [288.0])


def test_mixed_partial():
    a = ptt.to_tensor([3.0], stop_gradient=False)
    b = ptt.to_tensor([5.0], stop_gradient=False)
    (ga,) = ptt.grad(a * a * b, [a], create_graph=True)
    (gab,) = ptt.grad(ga, [b])
    np.testing.assert_allclose(g(gab), [6.0])


def test_double_grad_through_layer():
    from paddle_tpu_torch.nn.layer.layers import load_reference_state
    paddle.seed(7)
    rlin = paddle.nn.Linear(4, 1)
    lin = ptt.nn.Linear(4, 1)
    load_reference_state(lin, {k: np.asarray(v.numpy())
                               for k, v in rlin.state_dict().items()})
    xs = np.ones((2, 4), np.float32)
    x = ptt.to_tensor(xs, stop_gradient=False)
    rx = paddle.to_tensor(xs, stop_gradient=False)
    (gx,) = ptt.grad(ptt.nn.functional.tanh(lin(x)).sum(), [x],
                     create_graph=True)
    (ggx,) = ptt.grad((gx * gx).sum(), [x], allow_unused=False)
    (rgx,) = paddle.grad(paddle.nn.functional.tanh(rlin(rx)).sum(), [rx],
                         create_graph=True)
    (rggx,) = paddle.grad((rgx * rgx).sum(), [rx])
    np.testing.assert_allclose(g(ggx), rg(rggx), rtol=1e-4, atol=1e-6)
    eps = 1e-3

    def gnorm_at(v00):
        xv = xs.copy()
        xv[0, 0] = v00
        xt = ptt.to_tensor(xv, stop_gradient=False)
        (gg,) = ptt.grad(ptt.nn.functional.tanh(lin(xt)).sum(), [xt])
        return float((gg * gg).sum())

    fd = (gnorm_at(1.0 + eps) - gnorm_at(1.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g(ggx)[0, 0]), fd, rtol=2e-2,
                               atol=1e-4)


def test_first_order_unchanged_without_create_graph():
    x = ptt.to_tensor([2.0], stop_gradient=False)
    (g1,) = ptt.grad(x * x, [x])
    np.testing.assert_allclose(g(g1), [4.0])
    assert not g1.requires_grad  # detached by default, as before


def test_backward_accumulation_not_regressed():
    x = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * x).sum().backward()
    np.testing.assert_allclose(g(x.grad), [2.0, 4.0])


# ---- PyLayer -------------------------------------------------------------------

def test_pylayer_matches_reference():
    from paddle_tpu.autograd import PyLayer as RPyLayer
    from paddle_tpu_torch.autograd import PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x * ctx.k

    class RCube(RPyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.attrs["k"] = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x * ctx.attrs["k"]

    x, rx = leaf([1.0, 2.0]), rleaf([1.0, 2.0])
    y, ry = Cube.apply(x, 2.0), RCube.apply(rx, 2.0)
    np.testing.assert_allclose(g(y), rg(ry))
    y.sum().backward()
    ry.sum().backward()
    np.testing.assert_allclose(g(x.grad), rg(rx.grad))
    with pytest.raises(RuntimeError, match="apply"):
        Cube()


def test_enable_static_raises_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="§A 14"):
        ptt.enable_static()
    assert ptt.in_dygraph_mode()
