"""CPU twin of `tests/test_op_grad_sweep.py`, op by op: the port's
gradients (torch.autograd) against the reference tape's (the JAX
package's eager `jax.vjp` pullbacks) of sum(op(*xs) · proj) for a fixed
random projection, on the same small inputs placed in smooth regions.
No finite differences — both sides are exact, so the tolerance is float32
rounding: rtol 1e-4, atol 1e-6. Second order: the Hessian-vector product
of the reference's `TestDoubleGrads` through `grad(create_graph=True)`
on both sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def _pos(shape, lo=0.5, hi=1.5, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _any(shape, seed=1):
    return (np.random.RandomState(seed).randn(*shape) * 0.5) \
        .astype(np.float32)


def _spread(shape, seed=2):
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    vals = (np.arange(n) * 0.37 + 0.1) * rs.choice([-1, 1], n)
    rs.shuffle(vals)
    return vals.reshape(shape).astype(np.float32)


def grads_both(build, *arrays, diff_idx=None):
    """build(P, *tensors) with P the reference module or the port's;
    returns nothing, asserts the gradients agree."""
    diff_idx = range(len(arrays)) if diff_idx is None else diff_idx
    ts = [ptt.to_tensor(a, stop_gradient=False) for a in arrays]
    rts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = build(ptt, *ts)
    rout = build(paddle, *rts)
    assert list(out.shape) == list(rout.shape)
    proj = (np.asarray(np.random.RandomState(7).rand(*tuple(out.shape)))
            + 0.5).astype(np.float32)
    (out * ptt.to_tensor(proj)).sum().backward()
    (rout * paddle.to_tensor(proj)).sum().backward()
    for k in diff_idx:
        np.testing.assert_allclose(
            ts[k].grad.detach().numpy(), np.asarray(rts[k].grad.numpy()),
            rtol=RTOL, atol=ATOL, err_msg=f"input {k}")


def fn_of(P, op):
    return getattr(P, op) if hasattr(P, op) \
        else getattr(P.nn.functional, op)


class TestElementwiseGrads:
    @pytest.mark.parametrize("op,args", [
        ("add", (_any((2, 3)), _any((2, 3), 3))),
        ("subtract", (_any((2, 3)), _any((2, 3), 4))),
        ("multiply", (_any((2, 3)), _any((2, 3), 5))),
        ("divide", (_any((2, 3)), _pos((2, 3), seed=6))),
        ("pow", (_pos((2, 3)), 2.0)),
        ("exp", (_any((2, 3)),)),
        ("log", (_pos((2, 3)),)),
        ("sqrt", (_pos((2, 3)),)),
        ("rsqrt", (_pos((2, 3)),)),
        ("tanh", (_any((2, 3)),)),
        ("sin", (_any((2, 3)),)),
        ("cos", (_any((2, 3)),)),
        ("erf", (_any((2, 3)),)),
        ("square", (_any((2, 3)),)),
        ("reciprocal", (_pos((2, 3)),)),
        ("sigmoid", (_any((2, 3)),)),
        ("maximum", (_spread((2, 3)), _spread((2, 3), 9))),
        ("minimum", (_spread((2, 3)), _spread((2, 3), 10))),
        ("logsumexp", (_any((2, 3)),)),
        ("cumsum", (_any((2, 3)),)),
        ("cumprod", (_pos((2, 3)),)),
        ("softplus", (_any((2, 3)),)),
        ("expm1", (_any((2, 3)),)),
        ("log1p", (_pos((2, 3)),)),
        ("log2", (_pos((2, 3)),)),
        ("log10", (_pos((2, 3)),)),
        ("atan", (_any((2, 3)),)),
        ("sinh", (_any((2, 3)),)),
        ("cosh", (_any((2, 3)),)),
        ("tan", (_any((2, 3), 11),)),
        ("asinh", (_any((2, 3)),)),
        ("softsign", (_any((2, 3)),)),
        ("celu", (_any((2, 3)),)),
        ("trace", (_any((3, 3)),)),
        ("outer", (_any((3,)), _any((4,), 12))),
        ("kron", (_any((2, 2)), _any((2, 3), 13))),
        # the activations and elementwise ops the reference sweep does
        # not list, the same way
        ("elu", (_spread((2, 3)),)),
        ("selu", (_spread((2, 3)),)),
        ("gelu", (_any((2, 3)),)),
        ("silu", (_any((2, 3)),)),
        ("mish", (_any((2, 3)),)),
        ("hardswish", (_spread((2, 3)),)),
        ("leaky_relu", (_spread((2, 3)),)),
        ("log_sigmoid", (_any((2, 3)),)),
        ("tanhshrink", (_any((2, 3)),)),
        ("atan2", (_any((2, 3)), _pos((2, 3), seed=4))),
        ("lerp", (_any((2, 3)), _any((2, 3), 5), _pos((2, 3), 0.1, 0.9))),
    ])
    def test_grad(self, op, args):
        tensor_args = [a for a in args if isinstance(a, np.ndarray)]
        scalars = [a for a in args if not isinstance(a, np.ndarray)]
        grads_both(lambda P, *xs: fn_of(P, op)(*xs, *scalars), *tensor_args)


class TestReductionShapeGrads:
    @pytest.mark.parametrize("build,arrays", [
        (lambda P, x: P.mean(x), (_any((3, 4)),)),
        (lambda P, x: P.sum(x, axis=1), (_any((3, 4)),)),
        (lambda P, x: P.max(x, axis=1), (_spread((3, 4)),)),
        (lambda P, x: P.min(x, axis=0), (_spread((3, 4), 5),)),
        (lambda P, x: P.prod(x, axis=1), (_pos((2, 3)),)),
        (lambda P, x: P.logsumexp(x, axis=1), (_any((3, 4)),)),
        (lambda P, x: P.cumsum(x, axis=1), (_any((2, 4)),)),
        (lambda P, x: P.reshape(x, [4, 3]), (_any((3, 4)),)),
        (lambda P, x: P.transpose(x, [1, 0]), (_any((3, 4)),)),
        (lambda P, x: P.squeeze(P.unsqueeze(x, 0), 0), (_any((2, 3)),)),
        (lambda P, x: P.tile(x, [2, 1]), (_any((2, 3)),)),
        (lambda P, x: P.flip(x, [1]), (_any((2, 3)),)),
        (lambda P, x: P.clip(x, -0.4, 0.4) * 1.0,
         (_spread((2, 3)) * 0.1,)),
        (lambda P, x: P.norm(x, p=2), (_pos((2, 3)),)),
        (lambda P, x, y: P.concat([x, y], axis=1),
         (_any((2, 2)), _any((2, 3), 8))),
        (lambda P, x, y: P.stack([x, y], axis=0),
         (_any((2, 3)), _any((2, 3), 9))),
        (lambda P, x, y: P.where(P.to_tensor(
            np.array([[True, False, True], [False, True, False]])), x, y),
         (_any((2, 3)), _any((2, 3), 11))),
        (lambda P, x: P.std(x, axis=1), (_any((3, 4)),)),
        (lambda P, x: P.var(x), (_any((3, 4)),)),
        (lambda P, x: P.expand(x, [3, 2, 3]), (_any((2, 3)),)),
        (lambda P, x: P.split(x, [1, -1], axis=1)[1], (_any((2, 4)),)),
        (lambda P, x: P.pad(x, [1, 0, 0, 2]), (_any((2, 3)),)),
    ])
    def test_grad(self, build, arrays):
        grads_both(build, *arrays)


class TestContractionGrads:
    def test_matmul(self):
        grads_both(lambda P, a, b: P.matmul(a, b),
                   _any((2, 3)), _any((3, 4), 3))

    def test_bmm(self):
        grads_both(lambda P, a, b: P.bmm(a, b),
                   _any((2, 2, 3)), _any((2, 3, 2), 4))

    def test_linear_functional(self):
        grads_both(lambda P, x, w, b: P.nn.functional.linear(x, w, b),
                   _any((2, 3)), _any((3, 4), 5), _any((4,), 6))

    def test_einsum(self):
        grads_both(lambda P, a, b: P.einsum("bij,jk->bik", a, b),
                   _any((2, 2, 3)), _any((3, 4), 4))

    def test_embedding_weight_grad(self):
        ids = np.array([[0, 2], [1, 2]])
        grads_both(lambda P, w: P.nn.functional.embedding(P.to_tensor(ids),
                                                          w),
                   _any((4, 3)))

    @pytest.mark.parametrize("kw", [{"stride": 1, "padding": 1},
                                    {"stride": 2, "padding": "SAME"},
                                    {"padding": [1, 0, 0, 1], "groups": 2}])
    def test_conv2d_functional(self, kw):
        grads_both(lambda P, x, w: P.nn.functional.conv2d(x, w, **kw),
                   _any((1, 2, 4, 4)),
                   _any((4, 2 // kw.get("groups", 1), 3, 3), 7))

    def test_conv2d_transpose_functional(self):
        grads_both(lambda P, x, w: P.nn.functional.conv2d_transpose(
            x, w, stride=2, padding=[1, 0, 1, 2]),
            _any((1, 2, 3, 3)), _any((2, 3, 3, 3), 8))


class TestNormalizationLossGrads:
    def test_softmax(self):
        grads_both(lambda P, x: P.nn.functional.softmax(x, axis=-1),
                   _any((2, 4)))

    def test_log_softmax(self):
        grads_both(lambda P, x: P.nn.functional.log_softmax(x, axis=-1),
                   _any((2, 4)))

    def test_layer_norm_functional(self):
        grads_both(
            lambda P, x, w, b: P.nn.functional.layer_norm(x, (4,), w, b),
            _any((3, 4)), _pos((4,), seed=8), _any((4,), 9))

    def test_batch_norm_training(self):
        def bn(P, x, w, b):
            mean = P.to_tensor(np.zeros(3, np.float32))
            var = P.to_tensor(np.ones(3, np.float32))
            return P.nn.functional.batch_norm(x, mean, var, w, b,
                                              training=True)[0]
        grads_both(bn, _any((4, 3, 2)), _pos((3,), seed=8), _any((3,), 9))

    def test_group_and_instance_norm(self):
        grads_both(lambda P, x: P.nn.functional.group_norm(x, 2),
                   _any((2, 4, 3)))
        grads_both(lambda P, x: P.nn.functional.instance_norm(x),
                   _any((2, 3, 4)))

    def test_gelu(self):
        grads_both(lambda P, x: P.nn.functional.gelu(x), _any((2, 4)))

    def test_relu_off_kink(self):
        grads_both(lambda P, x: P.nn.functional.relu(x), _spread((2, 3)))

    def test_cross_entropy(self):
        labels = np.array([1, 3])
        grads_both(lambda P, lg: P.nn.functional.cross_entropy(
            lg, P.to_tensor(labels)), _any((2, 4)))
        grads_both(lambda P, lg: P.nn.functional.cross_entropy(
            lg, P.to_tensor(labels), label_smoothing=0.2), _any((2, 4)))

    def test_mse_loss(self):
        y = _any((2, 3), 12)
        grads_both(lambda P, x: P.nn.functional.mse_loss(x, P.to_tensor(y)),
                   _any((2, 3)))

    def test_softmax_with_cross_entropy(self):
        labels = np.array([[1], [2]])
        grads_both(lambda P, lg: P.nn.functional.softmax_with_cross_entropy(
            lg, P.to_tensor(labels)), _any((2, 4)))

    def test_bce_and_smooth_l1(self):
        y = _pos((2, 3), 0.0, 1.0, seed=3)
        grads_both(lambda P, x: P.nn.functional
                   .binary_cross_entropy_with_logits(x, P.to_tensor(y)),
                   _any((2, 3)))
        grads_both(lambda P, x: P.nn.functional.smooth_l1_loss(
            x, P.to_tensor(y)), _spread((2, 3)))


class TestIndexingGrads:
    def test_gather(self):
        idx = np.array([0, 2])
        grads_both(lambda P, x: P.gather(x, P.to_tensor(idx)), _any((3, 4)))

    def test_slice(self):
        grads_both(lambda P, x: x[:, 1:3], _any((2, 4)))

    def test_index_select(self):
        idx = np.array([2, 0])
        grads_both(lambda P, x: P.index_select(x, P.to_tensor(idx), axis=1),
                   _any((2, 4)))

    def test_pad(self):
        grads_both(lambda P, x: P.nn.functional.pad(x, [1, 1, 0, 1]),
                   _any((1, 1, 2, 3)))

    def test_pools(self):
        grads_both(lambda P, x: P.nn.functional.avg_pool2d(x, 3, 2, 1),
                   _any((1, 2, 5, 5)))
        grads_both(lambda P, x: P.nn.functional.max_pool2d(x, 2, 2),
                   _spread((1, 2, 4, 4)))

    def test_scatter_overwrite_false(self):
        idx = np.array([0, 2])
        grads_both(lambda P, x, u: P.scatter(x, P.to_tensor(idx), u,
                                             overwrite=False),
                   _any((3, 2)), _any((2, 2), 4))


class TestDoubleGrads:
    @pytest.mark.parametrize("op,mk", [
        ("tanh", lambda: _any((2, 3))),
        ("exp", lambda: _any((2, 3))),
        ("square", lambda: _any((2, 3))),
        ("sigmoid", lambda: _any((2, 3))),
        ("log", lambda: _pos((2, 3))),
    ])
    def test_hvp(self, op, mk):
        a = mk()
        v = _any(a.shape, 13)

        def hvp(P):
            t = P.to_tensor(a, stop_gradient=False)
            out = fn_of(P, op)(t).sum()
            (gr,) = P.grad([out], [t], create_graph=True)
            (gg,) = P.grad([(gr * P.to_tensor(v)).sum()], [t])
            return np.asarray(gg.detach().numpy() if torch.is_tensor(gg)
                              else gg.numpy())

        np.testing.assert_allclose(hvp(ptt), hvp(paddle), rtol=RTOL,
                                   atol=ATOL)
