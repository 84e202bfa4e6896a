"""CPU twins of the port's SyncBatchNorm (`paddle_tpu_torch.nn.
SyncBatchNorm`, `nn.layer.norm.sync_batch_norm`) against the JAX
package's — the cases of `test_sync_batchnorm.py`.

The cross-rank cases run the port in one 8-rank gloo world (a rank per
shard of the batch, the mesh dp 8 or mp 8) and the reference under
shard_map on the 8 virtual devices; each rank's output, its input
gradient and the running statistics are held to the reference's within
1e-5 (the mp case within 4e-7 x its offset squared: see there), and to
BatchNorm over the global batch (the reference test's 2e-4). The eager cases compare the two packages' layers on the same
input within 1e-5.
"""
import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8


def _global_x():
    rs = np.random.RandomState(0)
    # shards of different distributions: local statistics != global
    return np.concatenate([rs.randn(4, 3, 4, 4).astype(np.float32) + i * 2.0
                           for i in range(N)], axis=0)


def _mp_x():
    rs = np.random.RandomState(5)
    return np.stack([rs.randn(4, 2).astype(np.float32) + 10 * i
                     for i in range(N)])


def _world(rank):
    import paddle_tpu_torch.nn as pnn
    from paddle_tpu_torch.parallel.mesh import make_mesh, mesh_guard

    x = torch.from_numpy(_global_x()[rank * 4:(rank + 1) * 4]) \
        .requires_grad_(True)
    dp = make_mesh(dp=N)
    bn = pnn.SyncBatchNorm(3, mesh=dp, device="cpu")
    bn.train()
    out = bn(x)
    # a global loss: the sum over ranks of each rank's local part
    w = torch.from_numpy(np.random.RandomState(rank).rand(*out.shape)
                         .astype(np.float32))
    (out * w).sum().backward()
    res = {"out": out.detach(), "dx": x.grad, "mean": bn._mean.clone(),
           "var": bn._variance.clone(), "dw": bn.weight.grad}
    with mesh_guard(dp):   # the current mesh is the default
        bn2 = pnn.SyncBatchNorm(3, device="cpu")
        res["current_mesh"] = bn2(x.detach()).detach()
    mp = make_mesh(dp=1, mp=N)
    sbn = pnn.SyncBatchNorm(2, mesh=mp, device="cpu")
    res["mp"] = sbn(torch.from_numpy(_mp_x()[rank])).detach()
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_world, N, tmp_path_factory.mktemp("syncbn"))


def _ref_sharded(x, fn_shard, spec_axis):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:N]), (spec_axis,))
    from paddle_tpu.parallel.mesh import mesh_guard
    with mesh_guard(mesh):
        return jax.jit(shard_map(fn_shard, mesh=mesh, in_specs=P(spec_axis),
                                 out_specs=P(spec_axis),
                                 check_rep=False))(jnp.asarray(x))


def test_sync_bn_matches_global_batch_stats(world):
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle

    x = _global_x()

    def shard_fn(xs):
        bn = paddle.nn.SyncBatchNorm(3)
        bn.train()
        return bn(paddle.Tensor(xs))._value

    ref = np.asarray(_ref_sharded(x, shard_fn, "dp"))
    ref_bn = paddle.nn.BatchNorm2D(3)
    ref_bn.train()
    full = ref_bn(paddle.to_tensor(x)).numpy()
    for r in range(N):
        sl = slice(r * 4, (r + 1) * 4)
        got = world[r]
        np.testing.assert_allclose(got["out"], ref[sl], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["out"], full[sl], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got["current_mesh"], got["out"],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got["mean"], ref_bn._mean.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["var"], ref_bn._variance.numpy(),
                                   rtol=1e-5)
    # the input gradient of the global loss sum_r <out_r, w_r>: the
    # port's psum backward against jax.grad of batch norm over the whole
    # batch
    ws = np.concatenate([np.random.RandomState(r).rand(4, 3, 4, 4)
                         .astype(np.float32) for r in range(N)])

    def global_loss(xa):
        mean = xa.mean((0, 2, 3), keepdims=True)
        var = xa.var((0, 2, 3), keepdims=True)
        return jnp.sum((xa - mean) / jnp.sqrt(var + 1e-5) * ws)

    dx = np.asarray(jax.grad(global_loss)(jnp.asarray(x)))
    scale = np.abs(dx).max()
    for r in range(N):
        assert np.abs(world[r]["dx"] - dx[r * 4:(r + 1) * 4]).max() \
            <= 1e-4 * scale, r
    dw = sum(world[r]["dw"] for r in range(N))
    assert np.abs(dw).sum() > 0


def test_non_dp_axes_not_synced(world):
    import paddle_tpu as paddle

    def shard_fn(xs):
        sbn = paddle.nn.SyncBatchNorm(2)
        sbn.train()
        return sbn(paddle.Tensor(xs[0]))._value[None]

    ref = np.asarray(_ref_sharded(_mp_x(), shard_fn, "mp"))
    for r in range(N):
        # shard r sits at 10 r with unit spread: E[x^2] - E[x]^2 in float32
        # (the reference's formula and the port's) loses a few ulps of
        # (10 r)^2 from the variance, summed in another order on each side
        np.testing.assert_allclose(world[r]["mp"], ref[r], rtol=0,
                                   atol=max(1e-5, 4e-7 * (10 * r) ** 2))
        np.testing.assert_allclose(world[r]["mp"].mean(), 0.0, atol=1e-5)


def _eager_pair(c):
    import paddle_tpu as paddle
    import paddle_tpu_torch.nn as pnn
    r = paddle.nn.SyncBatchNorm(c)
    p = pnn.SyncBatchNorm(c, device="cpu")
    r.train()
    p.train()
    rs = np.random.RandomState(c)
    w, b = rs.rand(c).astype(np.float32), rs.rand(c).astype(np.float32)
    r.weight._value, r.bias._value = w, b
    with torch.no_grad():
        p.weight.copy_(torch.from_numpy(w))
        p.bias.copy_(torch.from_numpy(b))
    return r, p


@pytest.mark.parametrize("shape", [(8, 5), (6, 3, 4, 4)])
def test_sync_bn_eager_equals_reference(shape):
    import paddle_tpu as paddle
    import paddle_tpu_torch.nn as pnn
    x = (np.random.RandomState(1).randn(*shape) * 2 + 5).astype(np.float32)
    r, p = _eager_pair(shape[1])
    a = p(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(a, r(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p._mean.numpy(), r._mean.numpy(), rtol=1e-5)
    np.testing.assert_allclose(p._variance.numpy(), r._variance.numpy(),
                               rtol=1e-5)
    assert not np.allclose(p._mean.numpy(), 0.0)
    bn = pnn.BatchNorm1D(shape[1], device="cpu") if len(shape) == 2 else \
        pnn.BatchNorm2D(shape[1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(p.weight)
        bn.bias.copy_(p.bias)
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), a,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn._variance.numpy(), p._variance.numpy(),
                               rtol=1e-5)
    # evaluation reads the running statistics
    p.eval()
    r.eval()
    np.testing.assert_allclose(p(torch.from_numpy(x)).detach().numpy(),
                               r(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_eager_gradients_flow():
    import paddle_tpu as paddle
    x = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    r, p = _eager_pair(4)
    xr = paddle.to_tensor(x, stop_gradient=False)
    (r(xr) ** 2).sum().backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    (p(xt) ** 2).sum().backward()
    np.testing.assert_allclose(p.weight.grad.numpy(), r.weight.grad.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert np.abs(p.weight.grad.numpy()).sum() > 0


def test_convert_sync_batchnorm():
    import paddle_tpu_torch.nn as pnn
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              pnn.BatchNorm2D(4, device="cpu"))
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
        net[1].weight.fill_(2.0)
    out = pnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], pnn.SyncBatchNorm)
    assert float(out[1]._mean[0]) == 0.5 and float(out[1].weight[0]) == 2.0
    assert isinstance(out[0], torch.nn.Conv2d)
