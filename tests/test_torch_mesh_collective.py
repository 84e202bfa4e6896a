"""CPU twins of the port's mesh, collectives, tensor-parallel rules and
DataParallel (`paddle_tpu_torch.parallel.mesh`, `.api`, `.comm`,
`paddle_tpu_torch.distributed`) against the JAX package's — the cases of
`test_distributed.py`'s TestMesh, TestTPRules, TestHybridTP, the
collective and DataParallel cases of TestCollectivesAPI, and
TestQuantizedAllReduce::test_matches_psum_within_quant_error.

The port runs in one 8-rank gloo world (one process a rank, a rank's
value is row `rank` of the reference's per-device input); the reference
runs its collectives under shard_map on the 8 virtual devices of
tests/conftest.py, and each rank's result is held to the reference's row
for that device: exactly for the integer-valued collectives, within
rtol 1e-5 / atol 1e-6 for the tensor-parallel MLP and DataParallel's
gradient, and the quantized all-reduce within 1e-6 of the block scale
of the reference's result (both quantize by the same float32 rule) and
within the reference test's 2e-2 of the exact sum.
"""
import os

import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8


def _mlp_data():
    rs = np.random.RandomState(0)
    return (rs.rand(8, 16).astype(np.float32),
            rs.rand(16, 8).astype(np.float32),
            rs.rand(4, 8).astype(np.float32))


def _qar_data(size):
    return np.random.RandomState(size).randn(N, size).astype(np.float32)


def _world(rank, dp_weights, dp_x, dp_y):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import (
        quantized_all_reduce)
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.api import shard_batch, shard_params_tp
    from paddle_tpu_torch.parallel.mesh import make_mesh, mesh_guard

    out = {}
    env = dist.init_parallel_env()
    out["rank_world"] = (dist.get_rank(), dist.get_world_size(), env.rank,
                         env.world_size, dist.is_initialized())
    m1 = make_mesh(dp=2, mp=2, pp=1, sp=2)
    m2 = make_mesh(mp=4)
    out["mesh_shapes"] = (m1.shape, m2.shape, m1.coords)

    # tensor-parallel MLP: w1 column-split, w2 row-split, x split over dp
    w1, w2, x = (torch.from_numpy(a) for a in _mlp_data())
    tp = make_mesh(dp=2, mp=4)
    loc = shard_params_tp(tp, {"fc1.weight": w1, "fc2.weight": w2})
    xl = shard_batch(tp, x)
    y = comm.reduce_from(torch.relu(xl @ loc["fc1.weight"])
                         @ loc["fc2.weight"], "mp", tp)
    out["tp_mlp"] = comm.gather_from(y, "dp", 0, tp)

    row = torch.tensor([float(rank)])
    g = dist.new_group([0, 1, 2, 3])
    out["group_info"] = (g.nranks, g.get_group_rank(2), g.get_group_rank(7),
                         dist.get_rank(g))
    out["halves"] = dist.all_reduce(row.clone(), group=g)
    out["bcast_g"] = dist.broadcast(row.clone(), src=2, group=g)
    g3 = dist.new_group([0, 1, 2])
    out["uneven_reduce"] = dist.all_reduce(row.clone(), group=g3)
    try:
        dist.broadcast(row.clone(), src=0, group=g3)
        out["uneven_bcast"] = ""
    except ValueError as e:
        out["uneven_bcast"] = str(e)
    g2 = dist.new_group([0, 1])
    out["bcast_g2"] = dist.broadcast(row.clone(), src=1, group=g2)
    out["world_sizes"] = (dist.get_world_size(g3), dist.get_world_size())
    out["reduce3"] = dist.reduce(row.clone(), dst=3)
    out["reduce5"] = dist.reduce(row.clone(), dst=5)
    t = torch.zeros(1)
    dist.scatter(t, [torch.full((1,), 10.0 * i) for i in range(N)], src=0)
    out["scatter"] = t
    t = torch.full((1,), -1.0)
    dist.scatter(t, [torch.full((1,), 100.0 + i) for i in range(4)], src=0,
                 group=g)
    out["scatter_g"] = t
    out["alltoall"] = torch.stack(dist.alltoall(
        [torch.tensor([100.0 * rank + j]) for j in range(N)]))
    out["all_gather"] = torch.cat(dist.all_gather([], row.clone()))
    rs_in = [torch.full((2,), float(rank * N + j)) for j in range(N)]
    out["reduce_scatter"] = dist.reduce_scatter(torch.zeros(2), rs_in)
    dist.barrier()
    out["barrier"] = True

    # DataParallel: each rank's row of the batch, averaged gradients
    net = torch.nn.Linear(2, 1)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(dp_weights["weight"]).T)
        net.bias.copy_(torch.from_numpy(dp_weights["bias"]))
    model = dist.DataParallel(net)
    xs, ys = torch.from_numpy(dp_x), torch.from_numpy(dp_y)
    loss = model.scale_loss(((model(xs[rank:rank + 1])
                              - ys[rank:rank + 1]) ** 2).mean())
    loss.backward()
    model.apply_collective_grads()
    out["dp_grad"] = net.weight.grad.T.clone()

    dpm = make_mesh(dp=N)
    with mesh_guard(dpm):
        for size in (1000, 777):
            out[f"qar{size}"] = quantized_all_reduce(
                torch.from_numpy(_qar_data(size)[rank]), "dp")

    # psum's gradient is the all-reduced cotangent (JAX's transpose)
    x = torch.tensor(float(rank + 1), requires_grad=True)
    y = comm.psum(x, "dp", dpm)
    y.backward()
    out["psum"] = (y.item(), x.grad.item())

    # sharded_train_step: pure dp, two AdamW steps of a linear model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import (data_parallel_shardings,
                                               replicate, sharded_train_step)
    xs, ys, w0 = (torch.from_numpy(a) for a in _sts_data())
    params = {"w": w0.clone().requires_grad_(True)}
    p_spec, b_spec = data_parallel_shardings(dpm, params, {"x": xs})
    out["dp_specs"] = (p_spec["w"], b_spec["x"], replicate(dpm))

    def loss_fn(p, batch):
        local = ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()
        return comm.mean_over(local, "dp", dpm)

    opt = AdamW(0.1, weight_decay=0.0, device="cpu")
    step = sharded_train_step(loss_fn, dpm, opt)
    state = opt.functional_init(params)
    batch = {"x": shard_batch(dpm, xs), "y": shard_batch(dpm, ys)}
    losses = []
    for _ in range(2):
        loss, params, state = step(params, state, batch)
        losses.append(loss.item())
    out["sts"] = (losses, params["w"].detach().clone())
    return out


def _sts_data():
    rs = np.random.RandomState(7)
    return (rs.randn(16, 4).astype(np.float32),
            rs.randn(16, 1).astype(np.float32),
            rs.randn(4, 1).astype(np.float32))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    w, x, y = _dp_reference()[1:]
    return run_world(_world, N, tmp_path_factory.mktemp("coll"), w, x, y)


def _dp_reference():
    """The reference test's net (paddle.seed(21) Linear(2, 1)), batch and
    full-batch gradient."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    from paddle_tpu.core.tensor import Tensor
    import jax.numpy as jnp

    paddle.seed(21)
    net = nn.Linear(2, 1)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 2).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    w = {"weight": np.asarray(net.weight.numpy()),
         "bias": np.asarray(net.bias.numpy())}
    out = net(Tensor(jnp.asarray(x)))
    loss = ((out - Tensor(jnp.asarray(y))) ** 2).mean()
    loss.backward()
    return np.asarray(net.weight.grad.numpy()), w, x, y


def _ref_shard_map(fn, xs=None):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.parallel.mesh import mesh_guard
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    xs = jnp.arange(8.0).reshape(8, 1) if xs is None else xs
    with mesh_guard(mesh):
        out = shard_map(fn, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                        check_rep=False)(xs)
    return np.asarray(out).ravel()


def test_mesh_axes_and_inferred_dp(port):
    """make_mesh(dp=2, mp=2, pp=1, sp=2) and make_mesh(mp=4) over 8 ranks:
    the reference's axis sizes, and rank r at the coordinates of device r
    in the reference's (dp, pp, mp, sp) reshape."""
    from paddle_tpu.parallel.mesh import make_mesh
    ref1 = make_mesh(dp=2, mp=2, pp=1, sp=2)
    ref2 = make_mesh(mp=4)
    for r in range(N):
        s1, s2, coords = port[r]["mesh_shapes"]
        assert s1 == dict(ref1.shape) == {"dp": 2, "pp": 1, "mp": 2,
                                          "sp": 2}
        assert s2 == dict(ref2.shape) and s2["dp"] == 2
        dev = np.array(ref1.devices)
        idx = [int(i[0]) for i in np.nonzero(dev == dev.ravel()[r])]
        assert [coords[a] for a in ("dp", "pp", "mp", "sp")] == idx


def test_tp_rules_match_reference():
    from paddle_tpu.parallel.api import tp_spec_for as ref_spec
    from paddle_tpu_torch.parallel.api import tp_spec_for
    from paddle_tpu_torch.parallel.mesh import P
    names = [("h.0.attn.q_proj.weight", 2), ("h.0.attn.out_proj.weight", 2),
             ("h.0.fc1.weight", 2), ("h.0.fc2.weight", 2),
             ("ln_f.weight", 1), ("h.0.qkv.bias", 1),
             ("embed_tokens.weight", 2), ("lm_head.weight", 2)]
    for name, nd in names:
        assert tuple(tp_spec_for(name, nd)) == tuple(ref_spec(name, nd)), \
            name
    assert tp_spec_for("h.0.attn.q_proj.weight", 2) == P(None, "mp")
    assert tp_spec_for("h.0.fc2.weight", 2) == P("mp", None)
    assert tp_spec_for("ln_f.weight", 1) == P()


def test_tp_sharded_mlp_matches_replicated(port):
    """dp 2 x mp 4: relu(x @ w1) @ w2 with w1 column-split, w2 row-split
    and one all-reduce, against the reference's sharded jit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paddle_tpu.parallel.mesh import make_mesh
    w1, w2, x = _mlp_data()
    mesh = make_mesh(dp=2, mp=4, pp=1, sp=1)
    sh = (NamedSharding(mesh, P(None, "mp")), NamedSharding(mesh,
                                                            P("mp", None)),
          NamedSharding(mesh, P("dp", None)))
    ref = np.asarray(jax.jit(lambda a, b, c: jax.nn.relu(c @ a) @ b,
                             in_shardings=sh)(
        *(jax.device_put(a, s) for a, s in zip((w1, w2, x), sh))))
    for r in range(N):
        np.testing.assert_allclose(port[r]["tp_mlp"], ref, rtol=1e-5,
                                   atol=1e-6)


def test_rank_and_world(port):
    for r in range(N):
        assert port[r]["rank_world"] == (r, N, r, N, True)


def test_new_group_halves_the_mesh(port):
    """all_reduce over group [0, 1, 2, 3]: the members sum, the rest sum
    among themselves — the reference's axis_index_groups."""
    import paddle_tpu.distributed as rdist
    from paddle_tpu.core.tensor import Tensor
    g = rdist.new_group([0, 1, 2, 3])
    ref = _ref_shard_map(lambda x: rdist.all_reduce(Tensor(x),
                                                    group=g)._value)
    np.testing.assert_allclose(ref, [6.0] * 4 + [22.0] * 4)
    for r in range(N):
        assert port[r]["group_info"] == (4, 2, -1, r if r < 4 else -1)
        assert float(port[r]["halves"][0]) == ref[r]


def test_group_broadcast_and_alltoall(port):
    import paddle_tpu.distributed as rdist
    from paddle_tpu.core.tensor import Tensor
    g = rdist.new_group([0, 1, 2, 3])
    ref = _ref_shard_map(lambda x: rdist.broadcast(Tensor(x), src=2,
                                                   group=g)._value)
    for r in range(N):
        assert float(port[r]["bcast_g"][0]) == ref[r]
        # alltoall: rank r's j-th output is rank j's r-th input
        np.testing.assert_array_equal(port[r]["alltoall"].ravel(),
                                      [100.0 * j + r for j in range(N)])
        np.testing.assert_array_equal(port[r]["all_gather"], np.arange(8.0))
        # reduce_scatter: chunk r of the sum of every rank's list
        want = sum(float(k * N + r) for k in range(N))
        np.testing.assert_array_equal(port[r]["reduce_scatter"], [want] * 2)


def test_uneven_group_reduce_works_gather_raises(port):
    import paddle_tpu.distributed as rdist
    from paddle_tpu.core.tensor import Tensor
    g3 = rdist.new_group([0, 1, 2])
    ref = _ref_shard_map(lambda x: rdist.all_reduce(Tensor(x),
                                                    group=g3)._value)
    g2 = rdist.new_group([0, 1])
    ref2 = _ref_shard_map(lambda x: rdist.broadcast(Tensor(x), src=1,
                                                    group=g2)._value)
    for r in range(N):
        assert float(port[r]["uneven_reduce"][0]) == ref[r]
        assert "equal-sized" in port[r]["uneven_bcast"]
        assert float(port[r]["bcast_g2"][0]) == ref2[r]
    assert ref[0] == 3.0 and ref2[0] == 1.0


def test_group_world_size_and_honest_semantics(port):
    for r in range(N):
        assert port[r]["world_sizes"] == (3, N)


@pytest.mark.parametrize("dst", [3, 5])
def test_reduce_dst_semantics(port, dst):
    """reduce(dst): dst (a global rank) gets the sum, every other rank
    keeps its input — the reference's on 1-D and 2-D meshes."""
    import paddle_tpu.distributed as rdist
    from paddle_tpu.core.tensor import Tensor
    ref = _ref_shard_map(lambda x: rdist.reduce(Tensor(x), dst=dst)._value)
    for r in range(N):
        assert float(port[r][f"reduce{dst}"][0]) == ref[r]
    assert ref[dst] == 28.0


def test_scatter(port):
    """scatter: rank i receives tensor_list[i]; over a group the members
    take their group slot and the rest keep their input."""
    for r in range(N):
        assert float(port[r]["scatter"][0]) == 10.0 * r
        assert float(port[r]["scatter_g"][0]) == (100.0 + r if r < 4
                                                  else -1.0)


def test_barrier_is_a_real_collective(port):
    assert all(port[r]["barrier"] for r in range(N))


def test_data_parallel_apply_collective_grads(port):
    """Each rank's one-row batch, apply_collective_grads: the averaged
    gradient equals the reference's full-batch gradient."""
    want = _dp_reference()[0]
    for r in range(N):
        np.testing.assert_allclose(port[r]["dp_grad"], want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("size", [1000, 777])
def test_quantized_all_reduce_matches_psum_within_quant_error(port, size):
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.collective import quantized_all_reduce
    from paddle_tpu.parallel.mesh import make_mesh
    g = _qar_data(size)
    ref = np.asarray(shard_map(
        lambda gl: quantized_all_reduce(gl[0], "dp")[None],
        mesh=make_mesh(dp=N), in_specs=P("dp", None),
        out_specs=P("dp", None), check_rep=False)(jnp.asarray(g)))[0]
    exact = g.sum(0)
    for r in range(N):
        got = port[r][f"qar{size}"]
        np.testing.assert_array_equal(got, port[0][f"qar{size}"])
        assert np.abs(got - exact).max() / np.abs(exact).max() < 2e-2
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_psum_gradient(port):
    for r in range(N):
        assert port[r]["psum"] == (36.0, float(N))


def test_sharded_train_step_matches_reference(port):
    """Pure dp over 8 ranks (2 rows a rank): two AdamW steps of the
    reference's sharded_train_step on the whole batch give the same loss
    and parameters; the specs are the reference's (params replicated,
    the batch split on dp)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu import optimizer as opt_mod
    from paddle_tpu.parallel.api import (data_parallel_shardings,
                                         sharded_train_step)
    from paddle_tpu.parallel.mesh import make_mesh
    xs, ys, w0 = _sts_data()
    mesh = make_mesh(dp=N)
    opt = opt_mod.AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": jnp.asarray(w0)}
    batch = {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}
    p_sh, b_sh = data_parallel_shardings(mesh, params, batch)

    def step_fn(p, state, b, key):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2))(p)
        p, state = opt.functional_update(p, g, state)
        return loss, p, state

    step = sharded_train_step(step_fn, mesh, p_sh, b_sh,
                              donate_params=False)
    state = opt.functional_init(params)
    losses = []
    for _ in range(2):
        loss, params, state = step(params, state, batch, None)
        losses.append(float(loss))
    for r in range(N):
        got_losses, w = port[r]["sts"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(w, np.asarray(params["w"]), rtol=1e-5,
                                   atol=1e-6)
        p_spec, b_spec, rep = port[r]["dp_specs"]
        assert tuple(p_spec) == tuple(p_sh["w"].spec) == tuple(rep) == ()
        assert tuple(b_spec) == tuple(b_sh["x"].spec) == ("dp", None)


def test_wire_bytes_match_reference():
    from paddle_tpu.distributed.collective import \
        quantized_allreduce_wire_bytes as ref_bytes
    from paddle_tpu_torch.distributed.collective import \
        quantized_allreduce_wire_bytes
    for size, n, bits in ((1000, 8, 8), (777, 8, 8), (10, 8, 8),
                          (1 << 20, 4, 16)):
        assert quantized_allreduce_wire_bytes(size, n, bits) == \
            ref_bytes(size, n, bits)


def _spawned(path):
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(device="cpu")
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    with open(os.path.join(path, f"r{os.environ['PADDLE_TRAINER_ID']}"),
              "w") as f:
        f.write(f"{dist.get_world_size()} {t.item()}")


def test_init_parallel_env_defaults_to_the_card(monkeypatch, tmp_path):
    """A world of more than one rank with no device= and no card raises
    naming device='cpu' before it joins anything."""
    import paddle_tpu_torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_parallel_env(init_method=f"file://{tmp_path}/store",
                               rank=0, world_size=2)
    assert not dist.is_initialized()


def test_spawn_runs_ranks(tmp_path):
    """spawn: each rank sees PADDLE_TRAINER_ID and the rendezvous, joins
    with init_parallel_env (gloo on the CPU) and all-reduces."""
    from paddle_tpu_torch.distributed import spawn
    spawn(_spawned, args=(str(tmp_path),), nprocs=2, timeout=120)
    for r in range(2):
        assert open(tmp_path / f"r{r}").read() == "2 3.0"
