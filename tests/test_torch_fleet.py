"""CPU twins of the port's fleet (`paddle_tpu_torch.distributed.fleet`:
the strategy, its lowering into the train step, the module facade,
metrics and utils) against the JAX package's — the cases of
`test_distributed.py`'s TestDataParallelStep, TestStrategyFlagLowering,
TestFleetModuleFacade, TestFleetUtils,
TestCollectivesAPI::test_fleet_init_and_strategy / ::test_fleet_metrics
and TestQuantizedAllReduce::test_strategy_flag_trains /
::test_small_leaf_falls_back_to_psum_and_bits16.

Every flag set in CASES runs twice on the same numpy data and weights:
the reference's `build_hybrid_train_step` on the 8 virtual devices of
tests/conftest.py, and the port's in ONE 8-rank gloo world (a rank per
device, the same mesh). Each case compares every step's loss and the
parameters after the steps (the full leaves: ZeRO-3 and the pipeline's
gathered back; localsgd's and dgc's copy on rank r against row r of the
reference's [dp, ...] stacks, and dgc's residuals too). Tolerances: loss
and parameters rtol 1e-5 / atol 1e-6 in float32 (the mean over dp is
summed in another order than GSPMD's global mean); the int8 all-reduce
within 1e-4 (both quantize by the same float32 rule; a code that rounds
the other way moves by one block step, 1/127 of the block's scale, times
the lr); amp within 2e-2 relative (bf16). Lamb and Lars under ZeRO
stages 1-3 are also held to the port's unsharded update at 1e-6.
"""

import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8
DP8 = {"dp_degree": 8, "mp_degree": 1, "pp_degree": 1, "sp_degree": 1}

# name: (flags, hybrid, optimizer, kwargs, loss, params, data, steps)
CASES = {
    "plain": ({}, DP8, "SGD", {"learning_rate": 0.1}, "lin", "lin", 16,
              6),
    "zero_default": ({"sharding": True}, DP8, "Adam",
                     {"learning_rate": 0.01}, "sq", "sq", 16, 3),
    "gradient_merge": ({"gradient_merge": True, "gradient_merge_configs":
                        {"k_steps": 4, "avg": True}}, DP8, "SGD",
                       {"learning_rate": 0.1}, "res", "res4", 32, 6),
    "amp_recompute": ({"amp": True, "recompute": True}, DP8, "SGD",
                      {"learning_rate": 0.01}, "mlp", "mlp", 16, 2),
    "localsgd": ({"localsgd": True, "localsgd_configs": {"k_steps": 2}},
                 DP8, "SGD", {"learning_rate": 0.1}, "res", "res4", 32, 3),
    "dgc": ({"dgc": True, "dgc_configs": {"sparsity": [0.75]}}, DP8, "SGD",
            {"learning_rate": 0.05}, "res", "res4", 32, 6),
    "pipeline": ({"pipeline": True, "pipeline_configs":
                  {"accumulate_steps": 4}},
                 {"dp_degree": 1, "mp_degree": 1, "pp_degree": 8,
                  "sp_degree": 1}, "SGD", {"learning_rate": 0.05}, None,
                 "stack", 8, 4),
    "zero1": ({"sharding": True, "sharding_configs": {"stage": 1}}, DP8,
              "Adam", {"learning_rate": 0.01}, "res", "res8", 32, 3),
    "zero3": ({"sharding": True, "sharding_configs": {"stage": 3}}, DP8,
              "Adam", {"learning_rate": 0.01}, "res", "res8", 32, 3),
    "int8_allreduce": ({"int8_allreduce": True}, DP8, "SGD",
                       {"learning_rate": 0.05}, "res", "res4", 32, 10),
    "fp16_allreduce": ({"fp16_allreduce": True}, DP8, "SGD",
                       {"learning_rate": 0.1}, "res", "res4", 32, 4),
    "lamb": ({"lamb": True}, DP8, "Adam", {"learning_rate": 0.01}, "res",
             "wide", 32, 3),
    "lars": ({"lars": True}, DP8, "Momentum",
             {"learning_rate": 0.1, "momentum": 0.9}, "res", "wide", 32, 3),
    "lamb_zero1": ({"lamb": True, "sharding": True,
                    "sharding_configs": {"stage": 1}}, DP8, "Adam",
                   {"learning_rate": 0.01}, "res", "wide", 32, 3),
    "lamb_zero2": ({"lamb": True, "sharding": True,
                    "sharding_configs": {"stage": 2}}, DP8, "Adam",
                   {"learning_rate": 0.01}, "res", "wide", 32, 3),
    "lamb_zero3": ({"lamb": True, "sharding": True,
                    "sharding_configs": {"stage": 3}}, DP8, "Adam",
                   {"learning_rate": 0.01}, "res", "wide", 32, 3),
    "lars_zero2": ({"lars": True, "sharding": True,
                    "sharding_configs": {"stage": 2}}, DP8, "Momentum",
                   {"learning_rate": 0.1, "momentum": 0.9}, "res", "wide",
                   32, 3),
    "zero2_sgd": ({"sharding": True, "sharding_configs": {"stage": 2}},
                  DP8, "SGD", {"learning_rate": 0.1}, "res", "wide", 32, 3),
    "zero3_sgd": ({"sharding": True, "sharding_configs": {"stage": 3}},
                  DP8, "SGD", {"learning_rate": 0.1}, "res", "wide", 32, 3),
    "clip_zero3": ({"sharding": True, "sharding_configs": {"stage": 3}},
                   DP8, "Adam", {"learning_rate": 0.05, "clip": 0.05},
                   "res", "wide", 32, 3),
    # a plain loss on dp 2 x mp 2 x sp 2 runs replicated over mp and sp
    "dp2_mp2_sp2": ({}, {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                         "sp_degree": 2}, "Adam", {"learning_rate": 0.01},
                    "res", "res4", 32, 3),
}
UNSHARDED = {"lamb_zero1": "lamb", "lamb_zero2": "lamb", "lamb_zero3":
             "lamb", "lars_zero2": "lars"}
EXPLICIT = ("localsgd", "dgc", "int8_allreduce")


def _params(kind):
    rs = np.random.RandomState(1)
    if kind == "lin":
        return {"w": rs.rand(4, 2).astype(np.float32),
                "b": np.zeros(2, np.float32)}
    if kind == "sq":
        return {"w": rs.rand(8, 16).astype(np.float32)}
    if kind == "mlp":
        return {"w1": np.full((4, 8), 0.1, np.float32),
                "w2": np.full((8, 1), 0.2, np.float32)}
    if kind == "stack":
        return np.stack([np.eye(4, dtype=np.float32) * 0.9
                         for _ in range(8)])
    if kind == "res4":
        return {"w": np.ones((4, 1), np.float32)}
    if kind == "res8":
        return {"w": np.ones((8, 1), np.float32)}
    return {"w": rs.randn(8, 4).astype(np.float32) * 0.5,
            "v": rs.randn(3, 4).astype(np.float32) * 0.5}


def _data(case):
    flags, hybrid, _, _, loss, kind, n, _ = CASES[case]
    rs = np.random.RandomState(0)
    if kind == "stack":
        return {"x": rs.rand(8, 4).astype(np.float32),
                "y": np.zeros((8, 4), np.float32)}
    d = {"lin": 4, "sq": 8, "mlp": 4, "res4": 4, "res8": 8, "wide": 8}[kind]
    out = {"x": rs.rand(n, d).astype(np.float32),
           "y": rs.rand(n, {"lin": 2, "wide": 4}.get(kind, 1)).astype(
               np.float32)}
    if kind == "wide":
        out["z"] = rs.rand(n, 3).astype(np.float32)
    return out


def _port_loss(kind):
    def lin(p, b, key):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def sq(p, b, key):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    def res(p, b, key):
        if "v" in p:
            return torch.mean((b["x"] @ p["w"] + b["z"] @ p["v"]
                               - b["y"]) ** 2)
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def mlp(p, b, key):
        h = torch.tanh(b["x"].to(p["w1"].dtype) @ p["w1"])
        return torch.mean((h @ p["w2"]) ** 2)

    return {"lin": lin, "sq": sq, "res": res, "mlp": mlp}[kind]


def _ref_loss(kind):
    import jax.numpy as jnp

    def lin(p, b, key):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def sq(p, b, key):
        return jnp.mean((b["x"] @ p["w"]) ** 2)

    def res(p, b, key):
        if "v" in p:
            return jnp.mean((b["x"] @ p["w"] + b["z"] @ p["v"]
                             - b["y"]) ** 2)
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def mlp(p, b, key):
        h = jnp.tanh(b["x"].astype(p["w1"].dtype) @ p["w1"])
        return jnp.mean((h @ p["w2"]) ** 2)

    return {"lin": lin, "sq": sq, "res": res, "mlp": mlp}[kind]


def _strategy(fleet, case):
    flags, hybrid = CASES[case][:2]
    s = fleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    s.hybrid_configs = dict(hybrid)
    return s


def _optimizer(mod, nn_mod, case, **dev):
    name, kw = CASES[case][2], dict(CASES[case][3])
    clip = kw.pop("clip", None)
    if clip is not None:
        kw["grad_clip"] = nn_mod.ClipGradByGlobalNorm(clip)
    return getattr(mod, name)(**kw, **dev)


def _run_port(rank, case):
    import paddle_tpu_torch.nn as pnn
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta import wrap_optimizer

    strategy = _strategy(fleet, case)
    opt = wrap_optimizer(None, _optimizer(popt, pnn, case, device="cpu"),
                         strategy)
    loss_kind, kind, steps = CASES[case][4], CASES[case][5], CASES[case][7]
    kw = {}
    if case == "pipeline":
        kw = dict(stage_fn=lambda w, a: torch.tanh(a @ w),
                  loss_head=lambda y, lab: torch.mean((y - lab) ** 2))
    step, mesh = fleet.build_hybrid_train_step(
        strategy, None if loss_kind is None else _port_loss(loss_kind),
        opt, **kw)
    init = _params(kind)
    init = torch.from_numpy(init) if isinstance(init, np.ndarray) else \
        {k: torch.from_numpy(v) for k, v in init.items()}
    if case in EXPLICIT or case.startswith("zero") or "_zero" in case:
        params, state = step.init_opt_state(init, device="cpu")
    else:
        params = init
        state = opt.functional_init(params)
    batch = _data(case)
    out = {"losses": [], "type": type(opt).__name__}
    for i in range(steps):
        loss, params, state = step.compile_for(params, batch, state)(
            params, state, batch, None)
        out["losses"].append(float(loss))
        if case == "localsgd":
            out[f"w{i}"] = params["w"].clone()
    if case in ("zero1", "zero3"):
        slot = state["slots"]["w"]["moment1"]
        out["shapes"] = (tuple(params["w"].shape), tuple(slot.shape))
    if case == "amp_recompute":
        out["dtype"] = str(params["w1"].dtype)
    out["params"] = step.gather_params(params)
    if case == "dgc":
        out["err"] = state["dgc_err"]
    return out


def _fleet_world(rank):
    import paddle_tpu_torch.distributed as pdist
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.collective import quantized_all_reduce
    from paddle_tpu_torch.parallel.mesh import make_mesh, mesh_guard

    res = {c: _run_port(rank, c) for c in CASES}
    # fleet.init and the strategy's optimizer swap
    strategy = fleet.DistributedStrategy()
    strategy.lamb = True
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    p = torch.ones(4, requires_grad=True)
    wrapped = fleet.distributed_optimizer(
        popt.Adam(learning_rate=0.01, parameters=[p], device="cpu"),
        strategy)
    res["init"] = (type(wrapped).__name__, fleet.worker_num(),
                   pdist.get_world_size(), fleet.worker_index(),
                   fleet.is_first_worker())
    from paddle_tpu_torch.distributed.fleet import metrics as M
    res["metrics"] = (M.sum(np.array([1.0, float(rank)])),
                      M.max(np.array([float(rank)])),
                      M.acc(np.array([float(rank % 2)]), np.array([1.0])))
    # the pipeline flag without its stage function; ZeRO with the pipeline
    errs = []
    for flags in ({"pipeline": True}, {"pipeline": True, "sharding": True}):
        s = fleet.DistributedStrategy()
        for k, v in flags.items():
            setattr(s, k, v)
        s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 8,
                            "sp_degree": 1}
        try:
            kw = {} if len(flags) == 1 else dict(
                stage_fn=lambda w, a: a, loss_head=lambda y, lab: y.sum())
            fleet.build_hybrid_train_step(
                s, _port_loss("res"), popt.SGD(0.1, device="cpu"), **kw)
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["errors"] = errs
    # the quantized all-reduce: a small leaf takes the exact sum, 16 bits
    with mesh_guard(make_mesh(dp=N)):
        small, big = _qar_data()
        res["qar_small"] = quantized_all_reduce(
            torch.from_numpy(small[rank]), "dp")
        res["qar16"] = quantized_all_reduce(torch.from_numpy(big[rank]),
                                            "dp", bits=16)
    return res


def _qar_data():
    rs = np.random.RandomState(1)
    return (rs.randn(N, 4).astype(np.float32),
            (rs.randn(N, 4096) * 100).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_fleet_world, N, tmp_path_factory.mktemp("fleet"))


def _ref_run(case):
    import jax
    import jax.numpy as jnp

    import paddle_tpu.nn as rnn
    import paddle_tpu.optimizer as ropt
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet.meta import wrap_optimizer

    strategy = _strategy(fleet, case)
    opt = wrap_optimizer(None, _optimizer(ropt, rnn, case), strategy)
    loss_kind, kind, steps = CASES[case][4], CASES[case][5], CASES[case][7]
    kw = {}
    if case == "pipeline":
        kw = dict(stage_fn=lambda w, a: jnp.tanh(a @ w),
                  loss_head=lambda y, lab: jnp.mean((y - lab) ** 2))
    step, mesh = fleet.build_hybrid_train_step(
        strategy, None if loss_kind is None else _ref_loss(loss_kind), opt,
        **kw)
    init = _params(kind)
    params = jnp.asarray(init) if isinstance(init, np.ndarray) else \
        {k: jnp.asarray(v) for k, v in init.items()}
    if case in EXPLICIT:
        params, state = step.init_opt_state(params)
    else:
        state = opt.functional_init(params)
    batch = _data(case)
    jitted = step.compile_for(params, batch, state)
    out = {"losses": [], "type": type(opt).__name__}
    for i in range(steps):
        loss, params, state = jitted(params, state, batch,
                                     jax.random.key(i))
        out["losses"].append(float(loss))
        if case == "localsgd":
            out[f"w{i}"] = np.asarray(params["w"])
    out["params"] = jax.tree_util.tree_map(np.asarray, params)
    if case == "dgc":
        out["err"] = {k: np.asarray(v) for k, v in
                      state["dgc_err"].items()}
    return out


def _close(a, b, case, what, rtol=1e-5, atol=1e-6):
    if case == "amp_recompute":
        rtol, atol = 2e-2, 1e-4
    if case == "int8_allreduce":
        rtol, atol = 1e-4, 1e-4
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg=f"{case} {what}")


@pytest.mark.parametrize("case", [c for c in CASES if c not in
                                  ("localsgd", "dgc")])
def test_flag_matches_reference(world, case):
    ref = _ref_run(case)
    for r in range(N):
        got = world[r][case]
        assert got["type"] == ref["type"], (got["type"], ref["type"])
        _close(got["losses"], ref["losses"], case, "losses")
        gp, rp = got["params"], ref["params"]
        if isinstance(rp, dict):
            assert set(gp) == set(rp)
            for k in rp:
                _close(gp[k], rp[k], case, k)
        else:
            _close(gp, rp, case, "params")
    if case == "amp_recompute":
        assert world[0][case]["dtype"] == "torch.float32"
    if case in UNSHARDED:
        base = world[0][UNSHARDED[case]]
        for k, v in base["params"].items():
            np.testing.assert_allclose(world[0][case]["params"][k], v,
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    if case == "zero1":   # slots split over dp, params whole
        assert world[0][case]["shapes"] == ((8, 1), (1, 1))
    if case == "zero3":   # the params split too
        assert world[0][case]["shapes"] == ((1, 1), (1, 1))


def test_localsgd_copies_diverge_then_average(world):
    ref = _ref_run("localsgd")
    for i in range(CASES["localsgd"][7]):
        for r in range(N):
            _close(world[r]["localsgd"][f"w{i}"], ref[f"w{i}"][r],
                   "localsgd", f"step {i} rank {r}")
    w0 = [world[r]["localsgd"]["w0"] for r in range(N)]
    assert not np.allclose(w0[0], w0[4]), "copies should differ pre-avg"
    w1 = [world[r]["localsgd"]["w1"] for r in range(N)]
    for r in range(1, N):
        np.testing.assert_array_equal(w1[r], w1[0])
    _close(world[0]["localsgd"]["losses"], ref["losses"], "localsgd",
           "losses")


def test_dgc_residuals_and_params(world):
    ref = _ref_run("dgc")
    for r in range(N):
        got = world[r]["dgc"]
        _close(got["losses"], ref["losses"], "dgc", "losses")
        _close(got["params"]["w"], ref["params"]["w"], "dgc", "w")
        _close(got["err"]["w"], ref["err"]["w"][r], "dgc", f"err {r}")
    assert np.abs(world[0]["dgc"]["err"]["w"]).sum() > 0
    assert world[0]["dgc"]["losses"][-1] < world[0]["dgc"]["losses"][0]


def test_fleet_init_and_strategy(world):
    for r in range(N):
        name, wnum, size, idx, first = world[r]["init"]
        assert name == "Lamb" and wnum == size == N and idx == r
        assert first == (r == 0)


def test_fleet_metrics(world):
    from paddle_tpu.distributed.fleet import metrics as RM
    from paddle_tpu_torch.distributed.fleet import metrics as M
    s, mx, acc = world[3]["metrics"]
    np.testing.assert_allclose(s, [8.0, sum(range(N))])
    assert mx[0] == N - 1 and acc == 0.5
    # the world of one: the reference's values
    np.testing.assert_allclose(M.sum(np.array([1.0, 2.0])),
                               RM.sum(np.array([1.0, 2.0])))
    for fn, args in (("acc", (np.array([3.0]), np.array([4.0]))),
                     ("mae", (np.array([2.0]), 4)),
                     ("rmse", (np.array([16.0]), 4)),
                     ("mse", (np.array([16.0]), 4))):
        assert getattr(M, fn)(*args) == getattr(RM, fn)(*args), fn
    pos, neg = np.zeros(4), np.zeros(4)
    pos[3], neg[0] = 10, 10
    assert M.auc(pos, neg) == RM.auc(pos, neg) == 1.0
    rs = np.random.RandomState(0)
    pos, neg = rs.rand(16), rs.rand(16)
    assert M.auc(pos, neg) == RM.auc(pos, neg)
    assert M.auc(np.zeros(4), np.zeros(4)) == 0.5


def test_pipeline_needs_stage_fn_and_zero_with_pipeline_refused(world):
    need, zero = world[0]["errors"]
    assert "stage_fn" in need
    assert "sharding" in zero


def test_quantized_small_leaf_and_bits16(world):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.collective import quantized_all_reduce
    from paddle_tpu.parallel.mesh import make_mesh

    small, big = _qar_data()
    mesh = make_mesh(dp=N)
    outs = {}
    for name, x, bits in (("qar_small", small, 8), ("qar16", big, 16)):
        outs[name] = np.asarray(jax.jit(shard_map(
            lambda g, b=bits: quantized_all_reduce(g[0], "dp",
                                                   bits=b)[None],
            mesh=mesh, in_specs=P("dp", None), out_specs=P("dp", None),
            check_rep=False))(jnp.asarray(x)))[0]
    for r in range(N):
        np.testing.assert_allclose(world[r]["qar_small"], small.sum(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(world[r]["qar_small"],
                                   outs["qar_small"], rtol=1e-6)
        got = world[r]["qar16"]
        exact = big.sum(0)
        assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-4
        scale = np.abs(outs["qar16"]).max() / 32767
        assert np.abs(got - outs["qar16"]).max() <= 2 * scale + 1e-3


@pytest.mark.parametrize("gran", ["full", "selective", "dots"])
def test_recompute_granularity_policies(gran):
    """Every granularity's gradients equal the loss's without recompute
    (1e-6, the reference test's) and the reference's jax.grad."""
    import jax

    from paddle_tpu.distributed.fleet.meta import apply_strategy as rapply
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta import apply_strategy

    p_np = {"w1": np.full((4, 8), 0.1, np.float32),
            "w2": np.full((8, 1), 0.2, np.float32)}
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32)

    def grads(fn):
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in p_np.items()}
        loss = fn(p, {"x": torch.from_numpy(x)}, None)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    base = grads(_port_loss("mlp"))
    s = fleet.DistributedStrategy()
    s.recompute = True
    s.recompute_configs = {"granularity": gran}
    got = grads(apply_strategy(s, _port_loss("mlp")))
    rs = rfleet.DistributedStrategy()
    rs.recompute = True
    rs.recompute_configs = {"granularity": gran}
    ref = jax.grad(rapply(rs, _ref_loss("mlp")))(p_np, {"x": x}, None)
    for k in p_np:
        np.testing.assert_allclose(got[k].numpy(), base[k].numpy(),
                                   rtol=1e-6, err_msg=gran)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=gran)
    s.recompute_configs = {"granularity": "bogus"}
    with pytest.raises(ValueError, match="granularity"):
        apply_strategy(s, _port_loss("mlp"))(
            {k: torch.from_numpy(v) for k, v in p_np.items()},
            {"x": torch.from_numpy(x)}, None)


def test_recompute_repeats_dropout_masks():
    """A torch.Generator key is rewound before the recomputation: the
    gradients under recompute equal those without, dropout included."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta import apply_strategy

    def loss(p, b, gen):
        h = torch.tanh(b["x"] @ p["w1"])
        keep = torch.empty_like(h).bernoulli_(0.5, generator=gen)
        return torch.mean((h * keep @ p["w2"]) ** 2)

    x = torch.from_numpy(np.random.RandomState(0).rand(16, 4).astype(
        np.float32))
    out = []
    for on in (False, True):
        s = fleet.DistributedStrategy()
        s.recompute = on
        p = {"w1": torch.full((4, 8), 0.1, requires_grad=True),
             "w2": torch.full((8, 1), 0.2, requires_grad=True)}
        fn = apply_strategy(s, loss)
        val = fn(p, {"x": x}, torch.Generator().manual_seed(5))
        out.append(torch.autograd.grad(val, list(p.values())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_module_level_shortcuts():
    """The fleet module binds every Fleet method; fleet.minimize trains
    the optimizer the strategy wrapped, as the reference's does."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as rnn
    import paddle_tpu.optimizer as ropt
    from paddle_tpu.distributed import fleet as rfleet
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed import fleet

    for name in ("init", "is_worker", "is_server", "barrier_worker",
                 "init_worker", "init_server", "run_server",
                 "stop_worker", "minimize", "step", "clear_grad",
                 "get_lr", "set_lr", "state_dict", "set_state_dict",
                 "worker_endpoints", "server_num", "server_index",
                 "server_endpoints", "save_persistables",
                 "save_inference_model", "util", "_final_strategy",
                 "_get_applied_meta_list", "_get_applied_graph_list"):
        assert hasattr(fleet, name), f"fleet.{name} missing"
    rfleet.init(is_collective=True)
    net = rnn.Linear(3, 1)
    w0, b0 = net.weight.numpy().copy(), net.bias.numpy().copy()
    fleet.init(is_collective=True, device="cpu")
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    b = torch.from_numpy(b0.copy()).requires_grad_(True)
    for f, opt in ((rfleet, ropt.SGD(learning_rate=0.1,
                                     parameters=net.parameters())),
                   (fleet, popt.SGD(learning_rate=0.1, parameters=[w, b],
                                    device="cpu"))):
        strategy = f.DistributedStrategy()
        strategy.amp = True
        strategy.recompute = True
        f.distributed_optimizer(opt, strategy)
    x = np.ones((4, 3), np.float32)
    rfleet.minimize((net(paddle.to_tensor(x)) ** 2).mean())
    rfleet.clear_grad()
    fleet.minimize(((torch.from_numpy(x) @ w + b) ** 2).mean())
    fleet.clear_grad()
    assert not np.allclose(w0, w.detach().numpy())
    np.testing.assert_allclose(w.detach().numpy(), net.weight.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), net.bias.numpy(),
                               rtol=1e-6)
    assert w.grad is None
    assert fleet.get_lr() == rfleet.get_lr() == 0.1
    sd = fleet.state_dict()
    fleet.set_state_dict(sd)
    assert sd["@step"] == 1
    applied = fleet._get_applied_meta_list()
    assert any("bf16" in a for a in applied)
    assert any("checkpoint" in a for a in applied)
    assert [a.split("->")[0] for a in applied] == \
        [a.split("->")[0] for a in rfleet._get_applied_meta_list()]
    assert fleet._get_applied_graph_list() == []


def test_applied_mechanisms_name_every_flag():
    from paddle_tpu.distributed.fleet.meta import applied_mechanisms as ref
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta import applied_mechanisms
    from paddle_tpu.distributed import fleet as rfleet

    flags = ("amp", "recompute", "sharding", "gradient_merge", "pipeline",
             "localsgd", "dgc", "int8_allreduce", "lamb", "lars")
    s, rs = fleet.DistributedStrategy(), rfleet.DistributedStrategy()
    for f in flags:
        setattr(s, f, True)
        setattr(rs, f, True)
    got, want = applied_mechanisms(s), ref(rs)
    assert len(got) == len(flags)
    assert [a.split("->")[0] for a in got] == \
        [a.split("->")[0] for a in want]
    assert repr(s) == repr(rs)
    assert vars(fleet.DistributedStrategy()).keys() == \
        vars(rfleet.DistributedStrategy()).keys()


class TestFleetUtils:
    def test_local_fs_roundtrip(self, tmp_path):
        from paddle_tpu.distributed.fleet.utils import LocalFS as RefFS
        from paddle_tpu_torch.distributed.fleet.utils import LocalFS

        seen = []
        for cls, sub in ((RefFS, "ref"), (LocalFS, "port")):
            fs, root = cls(), tmp_path / sub
            root.mkdir()
            d = str(root / "ckpt")
            fs.mkdirs(d)
            assert fs.is_dir(d) and fs.is_exist(d)
            f = str(root / "ckpt" / "model.pdparams")
            fs.touch(f)
            assert fs.is_file(f)
            fs.upload(f, str(root / "up.bin"))
            dirs, files = fs.ls_dir(str(root))
            assert fs.list_dirs(str(root)) == dirs
            fs.mv(f, str(root / "moved.bin"))
            assert not fs.is_exist(f)
            with pytest.raises(Exception, match="moved.bin"):
                fs.mv(str(root / "up.bin"), str(root / "moved.bin"))
            fs.delete(d)
            seen.append((dirs, files, fs.ls_dir(str(root)),
                         fs.need_upload_download()))
        assert seen[0] == seen[1]
        assert seen[1][0] == ["ckpt"] and seen[1][1] == ["up.bin"]

    def test_hdfs_client_raises_clearly_without_hadoop(self, monkeypatch):
        from paddle_tpu_torch.distributed.fleet.utils import (ExecuteError,
                                                              HDFSClient)

        monkeypatch.delenv("HADOOP_HOME", raising=False)
        client = HDFSClient(hadoop_home=None)
        with pytest.raises(ExecuteError, match="hadoop"):
            client.is_exist("/x")
        assert client.need_upload_download() is True

    def test_kv_server_rendezvous(self):
        from paddle_tpu_torch.distributed.fleet.utils import (KVClient,
                                                              KVServer)

        srv = KVServer(0, size={"worker": 2})
        srv.start()
        try:
            c = KVClient(f"127.0.0.1:{srv.port}")
            assert c.put("/worker/0", "host0:8888")
            assert c.put("/worker/1", "host1:8888")
            assert c.get("/worker/0") == "host0:8888"
            assert c.get("/missing") == ""
            assert not srv.should_stop()
            c.delete("/worker/0")
            c.delete("/worker/1")
            assert srv.should_stop()
        finally:
            srv.stop()


def test_cluster_helpers_match_reference(monkeypatch):
    from paddle_tpu.distributed import cloud_utils as rcu
    from paddle_tpu.distributed import utils as ru
    from paddle_tpu_torch.distributed import cloud_utils as cu
    from paddle_tpu_torch.distributed import utils as u
    from paddle_tpu_torch.distributed.fleet import launch_utils

    args = (["10.0.0.1", "10.0.0.2"], "10.0.0.2",
            ["10.0.0.1:6170", "10.0.0.1:6171", "10.0.0.2:6170",
             "10.0.0.2:6171"], [0, 1])

    def tree(c, p):
        return ([str(x) for x in c.pods], c.trainers_endpoints(),
                c.world_device_ids(), str(p), c.pods_endpoints())

    assert tree(*u.get_cluster(*args)) == tree(*ru.get_cluster(*args))
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:6170,10.0.0.2:6170")
    monkeypatch.setenv("POD_IP", "10.0.0.2")
    assert tree(*cu.get_cloud_cluster()) == tree(*rcu.get_cloud_cluster())
    assert len(u.find_free_ports(3)) == 3
    assert launch_utils.get_cluster is u.get_cluster
