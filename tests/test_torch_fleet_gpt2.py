"""CPU twins of GPT-2 under the port's fleet step
(`distributed.fleet.build_hybrid_train_step`) against the JAX package's
`test_fleet_gpt2.py`: the same weights (the reference's `init_params()`
carried across as numpy) and batches, one 8-rank gloo world at dp 2 x
mp 2 x sp 2.

  * `test_gpt2_hybrid_dp_mp_sp_trains`: the port's flat GPT-2 loss
    (`models/gpt2.py`) as a plain loss, replicated over mp and sp (ROADMAP
    §C 20), with recompute on (the reference builds its loss with
    remat=True), six AdamW steps (lr 1e-3, decay 0.01) against the
    reference test's own sharded step: every step's loss within 1e-4
    relative, the parameters within 2 * lr * steps (a near-zero gradient
    moves a weight by about +-lr whatever its rounding).
  * `test_gpt2_matches_single_device`: `models/gpt2_hybrid.py`'s
    mesh-aware loss (tensor-parallel over mp, the ring over sp) on the
    flat weights carried into its layout (`params_from_gpt2`): the loss
    within 1e-5 of the reference's single-device loss (the reference test
    allows 2e-3), every rank's gradients within 1e-4 of each leaf's
    largest magnitude of jax.grad's slices, and one SGD step's
    parameters within 1e-6; the plain loss at the same mesh likewise.
"""
import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

N = 8
HYBRID = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1, "sp_degree": 2}
CFG_A = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_position=64, dropout=0.0)
CFG_B = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
             max_position=32, dropout=0.0)
LR_A, STEPS_A, LR_B = 1e-3, 6, 0.1


def _batch(vocab, b, s, seed):
    rs = np.random.RandomState(seed)
    return {"input_ids": rs.randint(0, vocab, (b, s)).astype(np.int64),
            "labels": rs.randint(0, vocab, (b, s)).astype(np.int64)}


def _world(rank, params_a, params_b):
    import paddle_tpu_torch.optimizer as popt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPT2Config, build_train_step
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.parallel.mesh import local_slice

    out = {}
    # (a) the flat loss, replicated over mp and sp, recompute on
    s = fleet.DistributedStrategy()
    s.recompute = True
    s.hybrid_configs = dict(HYBRID)
    loss_fn, _ = build_train_step(GPT2Config(**CFG_A), device="cpu")
    opt = popt.AdamW(learning_rate=LR_A, device="cpu")
    step, mesh = fleet.build_hybrid_train_step(s, loss_fn, opt)
    params = {k: torch.from_numpy(v) for k, v in params_a.items()}
    state = opt.functional_init(params)
    batch = _batch(CFG_A["vocab_size"], 4, 32, 0)
    losses = []
    for i in range(STEPS_A):
        loss, params, state = step(params, state, batch, None)
        losses.append(float(loss))
    out["a"] = {"losses": losses, "params": params}

    # (b) the hybrid's mesh-aware loss, and the flat loss, at that mesh
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(HYBRID)
    hloss = H.build_hybrid_gpt2_loss(mesh, 1,
                                     vocab_size=CFG_B["vocab_size"])
    opt = popt.SGD(learning_rate=LR_B, device="cpu")
    step, mesh = fleet.build_hybrid_train_step(s, hloss, opt, mesh=mesh)
    glob = H.params_from_gpt2(params_b, CFG_B["num_heads"])
    local = {k: v.clone() for k, v in H.hybrid_local_params(mesh,
                                                            glob).items()}
    gb = _batch(CFG_B["vocab_size"], 4, 16, 1)
    lb = {k: local_slice(torch.from_numpy(v), ("dp", "sp"), mesh.coords,
                         mesh.shape) for k, v in gb.items()}
    loss, grads = step.value_and_grad(local, lb, None)
    out["b_hybrid"] = {"loss": float(loss), "grads": grads}
    state = opt.functional_init(local)
    _, local, _ = step(local, state, lb, None)
    out["b_hybrid"]["params"] = local
    flat_fn, _ = build_train_step(GPT2Config(**CFG_B), device="cpu")
    step, _ = fleet.build_hybrid_train_step(s, flat_fn, opt, mesh=mesh)
    flat = {k: torch.from_numpy(v) for k, v in params_b.items()}
    loss, grads = step.value_and_grad(flat, gb, None)
    out["b_flat"] = {"loss": float(loss), "grads": grads}
    return out


def _ref_params(cfg):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2Config, build_train_step
    paddle.seed(0)
    loss_fn, init_params, _ = build_train_step(GPT2Config(**cfg))
    return loss_fn, {k: np.asarray(v) for k, v in init_params().items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    _, pa = _ref_params(CFG_A)
    _, pb = _ref_params(CFG_B)
    return pa, pb, run_world(_world, N, tmp_path_factory.mktemp("gpt2"),
                             pa, pb)


def test_gpt2_hybrid_dp_mp_sp_trains(results):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import paddle_tpu.optimizer as ropt
    from paddle_tpu.models.gpt2 import GPT2Config, build_train_step
    from paddle_tpu.parallel.api import tp_spec_for
    from paddle_tpu.parallel.mesh import make_mesh, set_mesh

    pa, _, world = results
    loss_fn, _, _ = build_train_step(GPT2Config(**CFG_A), remat=True)
    optimizer = ropt.AdamW(learning_rate=LR_A)
    mesh = make_mesh(dp=2, mp=2, pp=1, sp=2)
    set_mesh(mesh)
    p_sh = {n: NamedSharding(mesh, tp_spec_for(n, v.ndim))
            for n, v in pa.items()}
    b_sh = {k: NamedSharding(mesh, P("dp", "sp"))
            for k in ("input_ids", "labels")}

    def step(params, opt_state, batch, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, key)
        p2, s2 = optimizer.functional_update(params, grads, opt_state)
        return loss, p2, s2

    jitted = jax.jit(step, in_shardings=(p_sh, None, b_sh, None),
                     out_shardings=(None, p_sh, None))
    params = jax.device_put({k: jax.numpy.asarray(v) for k, v in
                             pa.items()}, p_sh)
    opt_state = optimizer.functional_init(params)
    batch = {k: jax.device_put(v.astype(np.int32), b_sh[k])
             for k, v in _batch(CFG_A["vocab_size"], 4, 32, 0).items()}
    losses = []
    for i in range(STEPS_A):
        loss, params, opt_state = jitted(params, opt_state, batch,
                                         jax.random.key(i))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for r in range(N):
        got = world[r]["a"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        for k, v in params.items():
            np.testing.assert_allclose(got["params"][k], np.asarray(v),
                                       rtol=0, atol=2 * LR_A * STEPS_A,
                                       err_msg=k)


def test_gpt2_matches_single_device(results):
    import jax

    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.parallel.mesh import local_slice, mesh_coords

    _, pb, world = results
    loss_fn, _ = _ref_params(CFG_B)
    batch = {k: v.astype(np.int32) for k, v in
             _batch(CFG_B["vocab_size"], 4, 16, 1).items()}
    key = jax.random.key(0)
    l_ref, g_ref = jax.value_and_grad(loss_fn)(
        {k: jax.numpy.asarray(v) for k, v in pb.items()}, batch, key)
    g_ref = {k: np.asarray(v) for k, v in g_ref.items()}
    shape = {"dp": 2, "pp": 1, "mp": 2, "sp": 2}
    g_glob = H.params_from_gpt2(g_ref, CFG_B["num_heads"])
    p_glob = H.params_from_gpt2(pb, CFG_B["num_heads"])
    specs = H.hybrid_param_specs(g_glob)
    for r in range(N):
        coords = mesh_coords(r, shape)
        hyb = world[r]["b_hybrid"]
        np.testing.assert_allclose(hyb["loss"], float(l_ref), rtol=1e-5)
        for k, g in hyb["grads"].items():
            want = local_slice(g_glob[k], specs[k], coords, shape).numpy()
            scale = max(np.abs(g_glob[k].numpy()).max(), 1e-30)
            assert np.abs(g - want).max() <= 1e-4 * scale, (r, k)
            moved = local_slice(p_glob[k] - LR_B * g_glob[k], specs[k],
                                coords, shape).numpy()
            np.testing.assert_allclose(hyb["params"][k], moved, rtol=0,
                                       atol=1e-6, err_msg=k)
        flat = world[r]["b_flat"]
        np.testing.assert_allclose(flat["loss"], float(l_ref), rtol=1e-5)
        for k, g in flat["grads"].items():
            scale = max(np.abs(g_ref[k]).max(), 1e-30)
            assert np.abs(g - g_ref[k]).max() <= 1e-4 * scale, (r, k)
