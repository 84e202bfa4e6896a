"""CPU twins of the port's MoE (`paddle_tpu_torch.parallel.moe`) against
the JAX package's (`paddle_tpu.parallel.moe`) — the cases of
`test_moe.py`.

Gating and the layer run in this process on both sides from the same
numpy inputs (the reference's `init_moe_params` draws, carried across);
the expert-parallel case runs the port in a 4-rank gloo world (experts
split over `ep`, tokens dispatched by all-to-all) against the reference's
layer on one device, forward and gradients. Tolerances: combine weights,
outputs and the aux loss within rtol 1e-5 / atol 1e-6 (dispatch masks
exact), the expert-parallel output within rtol 2e-5 / atol 2e-6 (its
expert products run on other shapes); gradients within 1e-5 of each
leaf's largest magnitude.
"""
import numpy as np
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)


def _ref_params(seed, d_model, d_hidden, e):
    import jax

    from paddle_tpu.parallel.moe import init_moe_params
    p = init_moe_params(jax.random.key(seed), d_model=d_model,
                        d_hidden=d_hidden, num_experts=e)
    return {k: np.asarray(v) for k, v in p.items()}


def _t(params):
    return {k: torch.from_numpy(v).clone().requires_grad_(True)
            for k, v in params.items()}


def test_top2_gating_matches_reference():
    """Combine weights, dispatch mask and aux loss on random logits
    (every token within capacity): the rows' weights sum to one."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.moe import top2_gating as ref_gating
    from paddle_tpu_torch.parallel.moe import top2_gating
    logits = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    c_r, d_r, a_r = ref_gating(jnp.asarray(logits), capacity=16)
    c, d, a = top2_gating(torch.from_numpy(logits), capacity=16)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_allclose(float(a), float(a_r), rtol=1e-5)
    np.testing.assert_allclose(c.sum((1, 2)).numpy(), np.ones(16),
                               rtol=1e-5)
    assert float(a) > 0


def test_capacity_drops_tokens():
    """Every token prefers expert 0; capacity 2 keeps two first choices,
    as the reference does."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.moe import top2_gating as ref_gating
    from paddle_tpu_torch.parallel.moe import top2_gating
    logits = np.tile([5.0, 0.0, 0.0, 0.0], (8, 1)).astype(np.float32)
    c, d, _ = top2_gating(torch.from_numpy(logits), capacity=2)
    c_r, d_r, _ = ref_gating(jnp.asarray(logits), capacity=2)
    assert int(d[:, 0, :].sum()) == 2
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_r), rtol=1e-5,
                               atol=1e-6)


def _ref_value_and_grad(params, x):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.moe import moe_layer_apply

    def loss(params, x):
        out, aux = moe_layer_apply(params, x)
        return jnp.mean(out ** 2) + 0.01 * aux, out

    (l, out), g = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return float(l), np.asarray(out), {k: np.asarray(v) for k, v in
                                       g.items()}


def _check_grads(got, want):
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                      1e-30), k


def test_forward_shape_and_grad():
    """The layer (16 -> 32, 4 experts, 32 tokens): output, loss and every
    gradient against the reference's."""
    from paddle_tpu_torch.parallel.moe import moe_layer_apply
    params = _ref_params(0, 16, 32, 4)
    x = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    l_r, out_r, g_r = _ref_value_and_grad(params, x)
    p = _t(params)
    out, aux = moe_layer_apply(p, torch.from_numpy(x))
    loss = torch.mean(out ** 2) + 0.01 * aux
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    np.testing.assert_allclose(out.detach().numpy(), out_r, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(loss.item(), l_r, rtol=1e-5)
    assert grads["w1"].shape == (4, 16, 32)
    assert float(grads["gate"].abs().sum()) > 0
    _check_grads({k: v.numpy() for k, v in grads.items()}, g_r)


def _ep_world(rank, params, x):
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.parallel.moe import (moe_layer_apply,
                                               moe_local_params,
                                               moe_shardings)
    mesh = Mesh({"ep": 4}, range(4))
    p = {k: v.clone().requires_grad_(True) for k, v in moe_local_params(
        mesh, {k: torch.from_numpy(v) for k, v in params.items()}).items()}
    out, aux = moe_layer_apply(p, torch.from_numpy(x), mesh=mesh)
    loss = torch.mean(out ** 2) + 0.01 * aux
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    return {"out": out, "loss": loss.item(), "grads": grads,
            "w1_shape": tuple(p["w1"].shape),
            "specs": moe_shardings(mesh, params)}


def test_expert_parallel_matches_replicated(tmp_path):
    """ep 4 (one expert a rank, 16 tokens, 4 a rank through the
    all-to-all): every rank's output equals the reference's replicated
    layer, and its gradients are the slices of the reference's."""
    params = _ref_params(1, 8, 16, 4)
    x = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    l_r, out_r, g_r = _ref_value_and_grad(params, x)
    res = run_world(_ep_world, 4, tmp_path, params, x)
    for r in range(4):
        got = res[r]
        np.testing.assert_allclose(got["out"], out_r, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got["loss"], l_r, rtol=1e-5)
        assert got["w1_shape"] == (1, 8, 16)
        assert "ep" in got["specs"]["w1"]
        want = {k: (v if k == "gate" else v[r:r + 1]) for k, v in g_r.items()}
        for k, w in want.items():
            assert np.abs(got["grads"][k] - w).max() <= \
                1e-5 * np.abs(g_r[k]).max(), k
