"""CPU twins of the port's 4-D hybrid GPT-2
(`paddle_tpu_torch.models.gpt2_hybrid`) against the JAX package's
`reference_loss` and AdamW — the cases of `test_hybrid_gpt2_4d.py` and
`test_distributed.py::test_ulysses_mode_in_hybrid_gpt2`.

The reference's parameters (`init_hybrid_gpt2_params(jax.random.key(0),
vocab 129, hidden 128, 4 heads, 4 layers, pp 2, mp 2)`: the vocab padded
to 130) are carried across as numpy; the port runs them in one 16-rank
gloo world at dp 2 x pp 2 x mp 2 x sp 2 (and dp 1 on ranks 0-7 for the
Ulysses case), B 8 x S 256 (S_local 128, D 32: the ring's flash impl,
K4/K6/K7/K8's plain versions on the CPU). Every rank returns its loss and
its local gradients after the dp/sp reduction, which are held to the
slices of jax.grad(reference_loss) that rank holds.

Tolerances: the loss within 1e-5 relative (the reference test allows
1e-3), every gradient within 1e-4 of its leaf's largest magnitude (5e-3
there). Training: four AdamW steps (lr 1e-3, no decay) with ZeRO-1 slots
against the reference's `AdamW.functional_update` on the single-device
gradients: losses within 1e-4 relative, parameters within 2 * lr * steps
(a near-zero gradient moves a weight by about +-lr whatever its
rounding), and each leaf's update within
UPDATE_REL of the reference's, ||p - p_ref|| / ||p_ref - p0|| (a leaf
left as it was reads 1; ZeRO slices never gathered back read about 0.7;
a sound run reads about 1e-3, on the k biases, whose exact gradient is 0).
"""
import functools

import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)

VOCAB = 129
STEPS = 4
LR = 1e-3
UPDATE_REL = 1e-2
CONFIGS = (("ring", None, "gpipe", 1), ("ulysses", "ulysses", "gpipe", 1),
           ("zigzag", "zigzag", "gpipe", 1),
           ("interleaved", None, "interleaved", 2),
           ("chunked", "chunked", "gpipe", 1))


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, VOCAB, (8, 256)).astype(np.int32),
            rs.randint(0, VOCAB, (8, 256)).astype(np.int32))


def _local_batch(mesh, ids, labels):
    from paddle_tpu_torch.parallel.mesh import local_slice
    spec = ("dp", "sp")
    return {"input_ids": local_slice(torch.from_numpy(ids).long(), spec,
                                     mesh.coords, mesh.shape),
            "labels": local_slice(torch.from_numpy(labels).long(), spec,
                                  mesh.coords, mesh.shape)}


def _world(rank, params_np):
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.ring_attention import (last_impl_used,
                                                          zigzag_order)

    mesh = make_mesh(dp=2, mp=2, pp=2, sp=2)
    mesh8 = make_mesh(dp=1, mp=2, pp=2, sp=2, ranks=range(8))
    ids, labels = _batch()
    out = {}

    def run(name, m, impl, sched, nv, ids, labels):
        params = H.hybrid_params_from_reference(params_np, m, sched, nv,
                                                device="cpu")
        if impl == "zigzag":
            perm = zigzag_order(m.size("sp"), ids.shape[1])
            ids, labels = ids[:, perm], labels[:, perm]
        loss_fn = H.build_hybrid_gpt2_loss(m, 2, ring_impl=impl,
                                           vocab_size=VOCAB,
                                           pp_schedule=sched,
                                           num_virtual=nv)
        loss = loss_fn(params, _local_batch(m, ids, labels))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        H.reduce_hybrid_gradients(grads, m)
        out[name] = {"loss": loss.item(), "grads": grads,
                     "impl": last_impl_used()}

    for name, impl, sched, nv in CONFIGS:
        run(name, mesh, impl, sched, nv, ids, labels)
    if mesh8.member:
        run("ulysses_dp1", mesh8, "ulysses", "gpipe", 1, ids[:4],
            labels[:4])

    # four AdamW steps with ZeRO-1 slots over dp
    params = H.hybrid_params_from_reference(params_np, mesh, device="cpu")
    loss_fn = H.build_hybrid_gpt2_loss(mesh, 2, vocab_size=VOCAB)
    opt = AdamW(LR, weight_decay=0.0, device="cpu")
    specs, slot_specs = H.hybrid_shardings(
        mesh, params, {"slots": {n: {"moment1": 0, "moment2": 0}
                                 for n in params}})
    state = H.zero_init(opt, params, mesh, slot_specs)
    batch = _local_batch(mesh, ids, labels)
    losses = []
    for _ in range(STEPS):
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        H.reduce_hybrid_gradients(grads, mesh)
        H.zero_update(opt, params, grads, state, mesh, slot_specs)
        losses.append(loss.item())
    out["train"] = {"losses": losses, "params": params,
                    "slot_shapes": {n: tuple(s["moment1"].shape)
                                    for n, s in state["slots"].items()},
                    "slot_specs": {n: tuple(s["moment1"]) for n, s in
                                   slot_specs["slots"].items()},
                    "coords": mesh.coords}
    return out


def _reference():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models.gpt2_hybrid import (init_hybrid_gpt2_params,
                                               reference_loss)
    from paddle_tpu import optimizer as opt_mod

    params = init_hybrid_gpt2_params(
        jax.random.key(0), vocab_size=VOCAB, hidden=128, num_heads=4,
        num_layers=4, pp=2, max_position=256, mp=2)
    ids, labels = _batch()
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        reference_loss, vocab_size=VOCAB)))
    loss, grads = ref_fn(params, batch)
    b4 = {k: v[:4] for k, v in batch.items()}
    loss4, grads4 = ref_fn(params, b4)
    optimizer = opt_mod.AdamW(learning_rate=LR, weight_decay=0.0)
    state = optimizer.functional_init(params)
    p, losses = params, []
    for _ in range(STEPS):
        l, g = ref_fn(p, batch)
        p, state = optimizer.functional_update(p, g, state)
        losses.append(float(l))
    np_ = {k: np.asarray(v) for k, v in params.items()}
    return {"params": np_, "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "loss4": float(loss4),
            "grads4": {k: np.asarray(v) for k, v in grads4.items()},
            "losses": losses, "trained": {k: np.asarray(v)
                                          for k, v in p.items()}}


def update_error(got, want, init):
    """How far a leaf's update misses the reference's: ||(got - init) -
    (want - init)|| / ||want - init||. A leaf left as it was reads 1, a
    leaf half of which was updated about 0.7."""
    moved = np.linalg.norm((want - init).ravel())
    return np.linalg.norm((got - want).ravel()) / max(moved, 1e-30)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ref = _reference()
    port = run_world(_world, 16, tmp_path_factory.mktemp("hybrid"),
                     ref["params"])
    return ref, port


def _local(mesh_shape, coords, glob, sched="gpipe", nv=1):
    """The slices of global reference arrays a rank holds."""
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.parallel.mesh import Mesh

    class _M(Mesh):
        def __init__(self):
            self.shape, self.coords = dict(mesh_shape), coords
            self.axis_names = tuple(mesh_shape)
            self.member = True

    return {k: v.numpy() for k, v in H.hybrid_local_params(
        _M(), {k: torch.from_numpy(v) for k, v in glob.items()}, sched,
        nv).items()}


SHAPE16 = {"dp": 2, "pp": 2, "mp": 2, "sp": 2}
SHAPE8 = {"dp": 1, "pp": 2, "mp": 2, "sp": 2}


def _coords(rank, shape):
    from paddle_tpu_torch.parallel.mesh import mesh_coords
    return mesh_coords(rank, shape)


def _check(got, ref_loss, ref_grads, shape, nranks, sched="gpipe", nv=1,
           impl="flash"):
    for r in range(nranks):
        g = got[r]
        assert abs(g["loss"] - ref_loss) <= 1e-5 * abs(ref_loss), \
            (r, g["loss"], ref_loss)
        if impl:
            assert g["impl"] == impl, g["impl"]
        want = _local(shape, _coords(r, shape), ref_grads, sched, nv)
        for k, w in want.items():
            err = np.abs(g["grads"][k] - w).max()
            assert err <= 1e-4 * np.abs(ref_grads[k]).max(), (r, k, err)


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_4d_parity_loss_and_grads(both, name):
    """dp 2 x pp 2 x mp 2 x sp 2, vocab 129 padded to 130: loss and every
    gradient of every rank against jax.grad(reference_loss); the ring
    runs its flash impl (last_impl_used), Ulysses the flash_attention
    route, zigzag the balanced ring on the zigzag-permuted batch, the
    interleaved schedule V 2 chunks a rank."""
    ref, port = both
    sched, nv = ("interleaved", 2) if name == "interleaved" else ("gpipe", 1)
    impl = {"ring": "flash", "interleaved": "flash",
            "chunked": "chunked"}.get(name)
    _check({r: port[r][name] for r in port}, ref["loss"], ref["grads"],
           SHAPE16, 16, sched, nv, impl)


def test_ulysses_mode_in_hybrid_gpt2(both):
    """The reference test's mesh (dp 1 x mp 2 x pp 2 x sp 2) and batch
    (4 x 256) with ring_impl="ulysses"."""
    ref, port = both
    _check({r: port[r]["ulysses_dp1"] for r in range(8)}, ref["loss4"],
           ref["grads4"], SHAPE8, 8, impl=None)


def test_training_steps_with_zero_slots(both):
    """Four AdamW steps: the losses and the trained parameters against
    the reference's single-device steps; the ZeRO-1 slots of replicated
    leaves are split over dp (wpe: 256 rows -> 128 a rank), the
    vocab-parallel wte's follow mp."""
    ref, port = both
    for r in range(16):
        tr = port[r]["train"]
        np.testing.assert_allclose(tr["losses"], ref["losses"], rtol=1e-4)
        assert tr["losses"][-1] < tr["losses"][0]
        want = _local(SHAPE16, tr["coords"], ref["trained"])
        init = _local(SHAPE16, tr["coords"], ref["params"])
        for k, w in want.items():
            assert np.abs(tr["params"][k] - w).max() <= 2 * LR * STEPS, k
            err = update_error(tr["params"][k], w, init[k])
            assert err <= UPDATE_REL, (r, k, err)
        assert tr["slot_specs"]["wpe"] == ("dp", None)
        assert tr["slot_shapes"]["wpe"] == (128, 128)
        assert tr["slot_specs"]["wte"] == ("mp", None)
        assert tr["slot_shapes"]["wte"] == (65, 128)
