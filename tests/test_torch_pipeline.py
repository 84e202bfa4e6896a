"""CPU twins of the port's pipeline schedules (`paddle_tpu_torch.parallel
.pipeline`) and the pipelined GPT-2 (`paddle_tpu_torch.models
.gpt2_pipeline`) against the JAX package's — the cases of
`test_pipeline.py` and `test_gpt2_pipeline.py`.

The port runs in one 4-rank gloo world (pp 4, and pp 2 on ranks 0-1);
the reference runs in this process on the virtual devices of
tests/conftest.py. Inputs and weights are the reference tests' draws (the
GPT-2 weights are the reference's `init()`, carried across as numpy), so
each side computes the same function. Tolerances: forward outputs
rtol 1e-5 / atol 1e-6 of the reference's pipeline; losses within 1e-5
relative; gradients within 1e-4 of each leaf's largest magnitude;
training runs hold the loss trajectory to the reference's within 1e-4
relative. The GPT-2 blocks (hidden 32, 2 heads: head dim 16) take the
port's dense attention route.
"""
import numpy as np
import pytest
import torch

from torch_dist_util import run_world

torch.set_num_threads(1)


def _tanh_stage(w, a):
    return torch.tanh(a @ w)


def _mse(out, labels):
    return torch.mean((out - labels) ** 2)


def _sgd_losses(loss_fn, w_local, x, y, steps, lr=0.5):
    w = w_local.clone().requires_grad_(True)
    losses = []
    for _ in range(steps):
        loss = loss_fn(w, x, y)
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            w -= lr * g
        losses.append(loss.item())
    return losses


def _world(rank, data):
    from paddle_tpu_torch.models.gpt2 import GPT2Config
    from paddle_tpu_torch.models.gpt2_pipeline import (build_pp_train_step,
                                                       pp_stage_params)
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.pipeline import (
        make_pipeline_loss, pipeline_apply, pipeline_apply_interleaved,
        stage_slice)

    mesh4 = make_mesh(dp=1, pp=4)
    mesh2 = make_mesh(dp=1, pp=2, ranks=range(2))
    T = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in data.items()}
    out = {}
    # GPipe forward, 4 stages
    w = stage_slice({"w": T["fwd_ws"]}, mesh4)["w"]
    out["fwd"] = pipeline_apply(_tanh_stage, w[0], T["fwd_x"], "pp", mesh4)
    # GPipe training, 4 stages
    loss_fn = make_pipeline_loss(_tanh_stage, _mse, mesh4, 4)
    out["train"] = _sgd_losses(
        loss_fn, stage_slice({"w": T["tr_ws"]}, mesh4)["w"], T["tr_x"],
        T["tr_y"], 15)
    # interleaved forward (S 4, V 2) and the same 8 layers as GPipe stages
    wi = stage_slice({"w": T["il_ws"]}, mesh4, "interleaved", 2)["w"]
    out["il_fwd"] = pipeline_apply_interleaved(
        _tanh_stage, wi[:, 0], T["il_x"], "pp", mesh4)

    def stage2(w2, a):
        for j in range(w2.shape[0]):
            a = _tanh_stage(w2[j], a)
        return a

    wg = T["il_ws"].reshape(4, 2, *T["il_ws"].shape[1:])
    out["il_gpipe"] = pipeline_apply(
        stage2, stage_slice({"w": wg}, mesh4)["w"][0], T["il_x"], "pp", mesh4)
    # the interleaved schedule refuses M % S != 0
    try:
        pipeline_apply_interleaved(_tanh_stage, wi[:, 0], T["il_x"][:6],
                                   "pp", mesh4)
        out["il_refuses"] = ""
    except ValueError as e:
        out["il_refuses"] = str(e)
    if mesh2.member:
        # interleaved gradients and training (S 2, V 2)
        loss_fn = make_pipeline_loss(_tanh_stage, _mse, mesh2, 4,
                                     schedule="interleaved", num_virtual=2)
        wl = stage_slice({"w": T["g_ws"]}, mesh2, "interleaved",
                         2)["w"].clone().requires_grad_(True)
        loss = loss_fn(wl, T["g_x"], T["g_y"])
        out["il_grad"] = (loss.item(), torch.autograd.grad(loss, [wl])[0])
        out["il_train"] = _sgd_losses(
            loss_fn, stage_slice({"w": T["it_ws"]}, mesh2, "interleaved",
                                 2)["w"], T["it_x"], T["it_y"], 15)
        # GPT-2 pp 2: GPipe and interleaved, loss and gradients
        cfg = GPT2Config(vocab_size=128, hidden_size=32, num_layers=4,
                         num_heads=2, max_position=32, dropout=0.0)
        for sched, nv in (("gpipe", 1), ("interleaved", 2)):
            loss_pp, _init = build_pp_train_step(
                cfg, mesh2, num_microbatches=2, schedule=sched,
                num_virtual=nv, device="cpu")
            st = {k: v.clone().requires_grad_(True) for k, v in
                  pp_stage_params(cfg, {k: torch.from_numpy(v) for k, v in
                                        data["gpt_stacked"].items()},
                                  mesh2, sched, nv).items()}
            ot = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in data["gpt_other"].items()}
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data["gpt_batch"].items()}
            loss = loss_pp(st, ot, batch)
            names = list(st) + list(ot)
            grads = torch.autograd.grad(loss, [st[k] for k in st]
                                        + [ot[k] for k in ot])
            out[f"gpt/{sched}"] = (loss.item(), dict(zip(names, grads)))
    return out


def _data():
    d = {}
    rs = np.random.RandomState(0)
    d["fwd_ws"] = rs.rand(4, 16, 16).astype(np.float32) * 0.3
    d["fwd_x"] = rs.rand(8, 2, 16).astype(np.float32)
    rs = np.random.RandomState(1)
    d["tr_ws"] = (rs.rand(4, 8, 8).astype(np.float32) - 0.5) * 0.5
    d["tr_x"] = rs.rand(16, 8).astype(np.float32)
    d["tr_y"] = rs.rand(16, 8).astype(np.float32)
    rs = np.random.RandomState(3)
    d["il_ws"] = (rs.rand(8, 16, 16).astype(np.float32) - 0.5) * 0.5
    d["il_x"] = rs.rand(8, 2, 16).astype(np.float32)
    rs = np.random.RandomState(4)
    d["g_ws"] = (rs.rand(4, 8, 8).astype(np.float32) - 0.5) * 0.5
    d["g_x"] = rs.rand(8, 8).astype(np.float32)
    d["g_y"] = rs.rand(8, 8).astype(np.float32)
    rs = np.random.RandomState(5)
    d["it_ws"] = (rs.rand(4, 8, 8).astype(np.float32) - 0.5) * 0.5
    d["it_x"] = rs.rand(16, 8).astype(np.float32)
    d["it_y"] = rs.rand(16, 8).astype(np.float32)
    return d


def _gpt_reference():
    """The reference's pipelined GPT-2 init, batch, loss and gradients
    (its plain functional loss: `test_gpt2_pipeline.py`'s oracle)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models.gpt2 import GPT2Config, build_train_step
    from paddle_tpu.models.gpt2_pipeline import (_merge_block_params,
                                                 build_pp_train_step)
    from jax.sharding import Mesh

    cfg = GPT2Config(vocab_size=128, hidden_size=32, num_layers=4,
                     num_heads=2, max_position=32, dropout=0.0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    _loss, init = build_pp_train_step(cfg, mesh, num_microbatches=2)
    stacked, other = init()
    batch = {"input_ids": jnp.asarray(np.random.RandomState(4).randint(
        0, 128, (4, 16)).astype(np.int32)),
        "labels": jnp.asarray(np.random.RandomState(5).randint(
            0, 128, (4, 16)).astype(np.int32))}
    loss_ref, _, _ = build_train_step(cfg)

    def ref(stacked, other):
        return loss_ref(_merge_block_params(stacked, other), batch,
                        jax.random.key(0))

    l, (gs, go) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1)))(
        stacked, other)
    npd = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return {"stacked": npd(stacked), "other": npd(other),
            "batch": npd(batch), "loss": float(l),
            "grads": {**npd(gs), **npd(go)}}


def _reference(d):
    """The reference's schedules on the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.parallel.pipeline import (make_pipeline_loss,
                                              pipeline_apply,
                                              pipeline_apply_interleaved)

    def mesh_pp(s):
        return Mesh(np.array(jax.devices()[:s]), ("pp",))

    def stage(w, a):
        return jnp.tanh(a @ w)

    def mse(out, labels):
        return jnp.mean((out - labels) ** 2)

    r = {}
    m4 = mesh_pp(4)
    r["fwd"] = np.asarray(shard_map(
        lambda w, x: pipeline_apply(stage, w[0], x, "pp"), mesh=m4,
        in_specs=(P("pp"), P()), out_specs=P(), check_rep=False)(
        jnp.asarray(d["fwd_ws"]), jnp.asarray(d["fwd_x"])))
    wr = jnp.asarray(d["il_ws"]).reshape(2, 4, 16, 16)
    r["il_fwd"] = np.asarray(shard_map(
        lambda w, x: pipeline_apply_interleaved(stage, w[:, 0], x, "pp"),
        mesh=m4, in_specs=(P(None, "pp"), P()), out_specs=P(),
        check_rep=False)(wr, jnp.asarray(d["il_x"])))

    def sgd(loss_fn, ws, x, y, steps=15):
        params = jnp.asarray(ws)

        @jax.jit
        def step(params):
            l, g = jax.value_and_grad(loss_fn)(params, jnp.asarray(x),
                                               jnp.asarray(y))
            return l, params - 0.5 * g

        out = []
        for _ in range(steps):
            l, params = step(params)
            out.append(float(l))
        return out

    r["train"] = sgd(make_pipeline_loss(stage, mse, m4, 4), d["tr_ws"],
                     d["tr_x"], d["tr_y"])
    m2 = mesh_pp(2)
    il = make_pipeline_loss(stage, mse, m2, 4, schedule="interleaved",
                            num_virtual=2)
    r["il_grad"] = jax.jit(jax.value_and_grad(il))(
        jnp.asarray(d["g_ws"]), jnp.asarray(d["g_x"]), jnp.asarray(d["g_y"]))
    r["il_train"] = sgd(il, d["it_ws"], d["it_x"], d["it_y"])
    return r


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = _data()
    gpt = _gpt_reference()
    d.update(gpt_stacked=gpt["stacked"], gpt_other=gpt["other"],
             gpt_batch=gpt["batch"])
    port = run_world(_world, 4, tmp_path_factory.mktemp("pipe"), d)
    return d, _reference(d), gpt, port


def test_forward_matches_sequential(both):
    d, ref, _gpt, port = both
    seq = d["fwd_x"].copy()
    for i in range(4):
        seq = np.tanh(seq @ d["fwd_ws"][i])
    for r in range(4):
        np.testing.assert_allclose(port[r]["fwd"], ref["fwd"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(port[r]["fwd"], seq, rtol=1e-4, atol=1e-5)


def test_pipeline_trains(both):
    _d, ref, _gpt, port = both
    for r in range(4):
        losses = port[r]["train"]
        np.testing.assert_allclose(losses, ref["train"], rtol=1e-4)
        assert losses[-1] < losses[0] * 0.9 and np.isfinite(losses[-1])


def test_interleaved_forward_matches_sequential_and_gpipe(both):
    d, ref, _gpt, port = both
    seq = d["il_x"].copy()
    for i in range(8):
        seq = np.tanh(seq @ d["il_ws"][i])
    for r in range(4):
        np.testing.assert_allclose(port[r]["il_fwd"], ref["il_fwd"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port[r]["il_fwd"], seq, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(port[r]["il_fwd"], port[r]["il_gpipe"],
                                   rtol=1e-5, atol=1e-6)


def test_interleaved_grads_match_reference(both):
    """S 2, V 2: each rank's gradient of its chunks [V, 1, d, d] against
    the reference's gradient of those chunks (group l*S + r)."""
    _d, ref, _gpt, port = both
    l_ref, g_ref = ref["il_grad"]
    g_ref = np.asarray(g_ref).reshape(2, 2, 8, 8)
    for r in range(2):
        loss, g = port[r]["il_grad"]
        assert abs(loss - float(l_ref)) <= 1e-5 * abs(float(l_ref))
        want = g_ref[:, r:r + 1]
        assert np.abs(g - want).max() <= 1e-4 * np.abs(g_ref).max()


def test_interleaved_trains(both):
    _d, ref, _gpt, port = both
    for r in range(2):
        losses = port[r]["il_train"]
        np.testing.assert_allclose(losses, ref["il_train"], rtol=1e-4)
        assert losses[-1] < losses[0] * 0.9 and np.isfinite(losses[-1])


def test_rejects_indivisible_microbatches(both):
    _d, _ref, _gpt, port = both
    for r in range(4):
        assert "divisible" in port[r]["il_refuses"]


def test_bubble_fraction_accounting():
    from paddle_tpu.parallel.pipeline import bubble_fraction as ref_bf
    from paddle_tpu_torch.parallel.pipeline import bubble_fraction
    assert abs(bubble_fraction("gpipe", 2, 4) - 1 / 5) < 1e-9
    assert abs(bubble_fraction("interleaved", 2, 4, 2) - 1 / 9) < 1e-9
    for s in (2, 4, 8):
        for m in (4, 8, 16):
            for v in (2, 3, 4):
                assert bubble_fraction("interleaved", s, m, v) \
                    < bubble_fraction("gpipe", s, m)
                assert bubble_fraction("interleaved", s, m, v) == \
                    ref_bf("interleaved", s, m, v)
    with pytest.raises(ValueError):
        bubble_fraction("1f1b", 2, 4)


@pytest.mark.parametrize("sched", ["gpipe", "interleaved"])
def test_gpt2_pp_matches_reference(both, sched):
    """GPT-2 (vocab 128, hidden 32, 4 layers) over pp 2: the loss and
    every gradient of each rank against jax.grad of the reference's plain
    functional loss on the reference's init (the interleaved schedule's
    rank r holds chunks {l*2 + r})."""
    _d, _ref, gpt, port = both
    from paddle_tpu_torch.parallel.mesh import local_slice, mesh_coords
    for r in range(2):
        loss, grads = port[r][f"gpt/{sched}"]
        assert abs(loss - gpt["loss"]) <= 1e-5 * abs(gpt["loss"])
        coords = mesh_coords(r, {"dp": 1, "pp": 2, "mp": 1, "sp": 1})
        shape = {"dp": 1, "pp": 2, "mp": 1, "sp": 1}
        for k, g in grads.items():
            full = gpt["grads"][k]
            if k in gpt["stacked"]:
                t = torch.from_numpy(full)
                if sched == "interleaved":
                    t = t.reshape((2, 2, 1) + tuple(t.shape[1:]))
                    want = local_slice(t, (None, "pp"), coords, shape)
                else:
                    want = local_slice(t, ("pp",), coords, shape)
                want = want.numpy()
            else:
                want = full
            assert np.abs(g - want).max() <= 1e-4 * np.abs(full).max(), k


def test_gpt2_pp_trains(both, tmp_path):
    """Eight SGD steps of the GPipe GPT-2 over pp 2 lower the loss."""
    _d, _ref, gpt, _port = both
    res = run_world(_train_world, 2, tmp_path, gpt["stacked"], gpt["other"],
                    gpt["batch"])
    for r in range(2):
        losses = res[r]
        assert losses[-1] < losses[0] and np.isfinite(losses[-1])
    assert res[0] == res[1]


def _train_world(rank, stacked, other, batch):
    from paddle_tpu_torch.models.gpt2 import GPT2Config
    from paddle_tpu_torch.models.gpt2_pipeline import (build_pp_train_step,
                                                       pp_stage_params)
    from paddle_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, pp=2)
    cfg = GPT2Config(vocab_size=128, hidden_size=32, num_layers=4,
                     num_heads=2, max_position=32, dropout=0.0)
    loss_pp, _ = build_pp_train_step(cfg, mesh, 2, device="cpu")
    st = {k: v.clone().requires_grad_(True) for k, v in pp_stage_params(
        cfg, {k: torch.from_numpy(v) for k, v in stacked.items()},
        mesh).items()}
    ot = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in other.items()}
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    leaves = list(st.values()) + list(ot.values())
    losses = []
    for _ in range(8):
        loss = loss_pp(st, ot, b)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= 0.1 * g
        losses.append(loss.item())
    return losses
