"""CPU twins of the port's optimizers, schedulers and gradient clipping
(`paddle_tpu_torch.optimizer`, `paddle_tpu_torch.nn.clip`) against the
JAX package's — the twin of `test_optimizer.py`.

Every rule runs step by step on the same numpy leaves and gradients
through the reference's `functional_update` and the port's: after each
step every parameter and slot within rtol 1e-5 / atol 1e-6 (float32;
the port updates in place, in the same order of operations), with a
float learning rate, a scheduler's `lr_at(t)`, an explicit `lr=`, a
coupled decay and a `wd_mask`. Every scheduler's value and `lr_at` over
20 steps equal the reference's to 1e-12 (both run the same Python float
arithmetic). The stateful API (`parameters=`, `step`, `minimize`,
`clear_grad`, regularizers, clipping, `state_dict`) runs the reference
test's cases on both packages, within 1e-5.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RULES = {
    "SGD": {"learning_rate": 0.1},
    "Momentum": {"learning_rate": 0.1, "momentum": 0.9},
    "Momentum_nesterov": {"learning_rate": 0.1, "momentum": 0.9,
                          "use_nesterov": True},
    "Adam": {"learning_rate": 0.01},
    "AdamW": {"learning_rate": 0.01, "weight_decay": 0.05},
    "Adamax": {"learning_rate": 0.01},
    "Adagrad": {"learning_rate": 0.5},
    "Adadelta": {"learning_rate": 1.0},
    "RMSProp": {"learning_rate": 0.01},
    "RMSProp_centered": {"learning_rate": 0.01, "momentum": 0.5,
                         "centered": True},
    "Lamb": {"learning_rate": 0.01, "lamb_weight_decay": 0.02},
    "Lars": {"learning_rate": 0.1, "momentum": 0.9, "lars_coeff": 0.01},
    "Adam_coupled_decay": {"learning_rate": 0.01, "weight_decay": 0.05},
}


def _make(mod, name, extra=None, **dev):
    cls = getattr(mod, name.split("_")[0])
    return cls(**{**RULES[name], **(extra or {})}, **dev)


def _leaves():
    rs = np.random.RandomState(0)
    return {"w": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(3).astype(np.float32),
            "z": np.zeros(5, np.float32)}


def _grads(step):
    rs = np.random.RandomState(100 + step)
    g = {"w": rs.randn(4, 3).astype(np.float32),
         "b": rs.randn(3).astype(np.float32),
         "z": rs.randn(5).astype(np.float32)}
    if step == 1:
        g["z"][:] = 0.0  # a zero gradient (Lamb's / Lars' norm guards)
    return g


def _twin(name, steps=5, ref_extra=None, port_extra=None, lr=None,
          wd_mask=None):
    import jax.numpy as jnp

    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt

    ro = _make(ropt, name, ref_extra)
    po = _make(popt, name, port_extra, device="cpu")
    rp = {k: jnp.asarray(v) for k, v in _leaves().items()}
    pp = {k: torch.from_numpy(v) for k, v in _leaves().items()}
    rs, ps = ro.functional_init(rp), po.functional_init(pp)
    for i in range(steps):
        g = _grads(i)
        rp, rs = ro.functional_update(rp, {k: jnp.asarray(v)
                                           for k, v in g.items()}, rs,
                                      lr=lr, wd_mask=wd_mask)
        pp, ps = po.functional_update(pp, {k: torch.from_numpy(v)
                                           for k, v in g.items()}, ps,
                                      lr=lr, wd_mask=wd_mask)
        assert ps["t"] == int(rs["t"]) == i + 1
        for k in rp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} step {i} {k}")
            for slot, v in rs["slots"][k].items():
                np.testing.assert_allclose(
                    ps["slots"][k][slot].numpy(), np.asarray(v), rtol=1e-5,
                    atol=1e-6, err_msg=f"{name} step {i} {k}.{slot}")


@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_reference(name):
    if name == "Adam_coupled_decay":
        import paddle_tpu as paddle
        import paddle_tpu_torch.optimizer as popt
        _twin(name, ref_extra={"weight_decay": paddle.L2Decay(0.05)},
              port_extra={"weight_decay": popt.L2Decay(0.05)})
    else:
        _twin(name)


@pytest.mark.parametrize("name", ["SGD", "Adam", "Lamb"])
def test_rule_with_scheduler(name):
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    _twin(name, ref_extra={"learning_rate": ropt.lr.StepDecay(
        0.1, step_size=2, gamma=0.5)}, port_extra={
        "learning_rate": popt.lr.StepDecay(0.1, step_size=2, gamma=0.5)})


def test_explicit_lr_and_wd_mask():
    _twin("AdamW", lr=0.003, wd_mask={"w": True, "b": False, "z": True})
    _twin("Adam_coupled_decay", lr=0.02,
          wd_mask={"w": False, "b": True, "z": True})


def test_single_tensor_leaf():
    import jax.numpy as jnp

    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    w = _leaves()["w"]
    ro, po = ropt.Momentum(0.1), popt.Momentum(0.1, device="cpu")
    rp, pp = jnp.asarray(w), torch.from_numpy(w.copy())
    rs, ps = ro.functional_init(rp), po.functional_init(pp)
    for i in range(3):
        g = _grads(i)["w"]
        rp, rs = ro.functional_update(rp, jnp.asarray(g), rs)
        pp, ps = po.functional_update(pp, torch.from_numpy(g), ps)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=1e-5)
    np.testing.assert_allclose(ps["slots"]["velocity"].numpy(),
                               np.asarray(rs["slots"]["velocity"]),
                               rtol=1e-5)


SCHEDULERS = {
    "NoamDecay": ((), {"d_model": 512, "warmup_steps": 10,
                       "learning_rate": 1.0}),
    "PiecewiseDecay": (([2, 4], [1.0, 0.5, 0.1]), {}),
    "NaturalExpDecay": ((0.1, 0.3), {}),
    "ExponentialDecay": ((0.1, 0.9), {}),
    "InverseTimeDecay": ((0.1, 0.5), {}),
    "PolynomialDecay": ((0.1,), {"decay_steps": 7, "end_lr": 0.01,
                                 "power": 2.0}),
    "PolynomialDecay_cycle": ((0.1,), {"decay_steps": 7, "cycle": True}),
    "LinearWarmup": ((0.1,), {"warmup_steps": 4, "start_lr": 0.0,
                              "end_lr": 0.1}),
    "LinearWarmup_sched": (None, {"warmup_steps": 3, "start_lr": 0.01,
                                  "end_lr": 0.1}),
    "StepDecay": ((0.1,), {"step_size": 2, "gamma": 0.5}),
    "MultiStepDecay": ((0.1, [3, 6, 9]), {"gamma": 0.3}),
    "LambdaDecay": ((0.1, lambda e: 0.95 ** e), {}),
    "MultiplicativeDecay": ((0.1, lambda e: 0.9), {}),
    "CosineAnnealingDecay": ((1.0,), {"T_max": 10, "eta_min": 0.01}),
    "OneCycleLR": ((0.1, 20), {}),
    "CyclicLR": ((0.01, 0.1, 3), {"step_size_down": 4}),
    "CyclicLR_triangular2": ((0.01, 0.1, 3), {"mode": "triangular2"}),
    "CyclicLR_exp_range": ((0.01, 0.1, 3), {"mode": "exp_range",
                                           "exp_gamma": 0.9}),
    "CosineAnnealingWarmRestarts": ((1.0, 3), {"T_mult": 2,
                                               "eta_min": 0.05}),
}


def _sched(mod, name):
    args, kw = SCHEDULERS[name]
    cls = getattr(mod.lr, name.split("_")[0])
    if args is None:  # LinearWarmup around a scheduler
        return cls(mod.lr.CosineAnnealingDecay(0.1, T_max=8), **kw)
    return cls(*args, **kw)


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    r, p = _sched(ropt, name), _sched(popt, name)
    at = [(float(p.lr_at(t)), float(r.lr_at(t))) for t in range(20)]
    vals = []
    for _ in range(20):
        vals.append((float(p()), float(r())))
        r.step()
        p.step()
    for got, want in at + vals:
        assert got == pytest.approx(want, rel=1e-12, abs=1e-15), name
    assert p.state_dict().keys() == r.state_dict().keys()


def test_reduce_on_plateau_matches_reference():
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    for mode, metrics in (("min", [1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5]),
                          ("max", [1.0, 2.0, 2.0, 2.0, 2.0, 3.0])):
        r = ropt.lr.ReduceOnPlateau(1.0, mode=mode, patience=1, factor=0.5,
                                    cooldown=1)
        p = popt.lr.ReduceOnPlateau(1.0, mode=mode, patience=1, factor=0.5,
                                    cooldown=1)
        for m in metrics:
            r.step(m)
            p.step(torch.tensor(m))
            assert p() == r(), (mode, m)
        assert p() < 1.0


# ---- the stateful API (the reference test's cases) -------------------------

def _both(val=(3.0, -2.0)):
    import paddle_tpu as paddle
    rp = paddle.Parameter(np.asarray(val, np.float32))
    pp = torch.tensor(val, dtype=torch.float32, requires_grad=True)
    return rp, pp


def _run(ropt_inst, rp, popt_inst, pp, n):
    for _ in range(n):
        (rp * rp).sum().backward()
        ropt_inst.step()
        ropt_inst.clear_grad()
        (pp * pp).sum().backward()
        popt_inst.step()
        popt_inst.clear_grad()


@pytest.mark.parametrize("name,kw,tol", [
    ("SGD", {}, 0.5), ("Momentum", {"momentum": 0.9}, 0.5),
    ("Adam", {}, 0.5), ("AdamW", {"weight_decay": 0.01}, 0.5),
    ("Adamax", {}, 0.5), ("Adagrad", {"learning_rate": 0.5}, 0.5),
    ("Adadelta", {"learning_rate": 1.0}, 11.0), ("RMSProp", {}, 0.5),
    ("Lamb", {}, 0.5), ("Lars", {}, 13.0)])
def test_minimizes_quadratic(name, kw, tol):
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    rp, pp = _both()
    kw = {"learning_rate": 0.1, **kw}
    ro = getattr(ropt, name)(parameters=[rp], **kw)
    po = getattr(popt, name)(parameters=[pp], device="cpu", **kw)
    _run(ro, rp, po, pp, 80)
    np.testing.assert_allclose(pp.detach().numpy(), rp.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float((pp * pp).sum().detach()) < tol
    assert pp.grad is None


@pytest.mark.parametrize("name", ["Adam", "Momentum"])
def test_matches_torch_optim(name):
    import paddle_tpu_torch.optimizer as popt
    w0 = np.random.RandomState(3).rand(3).astype(np.float32)
    p = torch.tensor(w0, requires_grad=True)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    if name == "Adam":
        o = popt.Adam(learning_rate=0.01, parameters=[p], device="cpu")
        to = torch.optim.Adam([tp], lr=0.01)
    else:
        o = popt.Momentum(learning_rate=0.01, momentum=0.9, parameters=[p],
                          device="cpu")
        to = torch.optim.SGD([tp], lr=0.01, momentum=0.9)
    for _ in range(10):
        (p * p).sum().backward()
        o.step()
        o.clear_grad()
        to.zero_grad()
        (tp * tp).sum().backward()
        to.step()
    np.testing.assert_allclose(p.detach().numpy(), tp.detach().numpy(),
                               rtol=1e-4)


def test_weight_decay_regularizers_and_groups():
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt
    for rreg, preg in ((paddle.L2Decay(0.5), popt.L2Decay(0.5)),
                       (paddle.L1Decay(0.5), popt.L1Decay(0.5)), (0.5, 0.5)):
        rp, pp = _both((1.0, -2.0))
        ro = ropt.SGD(learning_rate=0.1, parameters=[rp],
                      weight_decay=rreg)
        po = popt.SGD(learning_rate=0.1, parameters=[pp],
                      weight_decay=preg, device="cpu")
        (rp * 0.0).sum().backward()
        ro.step()
        (pp * 0.0).sum().backward()
        po.step()
        np.testing.assert_allclose(pp.detach().numpy(), rp.numpy(),
                                   rtol=1e-6)
    # param groups: per-group lr and decoupled decay
    ra, pa = _both((1.0, 2.0))
    rb, pb = _both((3.0, -1.0))
    ro = ropt.AdamW(learning_rate=0.1, parameters=[
        {"params": [ra], "learning_rate": 0.5},
        {"params": [rb], "weight_decay": 0.2}])
    po = popt.AdamW(learning_rate=0.1, parameters=[
        {"params": [pa], "learning_rate": 0.5},
        {"params": [pb], "weight_decay": 0.2}], device="cpu")
    for _ in range(3):
        ((ra * ra).sum() + (rb * rb).sum()).backward()
        ro.step()
        ro.clear_grad()
        ((pa * pa).sum() + (pb * pb).sum()).backward()
        po.step()
        po.clear_grad()
    np.testing.assert_allclose(pa.detach().numpy(), ra.numpy(), rtol=1e-5)
    np.testing.assert_allclose(pb.detach().numpy(), rb.numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_grad_clip(kind):
    import paddle_tpu.nn as rnn
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.nn as pnn
    import paddle_tpu_torch.optimizer as popt
    cls, arg = {"global": ("ClipGradByGlobalNorm", 1.0),
                "norm": ("ClipGradByNorm", 1.0),
                "value": ("ClipGradByValue", 2.0)}[kind]
    rp, pp = _both((0.0, 0.0, 0.0, 0.0))
    ro = ropt.SGD(learning_rate=1.0, parameters=[rp],
                  grad_clip=getattr(rnn, cls)(arg))
    po = popt.SGD(learning_rate=1.0, parameters=[pp],
                  grad_clip=getattr(pnn, cls)(arg), device="cpu")
    scale = np.asarray([100.0, -50.0, 1.0, 0.5], np.float32)
    import paddle_tpu as paddle
    (rp * paddle.to_tensor(scale)).sum().backward()
    ro.step()
    (pp * torch.from_numpy(scale)).sum().backward()
    po.step()
    np.testing.assert_allclose(pp.detach().numpy(), rp.numpy(), rtol=1e-5)
    if kind == "global":
        assert np.linalg.norm(pp.detach().numpy()) == pytest.approx(
            1.0, rel=1e-4)


def test_clip_tree_and_eager_helpers():
    import jax.numpy as jnp

    import paddle_tpu.nn as rnn
    import paddle_tpu_torch.nn as pnn
    from paddle_tpu_torch.nn.clip import clip_grad_norm_, clip_grad_value_
    g = _grads(0)
    want = rnn.ClipGradByGlobalNorm(1.5).clip_tree(
        {k: jnp.asarray(v) for k, v in g.items()})
    got = pnn.ClipGradByGlobalNorm(1.5).clip_tree(
        {k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5)
    p = torch.zeros(3, requires_grad=True)
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    total = clip_grad_norm_([p], 1.0)
    assert float(total) == pytest.approx(5.0)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8, 0.0], rtol=1e-5)
    clip_grad_value_([p], 0.7)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.7, 0.0], rtol=1e-6)


def test_state_dict_roundtrip_and_lr():
    import paddle_tpu_torch.optimizer as popt
    p = torch.tensor([3.0, -2.0], requires_grad=True)
    o = popt.Adam(learning_rate=0.1, parameters=[p], device="cpu")
    for _ in range(3):
        (p * p).sum().backward()
        o.step()
        o.clear_grad()
    sd = o.state_dict()
    assert sorted(sd) == ["@step", "param_0.moment1", "param_0.moment2"]
    p2 = torch.tensor([3.0, -2.0], requires_grad=True)
    o2 = popt.Adam(learning_rate=0.1, parameters=[p2], device="cpu")
    o2.set_state_dict(sd)
    assert o2._step_count == 3
    torch.testing.assert_close(o2._slots[id(p2)]["moment1"],
                               o._slots[id(p)]["moment1"])
    # other names resume by order and shape; a mismatch is refused
    o2 = popt.Adam(learning_rate=0.1, parameters=[("renamed", p2)],
                   device="cpu")
    with pytest.warns(UserWarning, match="order and shape"):
        o2.set_state_dict(sd)
    assert o2._step_count == 3 and "renamed.moment1" in o2.state_dict()
    p3 = torch.zeros(5, requires_grad=True)
    o3 = popt.Adam(learning_rate=0.1, parameters=[("other", p3)],
                   device="cpu")
    with pytest.raises(ValueError, match="positional parameter match"):
        o3.set_state_dict(sd)
    assert o.get_lr() == 0.1
    o.set_lr(0.05)
    assert o.get_lr() == 0.05
    sched = popt.lr.StepDecay(0.1, step_size=1, gamma=0.1)
    o4 = popt.SGD(learning_rate=sched, parameters=[p], device="cpu")
    assert o4.get_lr() == 0.1
    sched.step()
    assert o4.get_lr() == pytest.approx(0.01)
    with pytest.raises(RuntimeError, match="scheduler"):
        o4.set_lr(0.3)
    assert "LR_Scheduler" in o4.state_dict()


def test_minimize_and_device_check():
    import paddle_tpu_torch.optimizer as popt
    p = torch.tensor([3.0, -2.0], requires_grad=True)
    o = popt.SGD(learning_rate=0.1, parameters=[p], device="cpu")
    o.minimize((p * p).sum())
    assert float((p * p).sum().detach()) < 13.0
    with pytest.raises(ValueError, match="without parameters"):
        popt.SGD(0.1, device="cpu").step()
    with pytest.raises(ValueError, match="optimizer runs on"):
        popt.SGD(0.1, device="meta").functional_init({"w": torch.zeros(2)})
