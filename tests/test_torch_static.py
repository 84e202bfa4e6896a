"""CPU twins of the port's static graph (`paddle_tpu_torch.static`:
Program, Executor, static.nn, the inference model) against the
reference's `paddle_tpu.static`: the twins of test_static.py (its six
cases), of test_pylayer_staticio.py's static-io half, and of the static
training path the card's chip_smoke phase 4i (b) drives (an encoder
block over the attention op, Adam); and the registered flash ops the
static graph and the export rely on.

Both sides build the same Program; the port's persistables are the
reference's after its startup program (`carry`: parameters in creation
order). Tolerances: float32 outputs and losses 1e-5 relative (the same
arithmetic in another order); gradients 1e-4 of their largest
magnitude; after Adam steps the parameters 2 · lr · steps absolute
(PERF.md §2's parity policy: Adam's normalised step turns a float32
gradient's last bits near zero into a full step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.static as rstatic
from paddle_tpu.static.executor import _global_scope as r_scope

import paddle_tpu_torch as ptt
import paddle_tpu_torch.static as static
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.ops import flash_attention as pf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _static_mode():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        paddle.enable_static()
        ptt.enable_static()
        try:
            yield
        finally:
            ptt.disable_static()
            paddle.disable_static()


def carry(ref_main, main):
    """The reference's parameter values (after its startup) into the
    port's global scope, pairing the two Programs' parameters in
    creation order."""
    rps = [v for v in ref_main.global_block().vars.values() if v.persistable]
    pps = [v for v in main.global_block().vars.values() if v.persistable]
    assert [tuple(v.shape) for v in rps] == [tuple(v.shape) for v in pps]
    for rv, pv in zip(rps, pps):
        static.global_scope().set(pv.name, torch.from_numpy(
            np.array(r_scope.find_var(rv.name))))


def build(pkg, st, fn):
    """Build fn(pkg, st) in a fresh (main, startup) of `st`; returns
    (main, startup, fn's result)."""
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        out = fn(pkg, st)
    return main, startup, out


def twin(fn):
    """The same Program on both sides, the reference's startup run and its
    values carried into the port's scope: (ref exe, ref main, ref out,
    port exe, port main, port out)."""
    rmain, rstart, rout = build(paddle, rstatic, fn)
    main, start, out = build(ptt, static, fn)
    rexe, exe = rstatic.Executor(), static.Executor()
    rexe.run(rstart)
    exe.run(start)
    carry(rmain, main)
    return rexe, rmain, rout, exe, main, out


def test_data_and_ops():
    def fn(pkg, st):
        x = st.data("x", [None, 4], "float32")
        return (x * 2.0 + 1.0).mean()

    rexe, rmain, rz, exe, main, z = twin(fn)
    feed = {"x": np.ones((3, 4), np.float32)}
    (out,) = exe.run(main, feed=feed, fetch_list=[z])
    (rout,) = rexe.run(rmain, feed=feed, fetch_list=[rz])
    assert out == np.float32(3.0) == rout


def test_fc_forward():
    def fn(pkg, st):
        return st.nn.fc(st.data("x", [None, 4], "float32"), size=3)

    rexe, rmain, rout, exe, main, out = twin(fn)
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    (res,) = exe.run(main, feed={"x": x}, fetch_list=[out])
    (want,) = rexe.run(rmain, feed={"x": x}, fetch_list=[rout])
    assert res.shape == (2, 3)
    np.testing.assert_allclose(res, want, rtol=1e-5, atol=1e-6)


def test_minimize_trains():
    """SGD through minimize: the first 20 losses are the reference's,
    and after 150 steps the loss is below 5% of the first."""
    def fn(pkg, st):
        x = st.data("x", [None, 2], "float32")
        y = st.data("y", [None, 1], "float32")
        pred = st.nn.fc(x, size=1)
        loss = ((pred - y) * (pred - y)).mean()
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    rexe, rmain, rloss, exe, main, loss = twin(fn)
    true_w = np.array([[2.0], [-1.0]], np.float32)
    xd = np.random.RandomState(1).rand(32, 2).astype(np.float32)
    feed = {"x": xd, "y": xd @ true_w}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
              for _ in range(150)]
    want = [float(rexe.run(rmain, feed=feed, fetch_list=[rloss])[0])
            for _ in range(20)]
    np.testing.assert_allclose(losses[:20], want, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.05, losses[::30]


def test_shape_change_recompiles():
    """A new feed shape runs (a new cache entry, as the reference compiles
    a new step) and gives the reference's sums."""
    def fn(pkg, st):
        x = st.data("x", [None, 3], "float32")
        return (x * x).sum()

    rexe, rmain, rout, exe, main, out = twin(fn)
    got = []
    for n in (2, 5):
        feed = {"x": np.ones((n, 3), np.float32)}
        (a,) = exe.run(main, feed=feed, fetch_list=[out])
        (b,) = rexe.run(rmain, feed=feed, fetch_list=[rout])
        assert a == b
        got.append(float(a))
    assert got == [6.0, 15.0]
    assert len([k for k in exe._cache if k[0] == main._uid]) == 2


def test_stochastic_op_in_program():
    """Dropout in a Program draws fresh numbers at each run, as the
    reference's; every run keeps the mask's scale (kept values are 2)."""
    def fn(pkg, st):
        x = st.data("x", [4, 4], "float32")
        y = pkg.ops.dropout(x, p=0.5, training=True)
        return y, y.sum()

    rexe, rmain, (_, rs), exe, main, (y, s) = twin(fn)
    feed = {"x": np.ones((4, 4), np.float32)}
    outs = {float(exe.run(main, feed=feed, fetch_list=[s])[0])
            for _ in range(5)}
    routs = {float(rexe.run(rmain, feed=feed, fetch_list=[rs])[0])
             for _ in range(5)}
    assert len(outs) > 1 and len(routs) > 1
    (yv,) = exe.run(main, feed=feed, fetch_list=[y])
    assert set(np.unique(yv)) <= {0.0, 2.0}


def test_layer_norm_parity():
    """The reference test's name; it holds static fc with Assign
    initializers to the eager Linear of the same weights (1e-5)."""
    ptt.disable_static()
    lin = ptt.nn.Linear(4, 2)
    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    eager = lin(torch.from_numpy(x)).detach().numpy()
    ptt.enable_static()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        xv = static.data("x", [None, 4], "float32")
        out = static.nn.fc(xv, size=2, weight_attr=ptt.ParamAttr(
            initializer=ptt.nn.initializer.Assign(lin.weight.detach()
                                                  .numpy())),
            bias_attr=ptt.ParamAttr(initializer=ptt.nn.initializer.Assign(
                lin.bias.detach().numpy())))
    exe = static.Executor()
    exe.run(startup)
    (res,) = exe.run(main, feed={"x": x}, fetch_list=[out])
    np.testing.assert_allclose(res, eager, rtol=1e-5)


def test_save_load_inference_model(tmp_path):
    """The twin of test_pylayer_staticio.py::TestStaticInferenceIO: the
    saved artifact runs standalone and through Executor.run, on the
    saved batch and another (batch-polymorphic), with the reference's
    outputs on the same weights."""
    def fn(pkg, st):
        x = st.data("x", [None, 4], "float32")
        return x, st.nn.fc(x, size=2)

    rexe, rmain, (_, rout), exe, main, (x, out) = twin(fn)
    xd = np.random.RandomState(3).rand(2, 4).astype(np.float32)
    (ref,) = exe.run(main, feed={"x": xd}, fetch_list=[out])
    (want,) = rexe.run(rmain, feed={"x": xd}, fetch_list=[rout])
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-6)
    prefix = str(tmp_path / "model")
    static.save_inference_model(prefix, [x], [out], exe, program=main)
    loaded, feeds, fetches = static.load_inference_model(prefix, exe)
    assert feeds == ["x"] and fetches == [out.name]
    (again,) = exe.run(main, feed={"x": xd}, fetch_list=[out])
    np.testing.assert_allclose(again, ref, rtol=1e-6)
    (lo,) = loaded({"x": xd})
    np.testing.assert_allclose(np.asarray(lo), ref, rtol=1e-6)
    (le,) = exe.run(loaded, feed={"x": xd}, fetch_list=fetches)
    np.testing.assert_allclose(le, ref, rtol=1e-6)
    x3 = np.random.RandomState(4).rand(7, 4).astype(np.float32)
    (l3,) = loaded({"x": x3})
    (w3,) = rexe.run(rmain, feed={"x": x3}, fetch_list=[rout])
    assert np.asarray(l3).shape == (7, 2)
    np.testing.assert_allclose(np.asarray(l3), w3, rtol=1e-5, atol=1e-6)


def test_grad_fetch_without_optimizer():
    """append_backward then a `<param>@GRAD` fetch, and `gradients` by a
    data variable: the reference's gradients (1e-5)."""
    def fn(pkg, st):
        x = st.data("x", [3, 4], "float32")
        h = st.nn.fc(x, size=5, act="tanh")
        loss = (h * h).mean()
        pgs = st.append_backward(loss)
        (gx,) = st.gradients(loss, [x])
        return loss, [g for _, g in pgs], gx

    rexe, rmain, (rl, rgs, rgx), exe, main, (loss, gs, gx) = twin(fn)
    feed = {"x": np.random.RandomState(5).randn(3, 4).astype(np.float32)}
    names = [g.name for g in gs] + [gx.name]
    got = exe.run(main, feed=feed, fetch_list=[loss] + names)
    want = rexe.run(rmain, feed=feed,
                    fetch_list=[rl] + [g.name for g in rgs] + [rgx.name])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def encoder_block(pkg, st, b=2, s=16, d=64, heads=2, ffn=128, dtype="float32"):
    """One BERT-style encoder block over static.data: q, k, v by fc,
    the attention op with a [B, 1, 1, S] padding bias, out projection,
    residual + layer_norm, the feed-forward, residual + layer_norm, mean
    pooling and a 2-way head; cross entropy; Adam. Returns (loss, logits)."""
    x = st.data("x", [b, s, d], dtype)
    bias = st.data("bias", [b, 1, 1, s], dtype)
    label = st.data("label", [b], "int64")
    def heads_of(t):
        return pkg.ops.transpose(pkg.ops.reshape(t, [b, s, heads,
                                                     d // heads]),
                                 [0, 2, 1, 3])

    q, k, v = (heads_of(st.nn.fc(x, d, num_flatten_dims=2))
               for _ in range(3))
    att, _ = pkg.ops.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    att = pkg.ops.reshape(pkg.ops.transpose(att, [0, 2, 1, 3]), [b, s, d])
    h = st.nn.layer_norm(x + st.nn.fc(att, d, num_flatten_dims=2),
                         begin_norm_axis=2)
    f = st.nn.fc(st.nn.fc(h, ffn, num_flatten_dims=2, act="gelu"), d,
                 num_flatten_dims=2)
    h = st.nn.layer_norm(h + f, begin_norm_axis=2)
    logits = st.nn.fc(pkg.ops.mean(h, axis=1), 2)
    loss = pkg.nn.functional.cross_entropy(logits, label)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss, logits


def block_feed(b=2, s=16, d=64, lengths=(16, 9), seed=6):
    rs = np.random.RandomState(seed)
    real = np.arange(s)[None] < np.asarray(lengths)[:, None]
    return {"x": rs.randn(b, s, d).astype(np.float32),
            "bias": np.where(real, 0.0, -1e9).astype(np.float32)[
                :, None, None, :],
            "label": rs.randint(0, 2, (b,)).astype(np.int64)}


def test_encoder_block_trains_as_the_reference():
    """The static training path of chip_smoke phase 4i (b) at a small
    size: three Adam steps of the encoder block on a padded batch. The
    Program records one flash node; the first step's gradients (the
    `@GRAD` fetches) are the reference's within 1e-4 of their magnitude
    (1e-8 for a gradient that is 0 in exact arithmetic),
    the three losses within 1e-5, and the parameters within 2 · lr ·
    steps (Adam's step is lr · sign-like where a gradient is near 0)."""
    rexe, rmain, (rl, _), exe, main, (loss, _) = twin(encoder_block)
    flash = [op for op in main.global_block().ops if op.type ==
             "paddle_tpu_torch::flash_attn"]
    assert len(flash) == 1
    rps = [v for v in rmain.global_block().vars.values() if v.persistable]
    pps = [v for v in main.global_block().vars.values() if v.persistable]
    feed = block_feed()
    got = exe.run(main, feed=feed,
                  fetch_list=[loss] + [p.name + "@GRAD" for p in pps])
    want = rexe.run(rmain, feed=feed,
                    fetch_list=[rl] + [p.name + "@GRAD" for p in rps])
    for a, b, p in zip(got[1:], want[1:], pps):
        # a leaf whose gradient is 0 in exact arithmetic (the key bias:
        # softmax ignores a per-row constant) holds rounding noise only
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-4), \
            p.name
    losses = [float(got[0])] + [
        float(exe.run(main, feed=feed, fetch_list=[loss])[0])
        for _ in range(2)]
    rlosses = [float(want[0])] + [
        float(rexe.run(rmain, feed=feed, fetch_list=[rl])[0])
        for _ in range(2)]
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    for rv, pv in zip(rps, pps):
        a = static.global_scope().find_var(pv.name).numpy()
        b = np.asarray(r_scope.find_var(rv.name))
        assert np.abs(a - b).max() <= 2 * 1e-3 * 3, pv.name


def test_pylayer_in_a_static_program():
    """A PyLayer inside a Program is one recorded op; the Executor runs
    its forward and, for a @GRAD fetch, its own backward."""
    class Exp3(ptt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = ptt.exp(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * y * 3  # deliberately 3x: the custom rule runs

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [2, 3], "float32")
        y = Exp3.apply(x)
        loss = y.sum()
        (gx,) = static.gradients(loss, [x])
    assert [op.type for op in main.global_block().ops] == ["Exp3", "sum"]
    exe = static.Executor()
    xd = np.random.RandomState(7).randn(2, 3).astype(np.float32)
    yv, g = exe.run(main, feed={"x": xd}, fetch_list=[y, gx])
    np.testing.assert_allclose(yv, np.exp(xd), rtol=1e-6)
    np.testing.assert_allclose(g, 3 * np.exp(xd), rtol=1e-6)


def test_clone_for_test_is_another_executable():
    """clone(for_test=True) drops the optimizer and gets its own uid (the
    Executor's cache key): running it never moves the weights."""
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [4, 2], "float32")
        loss = static.nn.fc(x, 1).mean()
        ptt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    test = main.clone(for_test=True)
    assert test._uid != main._uid and not test._optimizers
    exe = static.Executor()
    exe.run(startup)
    w = main.all_parameters()[0].name
    before = static.global_scope().find_var(w).clone()
    feed = {"x": np.ones((4, 2), np.float32)}
    exe.run(test, feed=feed, fetch_list=[loss])
    assert torch.equal(static.global_scope().find_var(w), before)
    exe.run(main, feed=feed, fetch_list=[loss])
    assert not torch.equal(static.global_scope().find_var(w), before)


# ---- the registered flash ops -------------------------------------------------

@pytest.mark.parametrize("sq,sk,bias,causal", [
    (16, 16, False, True), (16, 16, True, False), (12, 20, True, True),
    (1, 33, False, False)])
def test_flash_op_fake_shapes_are_the_plain_outputs(sq, sk, bias, causal):
    """The ops' fake implementations give the plain versions' shapes and
    dtypes, forward (out, lse) and backward (dq, dk, dv, dbias)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn(2, 2, sq, 32, generator=g)
    k, v = (torch.randn(2, 2, sk, 32, generator=g) for _ in range(2))
    b = torch.zeros(2, sk) if bias else None
    out, lse = pf.flash_attn_op(q, k, v, b, causal, 0.25)
    grads = pf.flash_attn_bwd_op(q, k, v, b, out, lse, torch.ones_like(out),
                                 causal, 0.25)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fb = None if b is None else mode.from_tensor(b)
        fout, flse = pf.flash_attn_op(fq, fk, fv, fb, causal, 0.25)
        fgrads = pf.flash_attn_bwd_op(fq, fk, fv, fb, fout, flse,
                                      torch.ones_like(fout), causal, 0.25)
    for real, fake in zip((out, lse) + tuple(grads),
                          (fout, flse) + tuple(fgrads)):
        assert (real.shape, real.dtype) == (fake.shape, fake.dtype)


@pytest.mark.parametrize("bias,causal", [(False, True), (True, False),
                                         (True, True)])
def test_the_eager_route_is_the_registered_op(bias, causal):
    """An eager call takes `_FlashAttention`, not the registered op's
    dispatch; its output and gradients (q, k, v and the bias) are the
    op's and its autograd rule's, bit for bit (one plain implementation
    on the CPU)."""
    ptt.disable_static()
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 2, 12, 32, generator=g) for _ in range(3))
    b = torch.randn(2, 12, generator=g) if bias else None
    do = torch.randn(2, 2, 12, 32, generator=g)
    got = []
    for eager in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)] + (
            [b.clone().requires_grad_()] if bias else [])
        args = (*leaves[:3], leaves[3] if bias else None, causal, 0.25)
        out = pf._FlashAttention.apply(*args) if eager \
            else pf.flash_attn_op(*args)[0]
        got.append((out, torch.autograd.grad(out, leaves, do)))
    for a, b_ in zip((got[0][0], *got[0][1]), (got[1][0], *got[1][1])):
        assert torch.equal(a, b_)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pf.flash_attention_bias(*x, b) if bias \
        else pf.flash_attention(*x, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


def test_export_keeps_one_flash_node_a_layer():
    """torch.export of a 2-layer encoder that calls
    scaled_dot_product_attention (padded, so K4 bias) keeps one
    `paddle_tpu_torch::flash_attn` node a layer."""
    ptt.disable_static()
    layer = ptt.nn.TransformerEncoderLayer(64, 2, 128, dropout=0.0)
    enc = ptt.nn.TransformerEncoder(layer, 2).eval()
    x = torch.randn(2, 16, 64)
    mask = torch.zeros(2, 1, 1, 16)
    ep = torch.export.export(enc, (x, mask))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and "paddle_tpu_torch" in str(n.target)]
    assert [str(n.target) for n in nodes] == \
        ["paddle_tpu_torch.flash_attn.default"] * 2


def test_a_program_records_one_node_for_the_flash_call():
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        q = static.data("q", [1, 2, 8, 32], "float32")
        out = pf.flash_attention(q, q, q, causal=True)
    types = [op.type for op in main.global_block().ops]
    assert types.count("paddle_tpu_torch::flash_attn") == 1
    assert not any("einsum" in t or "softmax" in t for t in types)
    exe = static.Executor()
    qd = np.random.RandomState(8).randn(1, 2, 8, 32).astype(np.float32)
    (got,) = exe.run(main, feed={"q": qd}, fetch_list=[out])
    want = pf.flash_fwd_lse_plain(*(torch.from_numpy(qd),) * 3, 32 ** -0.5,
                                  True)[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_top_level_binds_and_aux_surface(tmp_path):
    """The names the reference binds (`paddle.static`, `enable_static`,
    `in_static_mode`, `paddle.data`, `nn.Input`) and static's aux
    surface: CompiledProgram / ParallelExecutor run the Program,
    cpu_places / cuda_places, create_global_var and create_parameter,
    save / load / load_program_state / set_program_state round trips,
    Print passes a Variable through."""
    assert ptt.static is static and ptt.data is static.data
    assert ptt.in_static_mode() and not ptt.in_dynamic_mode()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = ptt.nn.Input([None, 3], "float32", name="x")
        g = static.create_global_var([3], 2.5, "float32")
        w = static.create_parameter([3, 2], "float32")
        out = static.Print(ptt.matmul(x * g, w))
    assert isinstance(x, static.Variable) and x.desc_shape == [None, 3]
    exe = static.Executor(static.cpu_places()[0])
    exe.run(startup)
    assert torch.equal(static.global_scope().find_var(g.name),
                       torch.full((3,), 2.5))
    xd = np.ones((2, 3), np.float32)
    (a,) = exe.run(static.CompiledProgram(main).with_data_parallel(),
                   feed={"x": xd}, fetch_list=[out])
    (b,) = exe.run(static.ParallelExecutor(main_program=main)._program,
                   feed={"x": xd}, fetch_list=[out])
    wv = static.global_scope().find_var(w.name).numpy()
    np.testing.assert_allclose(a, xd * 2.5 @ wv, rtol=1e-6)
    np.testing.assert_array_equal(a, b)
    assert len(static.cuda_places()) == torch.cuda.device_count()
    static.save(main, str(tmp_path / "prog"))
    state = static.load_program_state(str(tmp_path / "prog"))
    assert sorted(state) == sorted([g.name, w.name])
    static.set_program_state(main, {w.name: np.zeros((3, 2), np.float32)})
    (z,) = exe.run(main, feed={"x": xd}, fetch_list=[out])
    assert not z.any()
    static.load(main, str(tmp_path / "prog"))
    (c,) = exe.run(main, feed={"x": xd}, fetch_list=[out])
    np.testing.assert_array_equal(c, a)
