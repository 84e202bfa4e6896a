"""CPU twins of `paddle_tpu_torch.static.nn`'s fluid layers against the
reference's `paddle_tpu.static.nn`: the static-mode cases of
test_static_nn_extra.py (TestStaticNNExtra, TestPyFunc). Both sides build
the same Program; the port's persistables are the reference's after its
startup (`test_torch_static.carry`), so the outputs are compared, not
only their shapes: float32 within 1e-5 (1e-4 for the deformable conv's
bilinear sums, which add in another order). Where an op draws random
numbers (nce's negatives) only the shape is compared, as the reference
test does, and so is the deformable conv at nonzero offsets (ROADMAP
§C 54).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.static as rstatic

import paddle_tpu_torch as ptt
import paddle_tpu_torch.static as static
from paddle_tpu_torch import device as pdevice

from test_torch_static import twin

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


def run_both(fn, feed):
    rexe, rmain, routs, exe, main, outs = twin(fn)
    got = exe.run(main, feed=feed, fetch_list=list(outs))
    want = rexe.run(rmain, feed=feed, fetch_list=list(routs))
    return got, want


def test_param_layers_run():
    def fn(pkg, st):
        x = st.data("x", [4, 8], "float32")
        img = st.data("img", [4, 3, 16, 16], "float32")
        y2 = st.data("y2", [4, 8], "float32")
        outs = (st.nn.prelu(x, mode="channel"), st.nn.instance_norm(img),
                st.nn.group_norm(img, groups=3),
                st.nn.conv2d_transpose(img, 6, 3),
                st.nn.bilinear_tensor_product(x, y2, 7))
        st.nn.create_parameter([3, 3], "float32")
        return outs

    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(4, 8).astype(np.float32),
            "img": rs.rand(4, 3, 16, 16).astype(np.float32),
            "y2": rs.rand(4, 8).astype(np.float32)}
    got, want = run_both(fn, feed)
    assert [o.shape for o in got] == [
        (4, 8), (4, 3, 16, 16), (4, 3, 16, 16), (4, 6, 18, 18), (4, 7)]
    np.testing.assert_allclose(got[1].mean(axis=(2, 3)), 0.0, atol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_conv3d_variants():
    def fn(pkg, st):
        x3 = st.data("x3", [2, 3, 4, 8, 8], "float32")
        return st.nn.conv3d(x3, 5, 3), st.nn.conv3d_transpose(x3, 5, 3)

    feed = {"x3": np.random.RandomState(1).rand(2, 3, 4, 8, 8)
            .astype(np.float32)}
    got, want = run_both(fn, feed)
    assert got[0].shape == (2, 5, 2, 6, 6)
    assert got[1].shape == (2, 5, 6, 10, 10)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_crf_decoding_prefers_high_emission():
    def fn(pkg, st):
        return (st.nn.crf_decoding(st.data("emis", [1, 4, 3], "float32")),)

    e = np.full((1, 4, 3), -5.0, np.float32)
    want_path = [0, 2, 1, 0]
    for t, c in enumerate(want_path):
        e[0, t, c] = 5.0
    (got,), (want,) = run_both(fn, {"emis": e})
    assert list(got[0]) == want_path == list(np.asarray(want)[0])


def test_row_conv_lookahead():
    def fn(pkg, st):
        return (st.nn.row_conv(st.data("seq", [1, 5, 2], "float32"), 2),)

    feed = {"seq": np.random.RandomState(2).rand(1, 5, 2)
            .astype(np.float32)}
    (got,), (want,) = run_both(fn, feed)
    assert got.shape == (1, 5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _mixed(pkg, st):
    x = st.data("x", [4, 8], "float32")
    lbl = st.data("lbl", [4, 1], "int64")
    loss = st.nn.nce(x, lbl, 100, num_neg_samples=3)
    img = st.data("img", [2, 4, 8, 8], "float32")
    off = st.data("off", [2, 18, 8, 8], "float32")
    msk = st.data("msk", [2, 9, 8, 8], "float32")
    dc = st.nn.deform_conv2d(img, off, msk, 6, 3, padding=1)
    image = st.data("image", [2, 3, 32, 32], "float32")
    f1 = st.data("f1", [2, 8, 8, 8], "float32")
    locs, confs, box, var = st.nn.multi_box_head(
        [f1], image, base_size=32, num_classes=5, aspect_ratios=[[2.0]],
        min_ratio=20, max_ratio=90)
    return loss, dc, locs, confs, box, var


def test_nce_and_deform_and_mbox():
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 8).astype(np.float32),
            "lbl": rng.randint(0, 100, (4, 1)).astype(np.int64),
            "img": rng.rand(2, 4, 8, 8).astype(np.float32),
            "off": (rng.rand(2, 18, 8, 8) - 0.5).astype(np.float32),
            "msk": rng.rand(2, 9, 8, 8).astype(np.float32),
            "image": rng.rand(2, 3, 32, 32).astype(np.float32),
            "f1": rng.rand(2, 8, 8, 8).astype(np.float32)}
    got, want = run_both(_mixed, feed)
    assert got[0].shape == (4, 1) and np.isfinite(got[0]).all()
    assert got[1].shape == (2, 6, 8, 8)
    assert got[2].shape[0] == 2 and got[4].shape[-1] == 4
    # the deformable conv only by shape here, as the reference test: the
    # reference's static deform_conv2d reads its offsets through moveaxis
    # then reshape, which scrambles (tap, column) for nonzero offsets
    # (ROADMAP §C 54); zero offsets are compared in the next test
    assert want[1].shape == got[1].shape
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_deform_conv_zero_offset_matches_plain():
    """Zero offsets and an all-ones mask: the deformable conv is the
    plain convolution with the same weight (and the reference's)."""
    def fn(pkg, st):
        img = st.data("img", [1, 2, 6, 6], "float32")
        off = st.data("off", [1, 18, 6, 6], "float32")
        msk = st.data("msk", [1, 9, 6, 6], "float32")
        return (st.nn.deform_conv2d(img, off, msk, 3, 3, padding=1),)

    xv = np.random.RandomState(1).rand(1, 2, 6, 6).astype(np.float32)
    feed = {"img": xv, "off": np.zeros((1, 18, 6, 6), np.float32),
            "msk": np.ones((1, 9, 6, 6), np.float32)}
    rexe, rmain, routs, exe, main, outs = twin(fn)
    (got,) = exe.run(main, feed=feed, fetch_list=list(outs))
    (want,) = rexe.run(rmain, feed=feed, fetch_list=list(routs))
    w = next(static.global_scope().find_var(v.name) for v in
             main.global_block().vars.values()
             if v.persistable and tuple(v.shape) == (3, 2, 3, 3))
    plain = torch.nn.functional.conv2d(torch.from_numpy(xv), w, padding=1)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)


class TestPyFunc:
    @pytest.fixture(autouse=True)
    def _dygraph(self):
        ptt.disable_static()
        paddle.disable_static()
        yield

    def test_forward_and_backward_func(self):
        """The host function and its backward_func give x the reference's
        gradient (2 everywhere)."""
        from paddle_tpu.core.tensor import Tensor as RT
        import jax
        import jax.numpy as jnp
        spec = np.zeros(3, np.float32)
        x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
        out = static.nn.py_func(lambda a: a * 2, x, spec,
                                backward_func=lambda a, g: g * 2)
        out.sum().backward()
        rx = RT(jnp.asarray([1.0, 2.0, 3.0]))
        rx.stop_gradient = False
        rout = rstatic.nn.py_func(lambda a: a * 2, rx,
                                  jax.ShapeDtypeStruct((3,), np.float32),
                                  backward_func=lambda a, g: g * 2)
        rout.sum().backward()
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(rout.numpy()))
        np.testing.assert_allclose(x.grad.numpy(),
                                   np.asarray(rx.grad.numpy()))

    def test_py_func_integer_inputs_get_float0_tangents(self):
        """Integer inputs take no host-computed gradient; the float one
        takes the backward_func's first output."""
        t = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
        idx = torch.tensor([0, 1, 2], dtype=torch.int32)
        o = static.nn.py_func(lambda a, i: a[i] * 2, [t, idx],
                              np.zeros(3, np.float32),
                              backward_func=lambda a, i, g: (g * 2, None))
        o.sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), [2.0] * 3)

    def test_py_func_under_jit(self):
        """The twin of the reference's py_func under jax.grad: a py_func
        inside a static Program is one recorded op, and a `@GRAD` fetch
        runs its backward_func (3 everywhere)."""
        ptt.enable_static()
        try:
            main, startup = static.Program(), static.Program()
            with static.program_guard(main, startup):
                x = static.data("x", [3], "float32")
                o = static.nn.py_func(lambda a: a * 3, x,
                                      np.zeros(3, np.float32),
                                      backward_func=lambda a, g: g * 3)
                (gx,) = static.gradients(o.sum(), [x])
            assert [op.type for op in main.global_block().ops] == \
                ["py_func", "sum"]
            got, g = static.Executor().run(
                main, feed={"x": np.array([1.0, 2.0, 3.0], np.float32)},
                fetch_list=[o, gx])
        finally:
            ptt.disable_static()
        np.testing.assert_allclose(got, [3.0, 6.0, 9.0])
        np.testing.assert_allclose(g, [3.0] * 3)
