"""CPU twins of the port's `paddle_tpu_torch.slim` against the reference's
`paddle_tpu.slim`:

  * the 13 cases of `tests/test_slim_quant.py` that do not save, run on
    the port (the jitted-step case through `paddle.Model`'s fused step,
    `torch.func.functional_call`, the port's compiled-step path), the
    PTQ and QAT cases also on the reference's weights beside the
    reference's run;
  * cross-package cases on the same weights (the reference's quantized
    layer's `state_dict()` carried in by `load_reference_state`): codes
    and int32 accumulators of `QuantedLinear` and `QuantedConv2D`
    (stride, padding, dilation, groups, the stem's k = 147) bitwise the
    reference's, whose accumulators come from
    `preferred_element_type=int32`; the int8 outputs; the observers'
    scales; `fuse_conv_bn` on a resnet18; QAT Adam steps of an MLP; the
    frozen int8 state carried by `load_frozen`;
  * `int8_matmul`'s padded shapes (m <= 16, k and n not multiples of 8)
    against an int64 product; the two `save_quantized_model`s raising
    (ROADMAP §A 14.3).

Tolerances: codes, accumulators, frozen weights exactly; observer
scales 1e-6 (relative); int8 outputs rtol 1e-6 (the same integers, one
float rescale); float32 QAT steps 1e-5; fused conv weights 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.slim as RS
from paddle_tpu.core.tensor import Tensor as RT

import paddle_tpu_torch as ptt
import paddle_tpu_torch.slim as PS
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def rt(a):
    return RT(jnp.asarray(a))


def pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rnp(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def pnp(t):
    return t.detach().numpy()


def carry(ref, port):
    """The reference layer's state_dict into the port's: no name left."""
    assert load_reference_state(port, {
        k: rnp(v) for k, v in ref.state_dict().items()}) == []


class _RMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(16, 32)
        self.fc2 = paddle.nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class _PMLP(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = ptt.nn.Linear(16, 32)
        self.fc2 = ptt.nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(ptt.nn.functional.relu(self.fc1(x)))


def mlp_pair(seed=0):
    paddle.seed(seed)
    ref, port = _RMLP(), _PMLP()
    carry(ref, port)
    return ref, port


def _train(pkg, model, x, y, steps, lr=0.01):
    """The reference tests' Adam loop on either package: the losses."""
    opt = pkg.optimizer.Adam(learning_rate=lr,
                             parameters=model.parameters())
    losses = []
    xin, yin = (pt(x), pt(y)) if pkg is ptt else (rt(x), rt(y))
    for _ in range(steps):
        loss = pkg.nn.functional.cross_entropy(model(xin), yin)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()) if pkg is ptt
                      else float(rnp(loss)))
    return losses


# ---- the functional pieces --------------------------------------------------

class TestFunctional:
    def test_quant_dequant_roundtrip(self):
        x = np.linspace(-2, 2, 64).astype(np.float32)
        q = PS.quantize_symmetric(pt(x), 2.0, bits=8)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(
            pnp(q), rnp(RS.quantize_symmetric(jnp.asarray(x), 2.0, bits=8)))
        back = pnp(PS.dequantize(q, 2.0, bits=8))
        np.testing.assert_allclose(back, x, atol=2.0 / 127 + 1e-6)
        np.testing.assert_array_equal(
            back, rnp(RS.dequantize(jnp.asarray(pnp(q)), 2.0, bits=8)))

    def test_fake_quant_ste_gradient(self):
        import jax
        x = torch.tensor([0.5, -0.3, 5.0], requires_grad=True)
        PS.fake_quant(x, torch.tensor(1.0), 8).sum().backward()
        np.testing.assert_allclose(pnp(x.grad), [1.0, 1.0, 0.0])
        g = jax.grad(lambda v: RS.fake_quant(v, jnp.asarray(1.0), 8).sum())(
            jnp.asarray([0.5, -0.3, 5.0]))
        np.testing.assert_array_equal(pnp(x.grad), np.asarray(g))

    @pytest.mark.parametrize("bits", [8, 4, 16])
    def test_codes_at_rounding_boundaries_are_the_references(self, bits):
        """x on the half-code boundaries of several scales, per tensor and
        per channel: divide-then-multiply codes, bitwise."""
        rs = np.random.RandomState(bits)
        qm = (1 << (bits - 1)) - 1
        for scale in (1.0, 0.37, 3.3e-3, 17.0):
            k = rs.randint(-qm, qm, 256)
            x = ((k + 0.5) * scale / qm).astype(np.float32)
            x = np.concatenate([x, np.nextafter(x, np.inf), np.nextafter(
                x, -np.inf), rs.randn(64).astype(np.float32) * scale])
            got = pnp(PS.quantize_symmetric(pt(x), scale, bits))
            want = rnp(RS.quantize_symmetric(jnp.asarray(x), scale, bits))
            np.testing.assert_array_equal(got, want)
        w = rs.randn(6, 4, 3, 3).astype(np.float32)
        ws = PS.weight_scale_of(pt(w), "channel_wise_abs_max", "conv")
        rws = RS.weight_scale_of(jnp.asarray(w), "channel_wise_abs_max",
                                 "conv")
        np.testing.assert_array_equal(pnp(ws), rnp(rws))
        np.testing.assert_array_equal(
            pnp(PS.quantize_symmetric(pt(w), ws, bits)),
            rnp(RS.quantize_symmetric(jnp.asarray(w), rws, bits)))

    def test_fake_quant_forward_and_mask_are_the_references(self):
        import jax
        rs = np.random.RandomState(1)
        x = (rs.randn(8, 12) * 2).astype(np.float32)
        s = np.abs(rs.randn(1, 12)).astype(np.float32) + 0.5
        xt = pt(x).requires_grad_()
        y = PS.fake_quant(xt, pt(s))
        ry, vjp = jax.vjp(lambda v: RS.fake_quant(v, jnp.asarray(s)),
                          jnp.asarray(x))
        np.testing.assert_array_equal(pnp(y), rnp(ry))
        g = rs.randn(8, 12).astype(np.float32)
        y.backward(pt(g))
        np.testing.assert_array_equal(pnp(xt.grad),
                                      rnp(vjp(jnp.asarray(g))[0]))

    def test_bf16_input_codes_and_output_dtype(self):
        """A bf16 activation quantizes in bf16 against a float scale, as
        the reference's weakly typed scale; the int8 layer answers bf16."""
        rs = np.random.RandomState(2)
        x = rs.randn(32, 16).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        rxb = jnp.asarray(x).astype(jnp.bfloat16)
        np.testing.assert_array_equal(
            pnp(PS.quantize_symmetric(xb, 2.7)),
            rnp(RS.quantize_symmetric(rxb, 2.7)))
        ref, port = mlp_pair(3)
        RS.PostTrainingQuantization(model=ref, algo="abs_max").quantize(
            [(x,)])
        PS.PostTrainingQuantization(model=port, algo="abs_max").quantize(
            [(x,)])
        out = port(xb)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(pnp(out.float()), np.asarray(
            ref(RT(rxb)).numpy()).astype(np.float32), rtol=1e-2, atol=1e-2)


# ---- the integer contraction ------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 147, 1000), (16, 8, 8), (17, 9, 3),
                                   (40, 576, 64), (3, 2048, 10)])
def test_int8_matmul_padded_shapes_are_exact(m, k, n):
    rs = np.random.RandomState(m + k + n)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    w = rs.randint(-127, 128, (k, n)).astype(np.int8)
    wmat = PS.int8_weight_matrix(pt(w))
    assert wmat.shape[0] % 8 == 0 and wmat.shape[1] % 8 == 0
    acc = PS.int8_matmul(pt(a), wmat, n)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (m, n)
    np.testing.assert_array_equal(pnp(acc), a.astype(np.int64) @ w)


def _ref_quanted(kind, **kw):
    if kind == "linear":
        return RS.QuantedLinear(paddle.nn.Linear(kw["cin"], kw["cout"]),
                                **kw.get("q", {}))
    return RS.QuantedConv2D(paddle.nn.Conv2D(
        kw["cin"], kw["cout"], kw["k"], stride=kw.get("stride", 1),
        padding=kw.get("padding", 0), dilation=kw.get("dilation", 1),
        groups=kw.get("groups", 1)), **kw.get("q", {}))


def _port_quanted(kind, **kw):
    if kind == "linear":
        return PS.QuantedLinear(ptt.nn.Linear(kw["cin"], kw["cout"]),
                                **kw.get("q", {}))
    return PS.QuantedConv2D(ptt.nn.Conv2D(
        kw["cin"], kw["cout"], kw["k"], stride=kw.get("stride", 1),
        padding=kw.get("padding", 0), dilation=kw.get("dilation", 1),
        groups=kw.get("groups", 1)), **kw.get("q", {}))


LAYER_CASES = {
    "linear per-tensor 2d": ("linear", dict(cin=24, cout=10), (5, 24)),
    "linear per-channel 3d": ("linear", dict(cin=16, cout=12, q=dict(
        weight_quantize_type="channel_wise_abs_max")), (2, 7, 16)),
    "conv 3x3 pad 1": ("conv", dict(cin=8, cout=16, k=3, padding=1),
                       (2, 8, 10, 10)),
    "conv stem 7x7 stride 2 (k 147)": ("conv", dict(
        cin=3, cout=16, k=7, stride=2, padding=3, q=dict(
            weight_quantize_type="channel_wise_abs_max")), (2, 3, 23, 23)),
    "conv 1x1 stride 2": ("conv", dict(cin=16, cout=8, k=1, stride=2),
                          (3, 16, 9, 9)),
    "conv dilation 2 groups 2": ("conv", dict(
        cin=8, cout=12, k=3, padding=2, dilation=2, groups=2, q=dict(
            weight_quantize_type="channel_wise_abs_max")), (2, 8, 11, 11)),
    "conv groups 4 stride (2, 1)": ("conv", dict(
        cin=8, cout=8, k=3, stride=(2, 1), padding=(1, 0), groups=4),
        (1, 8, 12, 9)),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_int8_codes_and_accumulators_are_the_references(case):
    """Same weights and inputs: the calibrated scale, the activation's
    codes, the frozen weight codes and scales, and the int32
    accumulators bitwise the reference's; the outputs within 1e-6."""
    kind, kw, shape = LAYER_CASES[case]
    paddle.seed(5)
    ref, port = _ref_quanted(kind, **kw), _port_quanted(kind, **kw)
    carry(ref, port)
    rs = np.random.RandomState(6)
    calib = [(rs.randn(*shape) * 1.5).astype(np.float32) for _ in range(2)]
    for layer, wrap in ((ref, rt), (port, pt)):
        layer.mode = "calib"
        layer.act_observer = type(layer.act_observer)()
        for c in calib:
            layer(wrap(c))
        layer.convert()
    assert port._a_scale_frozen == ref._a_scale_frozen
    np.testing.assert_array_equal(pnp(port._wq), rnp(ref._wq))
    np.testing.assert_array_equal(pnp(port._w_scale_frozen),
                                  rnp(ref._w_scale_frozen))
    x = (rs.randn(*shape) * 1.5).astype(np.float32)
    xq = PS.quantize_symmetric(pt(x), port._a_scale_frozen)
    rxq = RS.quantize_symmetric(jnp.asarray(x), ref._a_scale_frozen)
    np.testing.assert_array_equal(pnp(xq), rnp(rxq))
    acc = port._contract_int8(xq)
    racc = ref._contract(rxq, ref._wq, preferred=jnp.int32)
    assert acc.dtype == torch.int32 and racc.dtype == jnp.int32
    np.testing.assert_array_equal(pnp(acc), rnp(racc))
    np.testing.assert_allclose(pnp(port(pt(x))), rnp(ref(rt(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("algo", ["abs_max", "moving_average_abs_max",
                                  "hist"])
def test_observer_scales_match_reference(algo):
    rs = np.random.RandomState(8)
    batches = [(rs.randn(4, 3, 40, 40) * (1 + i)).astype(np.float32)
               for i in range(3)]
    p = PS._OBSERVERS[algo]()
    r = RS._OBSERVERS[algo]()
    for b in batches:
        p.update(pt(b))
        r.update(jnp.asarray(b))
    np.testing.assert_allclose(p.scale, r.scale, rtol=1e-6)
    if algo == "hist":
        for a, b in zip(p._samples, r._samples):
            np.testing.assert_array_equal(a, b)
        # channels-last storage: the samples follow the logical order
        q = PS.PercentileObserver()
        q.update(pt(batches[0]).to(memory_format=torch.channels_last))
        np.testing.assert_array_equal(q._samples[0], r._samples[0])


def test_frozen_state_carries_from_the_reference():
    """The reference's state after `convert` (`_wq`, the weight scale,
    the activation scale) through `load_frozen`: the same outputs."""
    kind, kw, shape = LAYER_CASES["conv dilation 2 groups 2"]
    paddle.seed(9)
    ref, port = _ref_quanted(kind, **kw), _port_quanted(kind, **kw)
    carry(ref, port)
    rs = np.random.RandomState(10)
    ref.mode = "calib"
    ref(rt(rs.randn(*shape).astype(np.float32)))
    ref.convert()
    port.load_frozen(rnp(ref._wq), rnp(ref._w_scale_frozen),
                     ref._a_scale_frozen)
    assert port.mode == "int8" and port._wq.dtype == torch.int8
    x = rs.randn(*shape).astype(np.float32)
    np.testing.assert_allclose(pnp(port(pt(x))), rnp(ref(rt(x))),
                               rtol=1e-6, atol=1e-6)


# ---- the reference's cases --------------------------------------------------

class TestPTQ:
    def _data(self, n=64):
        rng = np.random.RandomState(0)
        x = rng.randn(n, 16).astype(np.float32)
        y = (x[:, :4] > 0).argmax(axis=1).astype(np.int64)
        return x, y

    def test_ptq_mlp_close_to_fp32(self):
        x, y = self._data()
        ref, model = mlp_pair(0)
        rl, pl = _train(paddle, ref, x, y, 30), _train(ptt, model, x, y, 30)
        np.testing.assert_allclose(pl, rl, rtol=1e-4)
        fp32 = pnp(model(pt(x)))
        data = [(x[i:i + 16],) for i in range(0, 64, 16)]
        PS.PostTrainingQuantization(model=model, algo="abs_max").quantize(
            data_loader=data)
        RS.PostTrainingQuantization(model=ref, algo="abs_max").quantize(
            data_loader=data)
        assert isinstance(model.fc1, PS.QuantedLinear)
        assert model.fc1.mode == "int8"
        assert model.fc1._wq.dtype == torch.int8
        out = pnp(model(pt(x)))
        assert (out.argmax(1) == fp32.argmax(1)).mean() >= 0.95
        rout = rnp(ref(rt(x)))
        assert (out.argmax(1) == rout.argmax(1)).mean() >= 0.95
        assert np.abs(out - rout).max() < 0.05 * np.abs(rout).max()

    def test_ptq_lenet_conv_int8(self):
        from paddle_tpu.vision.models import LeNet as RLeNet
        from paddle_tpu_torch.vision.models import LeNet
        paddle.seed(7)
        ref, model = RLeNet(), LeNet()
        carry(ref, model)
        rng = np.random.RandomState(0)
        imgs = rng.rand(32, 1, 28, 28).astype(np.float32)
        labels = rng.randint(0, 10, size=(32,)).astype(np.int64)
        rl = _train(paddle, ref, imgs, labels, 25)
        pl = _train(ptt, model, imgs, labels, 25)
        np.testing.assert_allclose(pl, rl, rtol=1e-3)
        model.eval()
        fp32 = pnp(model(pt(imgs)))
        PS.PostTrainingQuantization(model=model, algo="abs_max").quantize(
            data_loader=[(imgs,)], batch_nums=1)
        convs = [m for _, m in model.named_sublayers()
                 if isinstance(m, PS.QuantedConv2D)]
        assert convs and all(c._wq.dtype == torch.int8 for c in convs)
        out = pnp(model(pt(imgs)))
        rel = np.max(np.abs(out - fp32)) / (np.max(np.abs(fp32)) + 1e-9)
        assert rel < 0.15, rel
        assert (out.argmax(1) == fp32.argmax(1)).mean() >= 0.9

    def test_ptq_per_channel_beats_or_matches_per_tensor(self):
        rng = np.random.RandomState(3)
        x = rng.randn(64, 16).astype(np.float32)
        w = rng.randn(16, 8).astype(np.float32)
        w[:, 0] *= 50.0
        errs = {}
        for wq_type in ("abs_max", "channel_wise_abs_max"):
            outs = {}
            for pkg, wrap, mod in ((ptt, pt, PS), (paddle, rt, RS)):
                lin = pkg.nn.Linear(16, 8)
                lin.weight.set_value(wrap(w)) if pkg is paddle else \
                    lin.weight.data.copy_(pt(w))
                lin.bias.set_value(wrap(np.zeros(8, np.float32))) \
                    if pkg is paddle else lin.bias.data.zero_()
                model = pkg.nn.Sequential(lin)
                ref_out = model(wrap(x))
                mod.PostTrainingQuantization(
                    model=model, algo="abs_max",
                    weight_quantize_type=wq_type).quantize(
                    data_loader=[(x,)], batch_nums=1)
                q = model[0]
                assert isinstance(q, mod.QuantedLinear) and q.mode == "int8"
                if wq_type == "channel_wise_abs_max":
                    assert tuple(q._w_scale_frozen.shape) == (1, 8)
                outs[pkg] = (pnp(ref_out) if pkg is ptt else rnp(ref_out),
                             pnp(model(wrap(x))) if pkg is ptt
                             else rnp(model(wrap(x))))
            np.testing.assert_allclose(outs[ptt][1], outs[paddle][1],
                                       rtol=1e-6, atol=1e-6)
            errs[wq_type] = float(np.abs(outs[ptt][1] - outs[ptt][0]).mean())
        assert errs["channel_wise_abs_max"] < errs["abs_max"] * 0.25, errs


def _bn_stack(nn):
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.Conv2D(8, 4, 3, padding=1),
                         nn.BatchNorm2D(4))


class TestFuseConvBN:
    def test_fused_matches_unfused_eval(self):
        paddle.seed(9)
        ref, m = _bn_stack(paddle.nn), _bn_stack(ptt.nn)
        carry(ref, m)
        xs = np.random.RandomState(0).rand(4, 3, 8, 8).astype(np.float32)
        x = pt(xs)
        m.train()
        ref.train()
        for _ in range(3):
            m(x)
            ref(rt(xs))
        m.eval()
        ref.eval()
        unfused = pnp(m(x))
        assert PS.fuse_conv_bn(m) == 2 == RS.fuse_conv_bn(ref)
        out = pnp(m(x))
        np.testing.assert_allclose(out, unfused, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, rnp(ref(rt(xs))), rtol=1e-5,
                                   atol=1e-6)
        PS.PostTrainingQuantization(model=m, algo="abs_max").quantize(
            data_loader=[(xs,)], batch_nums=1)
        convs = [s for _, s in m.named_sublayers()
                 if isinstance(s, PS.QuantedConv2D)]
        assert len(convs) == 2


def test_fuse_conv_bn_resnet18_matches_reference():
    """The same pairs (resnet18's 3 downsample Sequentials) and the
    folded weights within 1e-6 of the reference's."""
    from paddle_tpu.vision.models import resnet18 as rresnet18
    from paddle_tpu_torch.vision.models import resnet18
    paddle.seed(4)
    ref, port = rresnet18(num_classes=10), resnet18(num_classes=10)
    rs = np.random.RandomState(4)
    for layer in ref.sublayers():  # non-trivial running statistics
        if isinstance(layer, paddle.nn.BatchNorm2D):
            c = layer._mean.shape[0]
            layer._mean._value = jnp.asarray(
                rs.randn(c).astype(np.float32) * 0.1)
            layer._variance._value = jnp.asarray(
                rs.rand(c).astype(np.float32) + 0.5)
    carry(ref, port)
    ref.eval()
    port.eval()
    x = rs.rand(2, 3, 32, 32).astype(np.float32)
    unfused = rnp(ref(rt(x)))
    n = PS.fuse_conv_bn(port)
    assert n == RS.fuse_conv_bn(ref) == 3
    got = {k: pnp(v) for k, v in port.state_dict().items()}
    want = {k: rnp(v) for k, v in ref.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # the fused net computes the unfused net's function; the reference's
    # fused net does not (ROADMAP §C 49: its bias-free convs keep
    # `self.bias` None, and the folded bias is never added)
    np.testing.assert_allclose(pnp(port(pt(x))), unfused, rtol=1e-4,
                               atol=1e-4)
    assert np.abs(rnp(ref(rt(x))) - unfused).max() > 0.1


class TestQAT:
    def test_qat_trains_and_converts(self):
        rng = np.random.RandomState(1)
        x = rng.randn(64, 16).astype(np.float32)
        y = (x[:, :4] > 0).argmax(axis=1).astype(np.int64)
        _, model = mlp_pair(1)
        qat = PS.ImperativeQuantAware()
        qat.quantize(model)
        assert isinstance(model.fc1, PS.QuantedLinear)
        assert model.fc1.mode == "qat"
        losses = _train(ptt, model, x, y, 40)
        assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
        assert float(model.fc1.act_scale) > 0
        qat_out = pnp(model(pt(x)))
        qat.convert(model)
        assert model.fc1.mode == "int8"
        int8_out = pnp(model(pt(x)))
        assert (int8_out.argmax(1) == qat_out.argmax(1)).mean() >= 0.95

    def test_qat_weight_scale_tracks_drift(self):
        lin = ptt.nn.Linear(4, 4, bias_attr=False)
        w0 = np.eye(4, dtype=np.float32)
        lin.weight.data.copy_(pt(w0))
        q = PS.QuantedLinear(lin, mode="qat")
        x = torch.ones(2, 4)
        y0 = pnp(q(x))
        lin.weight.data.copy_(pt(w0 * 10.0))
        y1 = pnp(q(x))
        np.testing.assert_allclose(y1, y0 * 10.0, rtol=0.05)

    def test_qat_observer_collects_under_jit(self):
        """Through `paddle.Model`'s fused step (`torch.func.functional_call`
        over the parameters, the port's compiled-step path) the
        `act_scale` buffer collects the range, and a larger batch moves
        it up."""
        _, net = mlp_pair(2)
        PS.ImperativeQuantAware().quantize(net)
        assert float(net.fc1.act_scale) == 0.0
        m = ptt.Model(net)
        m.prepare(ptt.optimizer.SGD(0.0, parameters=net.parameters()),
                  ptt.nn.CrossEntropyLoss())
        rng = np.random.RandomState(5)
        x = rng.randn(8, 16).astype(np.float32) * 3.0
        y = np.zeros((8, 1), np.int64)
        m.train_batch([x], [y])
        s1 = float(net.fc1.act_scale)
        assert s1 > 0, "observer did not collect in the fused step"
        m.train_batch([x * 4.0], [y])
        s2 = float(net.fc1.act_scale)
        assert s2 > s1, (s1, s2)
        assert np.isfinite(pnp(net(pt(x)))).all()

    def test_qat_eval_does_not_pollute_observer(self):
        q = PS.QuantedLinear(ptt.nn.Linear(4, 4), mode="qat")
        q.train()
        q(torch.ones(2, 4))
        s = float(q.act_scale)
        q.eval()
        q(100.0 * torch.ones(2, 4))
        assert float(q.act_scale) == s

    def test_qat_abs_max_observer_is_running_max(self):
        q = PS.QuantedLinear(ptt.nn.Linear(4, 4), mode="qat",
                             act_observer="abs_max")
        q.train()
        q(torch.full((2, 4), 5.0))
        assert abs(float(q.act_scale) - 5.0) < 1e-6
        q(torch.full((2, 4), 0.1))
        assert abs(float(q.act_scale) - 5.0) < 1e-6

    def test_bad_weight_quantize_type_raises(self):
        with pytest.raises(ValueError):
            PS.ImperativeQuantAware(weight_quantize_type="channel_abs_max")
        with pytest.raises(ValueError):
            PS.PostTrainingQuantization(model=_PMLP(),
                                        weight_quantize_type="typo")

    def test_qat_per_channel_trains(self):
        rng = np.random.RandomState(2)
        x = rng.randn(64, 16).astype(np.float32)
        y = (x[:, :4] > 0).argmax(axis=1).astype(np.int64)
        _, model = mlp_pair(4)
        qat = PS.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max")
        qat.quantize(model)
        losses = _train(ptt, model, x, y, 40)
        assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
        qat.convert(model)
        assert tuple(model.fc1._w_scale_frozen.shape) == (1, 32)
        assert not np.isnan(pnp(model(pt(x)))).any()


@pytest.mark.parametrize("wq_type,act", [
    ("abs_max", "moving_average_abs_max"),
    ("channel_wise_abs_max", "abs_max")])
def test_qat_steps_match_reference(wq_type, act):
    """Five QAT Adam steps of the MLP on the reference's weights: losses,
    parameters and act_scale buffers within 1e-5 of the reference's; the
    quantized state_dict carries across with no name left over."""
    rng = np.random.RandomState(11)
    x = rng.randn(32, 16).astype(np.float32)
    y = (x[:, :4] > 0).argmax(axis=1).astype(np.int64)
    ref, port = mlp_pair(11)
    kw = dict(weight_quantize_type=wq_type, activation_quantize_type=act)
    RS.ImperativeQuantAware(**kw).quantize(ref)
    PS.ImperativeQuantAware(**kw).quantize(port)
    carry(ref, port)
    rl, pl = _train(paddle, ref, x, y, 5), _train(ptt, port, x, y, 5)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    want = {k: rnp(v) for k, v in ref.state_dict().items()}
    got = {k: pnp(v) for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert {"fc1.act_scale", "fc1.inner.weight"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_save_quantized_model_raises_naming_the_roadmap_item(tmp_path):
    """Both save_quantized_models write a jit.save artifact (they raised
    until jit.save of any layer was ported): the loaded int8 program
    gives the converted model's outputs, bit for bit on the CPU."""
    from paddle_tpu_torch.static import InputSpec
    x = pt(np.random.RandomState(1).randn(6, 16).astype(np.float32))
    _, model = mlp_pair(0)
    qat = PS.ImperativeQuantAware()
    qat.quantize(model)
    model(x)  # collect activation ranges
    spec = [InputSpec([None, 16], "float32")]
    qat.save_quantized_model(model, str(tmp_path / "m"), input_spec=spec)
    model.eval()
    assert torch.equal(ptt.jit.load(str(tmp_path / "m"), device="cpu")(x),
                       model(x))
    ptq = PS.PostTrainingQuantization(model=_PMLP(), algo="abs_max")
    ptq.quantize([(np.ones((4, 16), np.float32),)])
    ptq.save_quantized_model(str(tmp_path / "p"), input_spec=spec)
    assert torch.equal(ptt.jit.load(str(tmp_path / "p"), device="cpu")(x),
                       ptq.model(x))

# ---- the deployment twins (test_slim_quant.py's save cases) -----------------

def test_save_quantized_model_deploy_roundtrip(tmp_path):
    """The twin of test_slim_quant.py::TestSlimQuant::
    test_save_quantized_model_deploy_roundtrip: PTQ (abs_max) on the same
    weights and calibration data, then save_quantized_model -> Predictor
    (the handle flow), at two batch sizes. The served outputs equal the
    port's eager int8 model bit for bit and the reference's eager int8
    model within 1e-5 (the int8 codes are the reference's; the float
    rescale sums in another order)."""
    from paddle_tpu.slim import PostTrainingQuantization as RPTQ
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.static import InputSpec
    rng = np.random.RandomState(4)
    calib = [np.asarray(rng.randn(16, 16), np.float32) for _ in range(4)]
    ref, port = mlp_pair(9)
    RPTQ(model=ref, algo="abs_max").quantize(
        data_loader=[(rt(c),) for c in calib])
    ptq = PS.PostTrainingQuantization(model=port, algo="abs_max")
    ptq.quantize(data_loader=[(c,) for c in calib])
    prefix = str(tmp_path / "int8" / "inference")
    ptq.save_quantized_model(prefix,
                             input_spec=[InputSpec([None, 16], "float32")])
    cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    inp = pred.get_input_handle(pred.get_input_names()[0])
    for n in (8, 3):
        x = rng.randn(n, 16).astype(np.float32)
        inp.copy_from_cpu(x)
        assert pred.run()
        served = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_array_equal(served, pnp(port(pt(x))))
        np.testing.assert_allclose(served, rnp(ref(rt(x))), rtol=1e-5,
                                   atol=1e-5)


def test_qat_save_quantized_model_roundtrip(tmp_path):
    """The twin of test_slim_quant.py::TestSlimQuant::
    test_qat_save_quantized_model_roundtrip: 3 SGD steps of QAT on the
    same weights and data, then save_quantized_model (convert, then
    save); jit.load's output equals the converted port model bit for bit
    and the reference's converted model within 1e-4 (three float32 steps
    apart)."""
    from paddle_tpu.slim import ImperativeQuantAware as RQAT
    from paddle_tpu_torch.static import InputSpec
    rng = np.random.RandomState(5)
    ref, port = mlp_pair(10)
    rqat = RQAT()
    rqat.quantize(ref)
    qat = PS.ImperativeQuantAware()
    qat.quantize(port)
    carry(ref, port)
    x = rng.randn(32, 16).astype(np.float32)
    for pkg, model, xin in ((paddle, ref, rt(x)), (ptt, port, pt(x))):
        sgd = pkg.optimizer.SGD(learning_rate=0.01,
                                parameters=model.parameters())
        for _ in range(3):
            loss = model(xin).square().mean()
            loss.backward()
            sgd.step()
            sgd.clear_grad()
        model.eval()
    prefix = str(tmp_path / "qat8" / "inference")
    qat.save_quantized_model(port, prefix,
                             input_spec=[InputSpec([None, 16], "float32")])
    rqat.convert(ref)
    out = ptt.jit.load(prefix, device="cpu")(pt(x))
    np.testing.assert_array_equal(pnp(out), pnp(port(pt(x))))
    np.testing.assert_allclose(pnp(out), rnp(ref(rt(x))), rtol=1e-4,
                               atol=1e-4)
