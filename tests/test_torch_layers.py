"""CPU twins of the port's `nn` (`paddle_tpu_torch.nn`: `Layer` and the
containers, every layer class of the slice, `functional`, `utils`'
weight norm, `load_reference_state`) against the JAX package's
`paddle_tpu.nn`: every case of `tests/test_layers.py`; for every layer
class, the reference's `named_parameters()` / `state_dict()` keys and
its numbers on the same seeded inputs after `load_reference_state`
carries the reference's weights across (a round trip through each
side's `state_dict`); the semantics of design rule 6 that live in
layers (BatchNorm's momentum, the GRU's gates, conv "SAME" / pair
padding and NHWC, avg_pool's exclusive count, Linear's [in, out]).

Tolerances: outputs rtol 1e-4, atol 1e-5 (float32; convolutions and
recurrences sum in another order); running statistics rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _flat(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res += _flat(o)
        return res
    return [out]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def ref_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def twin(name, args=(), kw=None, inputs=(), train=False, rtol=1e-4,
         atol=1e-5):
    """Build the reference and the port layer, check their keys, carry
    the weights across and compare the outputs on `inputs` (numpy)."""
    kw = kw or {}
    paddle.seed(0)
    ref = getattr(rnn, name)(*args, **kw)
    port = getattr(pnn, name)(*args, **kw)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()], name
    assert list(port.state_dict()) == list(ref.state_dict()), name
    assert load_reference_state(port, ref_state(ref)) == []
    if not train:
        ref.eval()
        port.eval()
    r_in = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in inputs]
    p_in = [ptt.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in inputs]
    got, want = _flat(port(*p_in)), _flat(ref(*r_in))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.shape) == list(_np(w).shape), name
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol,
                                   err_msg=name)
    return ref, port


# ---- the cases of tests/test_layers.py ---------------------------------------

class TestLayerBase:
    def test_parameters_and_naming(self):
        class Net(pnn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = pnn.Linear(4, 8)
                self.fc2 = pnn.Linear(8, 2)

            def forward(self, x):
                return self.fc2(self.fc1(x))

        net = Net()
        names = [n for n, _ in net.named_parameters()]
        assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
        assert len(net.parameters()) == 4
        assert len(net.sublayers()) == 2
        assert [n for n, _ in net.named_sublayers(include_self=True)] == \
            ["", "fc1", "fc2"]
        assert net.full_name().startswith("net_")
        assert net.fc1.weight.param_name.startswith("param_")

    def test_state_dict_roundtrip(self):
        net = pnn.Linear(3, 3)
        sd = net.state_dict()
        net2 = pnn.Linear(3, 3)
        assert net2.set_state_dict(sd) == ([], [])
        np.testing.assert_allclose(_np(net2.weight), _np(net.weight))
        # numpy values and names of parameters (use_structured_name=False)
        by_name = {net.weight.param_name: np.ones((3, 3), np.float32),
                   net.bias.param_name: np.zeros(3, np.float32)}
        missing, _ = net.set_state_dict(by_name, use_structured_name=False)
        assert missing == [] and float(net.weight.sum()) == 9.0

    def test_train_eval_modes(self):
        net = pnn.Sequential(pnn.Linear(4, 4), pnn.Dropout(0.5))
        assert net.training
        net.eval()
        assert not net[1].training
        x = ptt.to_tensor(np.ones((2, 4), np.float32))
        np.testing.assert_allclose(_np(net(x)), _np(net(x)))

    def test_buffers(self):
        bn = pnn.BatchNorm1D(4)
        buf_names = [n for n, _ in bn.named_buffers()]
        assert "_mean" in buf_names and "_variance" in buf_names
        layer = pnn.Layer()
        layer.register_buffer("kept", torch.zeros(2))
        layer.register_buffer("scratch", torch.ones(1), persistable=False)
        assert list(layer.state_dict()) == ["kept", "scratch"]
        assert len(layer.buffers()) == 2

    def test_apply_and_to(self):
        net = pnn.Linear(2, 2)
        net.to(dtype="bfloat16")
        assert net.weight.dtype == ptt.bfloat16
        net.to("float32")
        assert net.weight.dtype == ptt.float32
        seen = []
        pnn.Sequential(net, pnn.ReLU()).apply(lambda m: seen.append(m))
        assert len(seen) == 3

    def test_hooks(self):
        net = pnn.Linear(2, 2)
        calls = []
        h = net.register_forward_post_hook(
            lambda layer, inp, out: calls.append(1))
        pre = net.register_forward_pre_hook(lambda layer, inp: (inp[0] * 0,))
        out = net(ptt.to_tensor(np.ones((1, 2), np.float32)))
        assert calls == [1]
        np.testing.assert_allclose(_np(out), _np(net.bias)[None])
        h.remove()
        pre.remove()
        net(ptt.to_tensor(np.ones((1, 2), np.float32)))
        assert calls == [1]

    def test_layerlist_parameterlist(self):
        ll = pnn.LayerList([pnn.Linear(2, 2) for _ in range(3)])
        ll.append(pnn.Linear(2, 2))
        assert len(ll) == 4 and len(ll.parameters()) == 8
        ll.insert(0, pnn.ReLU())
        assert isinstance(ll[0], pnn.ReLU) and len(ll) == 5
        pl = pnn.ParameterList([ptt.Parameter(torch.zeros(2))])
        pl.append(ptt.Parameter(torch.ones(3)))
        assert len(pl) == 2 and [n for n, _ in pl.named_parameters()] == \
            ["0", "1"]

    def test_create_parameter_reads_param_attr(self):
        layer = pnn.Layer()
        p = layer.create_parameter(
            [3, 2], attr=ptt.ParamAttr(
                name="w", initializer=pnn.initializer.Constant(0.5),
                learning_rate=0.1, trainable=False,
                regularizer=ptt.optimizer.L2Decay(0.01), need_clip=False))
        assert p.param_name == "w" and not p.requires_grad
        assert not p.trainable and not p.need_clip
        assert p.optimize_attr == {"learning_rate": 0.1}
        assert p.regularizer.coeff == 0.01
        assert float(p.sum()) == 3.0 and p.device.type == "cpu"
        assert layer.create_parameter([2], attr=False) is None
        b = layer.create_parameter([2], is_bias=True)
        assert float(b.abs().sum()) == 0.0


class TestLayersNumerics:
    def test_linear_matches_manual(self):
        lin = pnn.Linear(3, 2)
        assert list(lin.weight.shape) == [3, 2]  # [in, out]
        x = f32(4, 3)
        ref = x @ _np(lin.weight) + _np(lin.bias)
        np.testing.assert_allclose(_np(lin(ptt.to_tensor(x))), ref,
                                   rtol=1e-5)
        twin("Linear", (3, 2), inputs=(x,))
        twin("Linear", (3, 2), {"bias_attr": False}, inputs=(x,))

    def test_conv2d_shape_and_torch_parity(self):
        conv = pnn.Conv2D(3, 8, 3, stride=2, padding=1)
        x = f32(2, 3, 16, 16)
        out = conv(ptt.to_tensor(x))
        assert list(out.shape) == [2, 8, 8, 8]
        tconv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
        with torch.no_grad():
            tconv.weight.copy_(conv.weight)
            tconv.bias.copy_(conv.bias)
            ref = tconv(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(_np(out), ref, rtol=1e-4, atol=1e-5)

    def test_conv_transpose_torch_parity(self):
        conv = pnn.Conv2DTranspose(4, 6, 3, stride=2, padding=1,
                                   output_padding=1)
        x = f32(2, 4, 8, 8)
        out = conv(ptt.to_tensor(x))
        tconv = torch.nn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                         output_padding=1)
        with torch.no_grad():
            tconv.weight.copy_(conv.weight)
            tconv.bias.copy_(conv.bias)
            ref = tconv(torch.from_numpy(x)).numpy()
        assert list(out.shape) == list(ref.shape)
        np.testing.assert_allclose(_np(out), ref, rtol=1e-4, atol=1e-5)

    def test_batchnorm_train_and_eval(self):
        bn = pnn.BatchNorm2D(3)
        x = f32(4, 3, 5, 5) * 2 + 1
        o = _np(bn(ptt.to_tensor(x)))
        assert abs(o.mean(axis=(0, 2, 3))).max() < 1e-5
        assert abs(o.var(axis=(0, 2, 3)) - 1).max() < 1e-2
        assert abs(_np(bn._mean)).max() > 0
        bn.eval()
        assert list(bn(ptt.to_tensor(x)).shape) == [4, 3, 5, 5]

    def test_layernorm_torch_parity(self):
        ln = pnn.LayerNorm(8)
        x = f32(2, 4, 8)
        tln = torch.nn.LayerNorm(8)
        with torch.no_grad():
            tln.weight.copy_(ln.weight)
            tln.bias.copy_(ln.bias)
            ref = tln(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(_np(ln(ptt.to_tensor(x))), ref,
                                   rtol=1e-4, atol=1e-5)

    def test_embedding(self):
        emb = pnn.Embedding(10, 4, padding_idx=0)
        ids = ptt.to_tensor(np.array([[1, 0, 3]]))
        out = emb(ids)
        assert list(out.shape) == [1, 3, 4]
        np.testing.assert_allclose(_np(out)[0, 1], np.zeros(4))
        out.sum().backward()
        assert float(emb.weight.grad[0].abs().sum()) == 0.0
        twin("Embedding", (10, 4), {"padding_idx": -1},
             inputs=(np.array([[1, 9, 3]]),))

    def test_pools(self):
        x = ptt.to_tensor(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4))
        np.testing.assert_allclose(_np(pnn.MaxPool2D(2, 2)(x))[0, 0],
                                   [[5, 7], [13, 15]])
        np.testing.assert_allclose(_np(pnn.AvgPool2D(2, 2)(x))[0, 0],
                                   [[2.5, 4.5], [10.5, 12.5]])
        assert float(pnn.AdaptiveAvgPool2D(1)(x)) == 7.5

    def test_activations(self):
        x = ptt.to_tensor(np.float32([-2.0, 0.0, 2.0]))
        np.testing.assert_allclose(_np(pnn.ReLU()(x)), [0, 0, 2])
        np.testing.assert_allclose(_np(pnn.Hardtanh()(x)), [-1, 0, 1])
        assert _np(pnn.GELU()(x))[2] == pytest.approx(1.9545, abs=1e-3)
        np.testing.assert_allclose(
            _np(pnn.Softmax()(ptt.to_tensor(np.float32([[1.0, 1.0]])))),
            [[0.5, 0.5]])

    def test_losses(self):
        ce = pnn.CrossEntropyLoss()
        logits = ptt.to_tensor(np.float32([[10.0, 0.0], [0.0, 10.0]]))
        labels = ptt.to_tensor(np.array([0, 1]))
        assert float(ce(logits, labels)) < 1e-3
        mse = pnn.MSELoss()
        assert float(mse(ptt.to_tensor([1.0, 2.0]),
                         ptt.to_tensor([1.0, 4.0]))) == 2.0
        v = float(pnn.BCEWithLogitsLoss()(ptt.to_tensor([0.0]),
                                          ptt.to_tensor([1.0])))
        assert v == pytest.approx(np.log(2), rel=1e-4)

    def test_rnn_lstm_gru(self):
        x = ptt.to_tensor(f32(2, 5, 4, lo=0, hi=1))
        out, (h, c) = pnn.LSTM(4, 8)(x)
        assert list(out.shape) == [2, 5, 8] and list(h.shape) == [1, 2, 8]
        out, h = pnn.GRU(4, 8, num_layers=2)(x)
        assert list(out.shape) == [2, 5, 8] and list(h.shape) == [2, 2, 8]
        out, h = pnn.SimpleRNN(4, 8, direction="bidirect")(x)
        assert list(out.shape) == [2, 5, 16]

    def test_lstm_cell_matches_scan(self):
        cell = pnn.LSTMCell(4, 8)
        x = f32(2, 3, 4, lo=0, hi=1)
        out, (h, c) = pnn.RNN(cell)(ptt.to_tensor(x))
        assert list(out.shape) == [2, 3, 8]
        # the cell run by RNN equals a one-layer LSTM with its weights
        lstm = pnn.LSTM(4, 8)
        with torch.no_grad():
            for a, b in (("weight_ih", "weight_ih_l0"),
                         ("weight_hh", "weight_hh_l0"),
                         ("bias_ih", "bias_ih_l0"), ("bias_hh", "bias_hh_l0")):
                getattr(lstm, b).copy_(getattr(cell, a))
        out2, _ = lstm(ptt.to_tensor(x))
        np.testing.assert_allclose(_np(out), _np(out2), rtol=1e-5,
                                   atol=1e-6)

    def test_mha_self_attention(self):
        mha = pnn.MultiHeadAttention(16, 4)
        x = ptt.to_tensor(f32(2, 6, 16))
        assert list(mha(x, x, x).shape) == [2, 6, 16]

    def test_transformer_encoder(self):
        enc = pnn.TransformerEncoder(
            pnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0), 2)
        assert list(enc(ptt.to_tensor(f32(2, 6, 16))).shape) == [2, 6, 16]

    def test_transformer_full(self):
        model = pnn.Transformer(d_model=16, nhead=4, num_encoder_layers=1,
                                num_decoder_layers=1, dim_feedforward=32,
                                dropout=0.0)
        out = model(ptt.to_tensor(f32(2, 5, 16)), ptt.to_tensor(f32(2, 3, 16)))
        assert list(out.shape) == [2, 3, 16]

    def test_grad_flows_through_layers(self):
        net = pnn.Sequential(pnn.Linear(4, 8), pnn.Tanh(), pnn.Linear(8, 1))
        net(ptt.to_tensor(f32(3, 4))).sum().backward()
        for p in net.parameters():
            assert p.grad is not None


# ---- every layer class: keys, weights carried across, numbers ---------------

X4 = f32(2, 3, 6, 6, seed=1)
ACTS = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
        "LogSigmoid", "Hardsigmoid", "Hardswish", "Hardtanh", "Swish",
        "Silu", "Mish", "Softplus", "Softsign", "Softshrink", "Hardshrink",
        "Tanhshrink", "ThresholdedReLU", "Tanh", "LeakyReLU", "Softmax",
        "LogSoftmax", "GLU"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_layers(name):
    twin(name, inputs=(f32(3, 4, seed=2) * 3,))


@pytest.mark.parametrize("name,args,kw,inputs", [
    ("PReLU", (3,), {}, (X4,)),
    ("PReLU", (), {"init": 0.1}, (X4,)),
    ("Maxout", (3,), {}, (X4,)),
    ("Identity", (), {}, (X4,)),
    ("Flatten", (), {}, (X4,)),
    ("Unflatten", (1, [1, 3]), {}, (X4,)),
    ("Dropout", (0.3,), {}, (X4,)),
    ("Dropout2D", (0.3,), {}, (X4,)),
    ("AlphaDropout", (0.3,), {}, (X4,)),
    ("Upsample", (), {"scale_factor": 2}, (X4,)),
    ("Upsample", (), {"size": (9, 4), "mode": "bilinear"}, (X4,)),
    ("Upsample", (), {"size": (3, 11), "mode": "bicubic"}, (X4,)),
    ("Upsample", (), {"scale_factor": 2, "data_format": "NHWC"},
     (X4.transpose(0, 2, 3, 1),)),
    ("UpsamplingNearest2D", (), {"size": (4, 9)}, (X4,)),
    ("UpsamplingBilinear2D", (), {"size": (4, 9)}, (X4,)),
    ("Pad1D", ([1, 2],), {"mode": "reflect"}, (X4[0],)),
    ("Pad2D", ([1, 2, 0, 1],), {"mode": "replicate"}, (X4,)),
    ("Pad3D", ([1, 0, 2, 1, 0, 1],), {}, (X4[None],)),
    ("ZeroPad2D", ([1, 1, 2, 0],), {}, (X4,)),
    ("CosineSimilarity", (), {}, (X4, f32(2, 3, 6, 6, seed=3))),
    ("PairwiseDistance", (), {}, (X4, f32(2, 3, 6, 6, seed=3))),
    ("Bilinear", (3, 4, 5), {}, (f32(2, 3), f32(2, 4, seed=1))),
    ("PixelShuffle", (2,), {}, (f32(1, 8, 3, 3),)),
    ("PixelUnshuffle", (2,), {}, (X4,)),
    ("Unfold", (2, 1, 1), {}, (X4,)),
    ("Embedding", (10, 4), {}, (np.array([[1, 0, 9]]),)),
])
def test_common_layers(name, args, kw, inputs):
    twin(name, args, kw, inputs)


@pytest.mark.parametrize("name,args,kw,x", [
    ("Conv1D", (3, 4, 3), {"padding": 1}, X4[:, :, 0]),
    ("Conv1D", (3, 4, 3), {"padding": "SAME", "stride": 2,
                           "data_format": "NLC"},
     X4[:, :, 0].transpose(0, 2, 1)),
    ("Conv2D", (3, 6, 3), {"padding": "SAME", "stride": 2}, X4),
    ("Conv2D", (3, 6, 3), {"padding": [1, 2, 0, 1], "groups": 3}, X4),
    ("Conv2D", (3, 4, 2), {"padding": "VALID", "dilation": 2,
                           "data_format": "NHWC"}, X4.transpose(0, 2, 3, 1)),
    ("Conv2D", (3, 4, (3, 1)), {"padding": [[1, 1], [0, 0]]}, X4),
    ("Conv3D", (3, 2, 2), {"padding": 1}, X4[:, :, None]),
    ("Conv1DTranspose", (3, 4, 3), {"stride": 2, "padding": 1}, X4[:, :, 0]),
    ("Conv2DTranspose", (3, 4, 3), {"stride": 2, "padding": [1, 0, 2, 1]},
     X4),
    ("Conv2DTranspose", (3, 6, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1, "groups": 3}, X4),
    ("Conv2DTranspose", (3, 4, 2), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1)),
    ("Conv3DTranspose", (3, 2, 2), {"stride": 2}, X4[:, :, None]),
])
def test_conv_layers(name, args, kw, x):
    """Conv padding "SAME" / pair lists and data_format NHWC, as the
    reference's lax convolutions (the weight layout never changes)."""
    twin(name, args, kw, (x,))


@pytest.mark.parametrize("name,args,kw,x", [
    ("MaxPool1D", (3, 2, 1), {}, X4[:, :, 0]),
    ("MaxPool2D", (3, 2), {"padding": "SAME"}, X4),
    ("MaxPool2D", (2, 1), {"padding": 1, "data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1)),
    ("MaxPool3D", (2,), {}, X4[None]),
    ("AvgPool1D", (3, 2, 1), {}, X4[:, :, 0]),
    ("AvgPool2D", (3, 2, 1), {}, X4),
    ("AvgPool2D", (3, 2, 1), {"exclusive": False}, X4),
    ("AvgPool2D", (3, 2), {"padding": "SAME"}, X4),
    ("AvgPool3D", (2, 1, 1), {}, X4[None]),
    ("AdaptiveAvgPool1D", (4,), {}, X4[:, :, 0]),
    ("AdaptiveAvgPool2D", ((4, 3),), {}, X4),
    ("AdaptiveAvgPool2D", (4,), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1)),
    ("AdaptiveAvgPool3D", (2,), {}, X4[None]),
    ("AdaptiveMaxPool1D", (4,), {}, X4[:, :, 0]),
    ("AdaptiveMaxPool2D", ((4, 5),), {}, X4),
])
def test_pool_layers(name, args, kw, x):
    twin(name, args, kw, (x,))


@pytest.mark.parametrize("name,args", [
    ("Dropout3D", ()), ("InstanceNorm3D", (3,)), ("GroupNorm", (2, 4)),
    ("SpectralNorm", ([3, 4],)), ("SyncBatchNorm", (3,)),
    ("Conv3DTranspose", (2, 3, 2))])
def test_keys_equal_the_reference(name, args):
    paddle.seed(0)
    ref = getattr(rnn, name)(*args)
    port = getattr(pnn, name)(*args)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert list(port.state_dict()) == list(ref.state_dict())


def test_container_keys_equal_the_reference():
    paddle.seed(0)
    ref = rnn.LayerList([rnn.Linear(2, 3), rnn.Sequential(
        rnn.Conv1D(3, 4, 1), rnn.BatchNorm1D(4))])
    port = pnn.LayerList([pnn.Linear(2, 3), pnn.Sequential(
        pnn.Conv1D(3, 4, 1), pnn.BatchNorm1D(4))])
    assert list(port.state_dict()) == list(ref.state_dict())
    assert load_reference_state(port, ref_state(ref)) == []


def test_avg_pool_exclusive_by_default():
    """exclusive=True divides by the window's cells inside the input
    (ops/nn_ops.py:357-387); torch's default counts the padding."""
    x = np.ones((1, 1, 3, 3), np.float32)
    got = _np(ptt.nn.functional.avg_pool2d(ptt.to_tensor(x), 3, 1, 1))
    np.testing.assert_allclose(got, np.ones((1, 1, 3, 3)))
    assert float(torch.nn.functional.avg_pool2d(torch.from_numpy(x), 3, 1,
                                                1)[0, 0, 0, 0]) < 1.0


@pytest.mark.parametrize("name,args,kw,inputs", [
    ("CrossEntropyLoss", (), {}, (f32(4, 5), np.array([0, 1, 4, 2]))),
    ("CrossEntropyLoss", (), {"label_smoothing": 0.1, "ignore_index": 1},
     (f32(4, 5), np.array([0, 1, 4, 2]))),
    ("MSELoss", (), {"reduction": "sum"}, (f32(3, 2), f32(3, 2, seed=1))),
    ("L1Loss", (), {}, (f32(3, 2), f32(3, 2, seed=1))),
    ("NLLLoss", (), {}, (f32(4, 5), np.array([0, 1, 4, 2]))),
    ("BCELoss", (), {}, (f32(3, 2, lo=0.1, hi=0.9),
                         f32(3, 2, seed=1, lo=0, hi=1))),
    ("BCEWithLogitsLoss", (), {}, (f32(3, 2), f32(3, 2, seed=1, lo=0,
                                                  hi=1))),
    ("KLDivLoss", (), {"reduction": "batchmean"},
     (f32(3, 4), f32(3, 4, seed=1, lo=0.1, hi=1))),
    ("SmoothL1Loss", (), {"delta": 0.5}, (f32(3, 2), f32(3, 2, seed=1))),
    ("MarginRankingLoss", (), {"margin": 0.2},
     (f32(4), f32(4, seed=1), np.float32([1, -1, 1, -1]))),
    ("CosineEmbeddingLoss", (), {}, (f32(3, 4), f32(3, 4, seed=1),
                                     np.array([1, -1, 1]))),
    ("TripletMarginLoss", (), {}, (f32(3, 4), f32(3, 4, seed=1),
                                   f32(3, 4, seed=2))),
    ("CTCLoss", (), {}, (np.log(f32(6, 2, 4, lo=0.05, hi=1) /
                                f32(6, 2, 4, lo=0.05, hi=1).sum(-1,
                                                                keepdims=True)),
                         np.array([[1, 2], [3, 0]]), np.array([6, 5]),
                         np.array([2, 1]))),
])
def test_loss_layers(name, args, kw, inputs):
    twin(name, args, kw, inputs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,args,kw,x,train", [
    ("LayerNorm", ([6, 6],), {"epsilon": 1e-3}, X4, False),
    ("BatchNorm1D", (3,), {}, X4[:, :, 0], True),
    ("BatchNorm2D", (3,), {}, X4, True),
    ("BatchNorm2D", (3,), {"data_format": "NHWC"}, X4.transpose(0, 2, 3, 1),
     True),
    ("BatchNorm2D", (3,), {"momentum": 0.5, "weight_attr": False}, X4,
     False),
    ("BatchNorm3D", (3,), {}, X4[:, :, None], True),
    ("BatchNorm", (3,), {"act": "relu"}, X4, True),
    ("GroupNorm", (3, 3), {}, X4, False),
    ("InstanceNorm2D", (3,), {}, X4, False),
    ("InstanceNorm1D", (3,), {"bias_attr": False}, X4[:, :, 0], False),
    ("LocalResponseNorm", (3,), {}, X4, False),
    ("RMSNorm", (6,), {}, X4, False),
])
def test_norm_layers(name, args, kw, x, train):
    ref, port = twin(name, args, kw, (x,), train=train)
    for b in ("_mean", "_variance"):
        if hasattr(ref, b):  # running statistics moved the same way
            np.testing.assert_allclose(_np(getattr(port, b)),
                                       _np(getattr(ref, b)), rtol=1e-5,
                                       atol=1e-7)


def test_batchnorm_momentum_convention():
    """running = momentum · running + (1 - momentum) · batch, momentum
    0.9 by default, the batch variance unbiased (nn/layer/norm.py:17);
    torch's momentum is the other weight."""
    x = f32(8, 3, lo=0, hi=4)
    bn = pnn.BatchNorm1D(3)
    bn(ptt.to_tensor(x))
    np.testing.assert_allclose(_np(bn._mean), 0.1 * x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(_np(bn._variance),
                               0.9 + 0.1 * x.var(0, ddof=1), rtol=1e-5)


def test_spectral_norm_layer():
    w = f32(4, 6, seed=5)
    ref, port = twin("SpectralNorm", ([4, 6],), {"power_iters": 3}, (w,))
    np.testing.assert_allclose(_np(port.weight_u), _np(ref.weight_u),
                               rtol=1e-4, atol=1e-5)


SEQ = f32(2, 5, 4, seed=7, lo=-1, hi=1)


@pytest.mark.parametrize("name,args,kw,inputs", [
    ("SimpleRNNCell", (4, 6), {}, (SEQ[:, 0],)),
    ("SimpleRNNCell", (4, 6), {"activation": "relu"}, (SEQ[:, 0],)),
    ("LSTMCell", (4, 6), {}, (SEQ[:, 0],)),
    ("GRUCell", (4, 6), {}, (SEQ[:, 0],)),
    ("LSTM", (4, 6), {"num_layers": 2, "direction": "bidirect"}, (SEQ,)),
    ("GRU", (4, 6), {"num_layers": 2}, (SEQ,)),
    ("GRU", (4, 6), {"direction": "bidirect", "time_major": True}, (SEQ,)),
    ("SimpleRNN", (4, 6), {"activation": "relu"}, (SEQ,)),
])
def test_rnn_layers(name, args, kw, inputs):
    """The GRU's r / z / c split and (1 - z)·c + z·h update
    (nn/layer/rnn.py:78-79, 196-197) and the LSTM's i, f, g, o, with the
    reference's weights in the reference's layout."""
    twin(name, args, kw, inputs)


def test_rnn_wrappers():
    paddle.seed(0)
    rcell, rcell_b = rnn.GRUCell(4, 6), rnn.GRUCell(4, 6)
    pcell, pcell_b = pnn.GRUCell(4, 6), pnn.GRUCell(4, 6)
    load_reference_state(pcell, ref_state(rcell))
    load_reference_state(pcell_b, ref_state(rcell_b))
    for r, p in ((rnn.RNN(rcell, is_reverse=True),
                  pnn.RNN(pcell, is_reverse=True)),
                 (rnn.BiRNN(rcell, rcell_b), pnn.BiRNN(pcell, pcell_b))):
        assert list(p.state_dict()) == list(r.state_dict())
        got = _flat(p(ptt.to_tensor(SEQ)))
        want = _flat(r(paddle.to_tensor(SEQ)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-5)


def test_transformer_layers():
    src, tgt = f32(2, 6, 16), f32(2, 4, 16, seed=1)
    mask = np.where(np.arange(6)[None, None, None, :]
                    < np.array([6, 3])[:, None, None, None], 0.0,
                    -1e30).astype(np.float32)
    twin("MultiHeadAttention", (16, 4), {}, (src, src, src, mask))
    twin("MultiHeadAttention", (16, 4), {"need_weights": True},
         (tgt, src, src))
    twin("TransformerEncoderLayer", (16, 4, 32),
         {"dropout": 0.0, "normalize_before": True}, (src, mask))
    paddle.seed(0)
    ref = rnn.TransformerEncoder(rnn.TransformerEncoderLayer(16, 4, 32), 2,
                                 rnn.LayerNorm(16))
    port = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(16, 4, 32), 2,
                                  pnn.LayerNorm(16))
    assert list(port.state_dict()) == list(ref.state_dict())
    twin("TransformerDecoderLayer", (16, 4, 32), {"dropout": 0.0},
         (tgt, src))
    twin("Transformer", (), {"d_model": 16, "nhead": 4,
                             "num_encoder_layers": 1,
                             "num_decoder_layers": 2,
                             "dim_feedforward": 32, "dropout": 0.0},
         (src, tgt))


def test_load_reference_state_round_trip_and_errors():
    paddle.seed(3)
    ref = rnn.Sequential(rnn.Conv2D(3, 4, 3, data_format="NHWC"),
                         rnn.BatchNorm2D(4, data_format="NHWC"),
                         rnn.ReLU())
    port = pnn.Sequential(pnn.Conv2D(3, 4, 3, data_format="NHWC"),
                          pnn.BatchNorm2D(4, data_format="NHWC"),
                          pnn.ReLU())
    state = ref_state(ref)
    load_reference_state(port, state)
    back = {k: v.numpy() for k, v in port.state_dict().items()}
    assert list(back) == list(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    x = X4.transpose(0, 2, 3, 1)
    ref.eval()
    port.eval()
    np.testing.assert_allclose(_np(port(ptt.to_tensor(x))),
                               _np(ref(paddle.to_tensor(x))), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(KeyError):
        load_reference_state(port, {"nope": np.zeros(1)})
    with pytest.raises(ValueError):
        load_reference_state(port, {"0.bias": np.zeros(5, np.float32)})


def test_functional_namespace():
    F, RF = ptt.nn.functional, paddle.nn.functional
    x = f32(2, 3, 4)
    for got, want in (
            (F.layer_norm(ptt.to_tensor(x), [4]),
             RF.layer_norm(paddle.to_tensor(x), [4])),
            (F.sequence_mask(ptt.to_tensor(np.array([1, 3])), 4),
             RF.sequence_mask(paddle.to_tensor(np.array([1, 3])), 4)),
            (F.spectral_norm(ptt.to_tensor(x[0]), power_iters=2),
             RF.spectral_norm(paddle.to_tensor(x[0]), power_iters=2)),
            (F.one_hot(ptt.to_tensor(np.array([0, 2])), 3),
             RF.one_hot(paddle.to_tensor(np.array([0, 2])), 3)),
            (F.label_smooth(ptt.to_tensor(x)),
             RF.label_smooth(paddle.to_tensor(x))),
            (F.normalize(ptt.to_tensor(x)), RF.normalize(paddle.to_tensor(x))),
            (F.glu(ptt.to_tensor(x)), RF.glu(paddle.to_tensor(x))),
            (F.temporal_shift(ptt.to_tensor(f32(4, 4, 2, 2)), 2),
             RF.temporal_shift(paddle.to_tensor(f32(4, 4, 2, 2)), 2)),
            (F.affine_grid(ptt.to_tensor(f32(2, 2, 3)), [2, 1, 3, 4]),
             RF.affine_grid(paddle.to_tensor(f32(2, 2, 3)), [2, 1, 3, 4]))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    grid = f32(2, 3, 3, 2, lo=-1, hi=1)
    for mode, ac in (("bilinear", True), ("nearest", False)):
        np.testing.assert_allclose(
            _np(F.grid_sample(ptt.to_tensor(X4), ptt.to_tensor(grid), mode,
                              align_corners=ac)),
            _np(RF.grid_sample(paddle.to_tensor(X4), paddle.to_tensor(grid),
                               mode, align_corners=ac)), rtol=1e-5, atol=1e-6)
    out, mean, var = F.batch_norm(ptt.to_tensor(X4), torch.zeros(3),
                                  torch.ones(3), training=True)
    r_out, r_mean, r_var = RF.batch_norm(
        paddle.to_tensor(X4), paddle.to_tensor(np.zeros(3, np.float32)),
        paddle.to_tensor(np.ones(3, np.float32)), training=True)
    for g, w in ((out, r_out), (mean, r_mean), (var, r_var)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)


class TestWeightNorm:
    def test_reparam_train_fold(self):
        """weight_norm / remove_weight_norm: exact at init, trains g and
        v as the reference does (5 SGD steps), folds back."""
        from paddle_tpu.nn.utils import weight_norm as r_wn
        from paddle_tpu_torch.nn.utils import (remove_weight_norm,
                                               weight_norm)
        paddle.seed(0)
        ref = rnn.Linear(4, 3)
        lin = pnn.Linear(4, 3)
        load_reference_state(lin, ref_state(ref))
        w0 = _np(lin.weight).copy()
        r_wn(ref, "weight", dim=0)
        weight_norm(lin, "weight", dim=0)
        names = [n for n, _ in lin.named_parameters()]
        assert names == [n for n, _ in ref.named_parameters()]
        assert "weight" not in names
        x = f32(2, 4, lo=0, hi=1)
        np.testing.assert_allclose(_np(lin(ptt.to_tensor(x))),
                                   x @ w0 + _np(lin.bias), rtol=1e-5,
                                   atol=1e-6)
        r_opt = paddle.optimizer.SGD(learning_rate=0.1,
                                     parameters=ref.parameters())
        opt = ptt.optimizer.SGD(learning_rate=0.1,
                                parameters=lin.parameters())
        g0 = _np(lin.weight_g).copy()
        for _ in range(5):
            (lin(ptt.to_tensor(x)) ** 2).mean().backward()
            assert lin.weight_g.grad is not None
            assert lin.weight_v.grad is not None
            opt.step()
            opt.clear_grad()
            (ref(paddle.to_tensor(x)) ** 2).mean().backward()
            r_opt.step()
            r_opt.clear_grad()
        assert not np.allclose(g0, _np(lin.weight_g))
        for n in ("weight_g", "weight_v", "bias"):
            np.testing.assert_allclose(_np(getattr(lin, n)),
                                       _np(getattr(ref, n)), rtol=1e-5,
                                       atol=1e-6)
        trained = _np(lin(ptt.to_tensor(x)))
        remove_weight_norm(lin, "weight")
        assert [n for n, _ in lin.named_parameters()] == ["bias", "weight"]
        np.testing.assert_allclose(_np(lin(ptt.to_tensor(x))), trained,
                                   rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError):
            remove_weight_norm(lin, "weight")
        with pytest.raises(ValueError, match="dim"):
            weight_norm(pnn.Linear(4, 3), "weight", dim=2)
