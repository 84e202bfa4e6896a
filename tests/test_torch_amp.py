"""CPU twins of the port's `amp` (`auto_cast` with the reference's white
and black lists, O1 / O2, bfloat16 by default; `GradScaler`; `decorate`)
against the JAX package's `paddle_tpu.amp`: the amp cases of
`tests/test_amp_control_dist.py`, a Linear / conv / einsum / encoder
layer under O1 and O2 against the reference's on the same weights, and
the dtype gate of the attention route (float16 reaches the flash
kernels, as bfloat16 does).

Tolerances: outputs computed in bfloat16 within 1e-2 of the largest
magnitude (the two sides round the products and bias adds in another
order, a bfloat16 ulp); float32 results rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
from paddle_tpu import ops as rops
from paddle_tpu.amp import GradScaler as RGradScaler
from paddle_tpu.amp import auto_cast as r_auto_cast

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import amp
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import ops as pops
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def near(got, want, frac=1e-2):
    g = got.detach().float().numpy()
    w = np.asarray(want.numpy(), np.float32)
    np.testing.assert_allclose(g, w, rtol=0, atol=frac * np.abs(w).max())


def ref_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


class TestAMP:
    def test_autocast_matmul_bf16(self):
        a, b = f32(8, 8), f32(8, 8, seed=1)
        with amp.auto_cast(True):
            out = pops.matmul(ptt.to_tensor(a), ptt.to_tensor(b))
        with r_auto_cast(True):
            rout = rops.matmul(paddle.to_tensor(a), paddle.to_tensor(b))
        assert out.dtype == torch.float32  # computed in bf16, back to f32
        near(out, rout)
        exact = pops.matmul(ptt.to_tensor(a), ptt.to_tensor(b))
        assert not torch.equal(out, exact)
        np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=2e-2)

    def test_blacklist_stays_f32(self):
        x = f32(4, 4)
        with amp.auto_cast(True):
            out = pops.softmax(ptt.to_tensor(x))
            assert not amp.amp_should_cast("softmax")
            assert amp.amp_should_cast("linear")
            assert not amp.amp_should_cast("relu")
        np.testing.assert_allclose(out.numpy(),
                                   pops.softmax(ptt.to_tensor(x)).numpy(),
                                   rtol=1e-6)

    def test_grad_scaler_bf16_passthrough(self):
        lin = pnn.Linear(4, 2)
        o = ptt.optimizer.SGD(0.1, parameters=lin.parameters())
        scaler = amp.GradScaler()
        assert not scaler.is_enable() and scaler.get_scale_ratio() == 1.0
        with amp.auto_cast(True):
            loss = lin(ptt.to_tensor(np.ones((2, 4), np.float32))).sum()
        scaled = scaler.scale(loss)
        assert scaled is loss
        scaled.backward()
        w0 = lin.weight.detach().clone()
        scaler.step(o)
        scaler.update()
        assert lin.weight.grad is not None
        assert not torch.equal(w0, lin.weight)

    def test_decorate_o2(self):
        lin = pnn.Linear(4, 2)
        amp.decorate(lin, level="O2", dtype="bfloat16")
        assert lin.weight.dtype == ptt.bfloat16
        lin2 = pnn.Linear(4, 2)
        opt = ptt.optimizer.SGD(0.1, parameters=lin2.parameters())
        m, o = amp.decorate(lin2, opt, level="O1")
        assert m is lin2 and o is opt and lin2.weight.dtype == torch.float32


def test_grad_scaler_float16_matches_reference():
    """With float16 the scaler scales, unscales, skips a non-finite step
    and moves the scale as the reference's."""
    with amp.auto_cast(True, dtype="float16"):
        scaler = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
    with r_auto_cast(True, dtype="float16"):
        rscaler = RGradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                              decr_every_n_nan_or_inf=1)
    assert scaler.is_enable() and rscaler.is_enable()
    p = ptt.to_tensor([1.0, 2.0], stop_gradient=False)
    opt = ptt.optimizer.SGD(0.5, parameters=[p])
    scales = []
    for bad in (False, False, True, False):
        loss = (p * p).sum() * (float("inf") if bad else 1.0)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        rscaler._found_inf = bad  # what the reference's unscale_ finds
        rscaler.update()
        scales.append((scaler.get_scale_ratio(), rscaler.get_scale_ratio()))
    assert [a for a, _ in scales] == [b for _, b in scales]
    assert [a for a, _ in scales] == [8.0, 16.0, 8.0, 8.0]
    # the first two steps updated p (grad 2p, lr 0.5 -> p·0 = 0), the
    # non-finite one was skipped
    np.testing.assert_allclose(p.detach().numpy(), [0.0, 0.0])
    assert scaler.state_dict()["scale"] == scales[-1][0]


@pytest.mark.parametrize("level,white", [("O1", None), ("O2", None),
                                         ("O1", ["scaled_dot_product_"
                                                 "attention"])])
def test_layers_under_autocast_match_reference(level, white):
    paddle.seed(0)
    ref = rnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0)
    port = pnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0)
    load_reference_state(port, ref_state(ref))
    ref.eval()
    port.eval()
    x = np.random.RandomState(2).randn(2, 5, 16).astype(np.float32)
    mask = np.where(np.arange(5)[None, None, None, :]
                    < np.array([5, 3])[:, None, None, None], 0.0,
                    -1e30).astype(np.float32)
    with amp.auto_cast(level=level, custom_white_list=white):
        out = port(ptt.to_tensor(x), ptt.to_tensor(mask))
    with r_auto_cast(level=level, custom_white_list=white):
        rout = ref(paddle.to_tensor(x), paddle.to_tensor(mask))
    assert out.dtype == torch.float32
    near(out, rout, 2e-2)


def test_conv_einsum_linear_consult_amp():
    w, x = f32(4, 3, 3, 3), f32(2, 3, 6, 6, seed=1)
    with amp.auto_cast():
        out = pops.conv2d(ptt.to_tensor(x), ptt.to_tensor(w), padding=1)
        e = pops.einsum("ij,jk->ik", ptt.to_tensor(x[0, 0]),
                        ptt.to_tensor(x[0, 1]))
        lin = pops.linear(ptt.to_tensor(x[0, 0]), ptt.to_tensor(x[0, 1]))
    with r_auto_cast():
        rout = rops.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                           padding=1)
        re = rops.einsum("ij,jk->ik", paddle.to_tensor(x[0, 0]),
                         paddle.to_tensor(x[0, 1]))
    for got, want in ((out, rout), (e, re)):
        assert got.dtype == torch.float32
        near(got, want)
    assert lin.dtype == torch.float32


def test_float16_attention_takes_the_dense_path(monkeypatch):
    """The flash kernels take float32, bfloat16 and float16
    (`kernels.DTYPE_CODES`), as the reference's gate names no dtype:
    float16 reaches `flash_attention` and, with a per-key mask,
    `flash_attention_bias`, as bfloat16 does (the name is kept from the
    rule it replaced, ROADMAP §C 31), and gives the dense result within
    float16's rounding."""
    from paddle_tpu_torch.ops import attention as A
    calls = []

    def spy(name, fn):
        def f(*a, **k):
            calls.append((name, a[0].dtype))
            return fn(*a, **k)
        return f

    monkeypatch.setattr(A, "flash_attention",
                        spy("flash", A.flash_attention))
    monkeypatch.setattr(A, "flash_attention_bias",
                        spy("flash_bias", A.flash_attention_bias))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 8, 32, generator=g).half()
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 8, dtype=torch.float16)
    out, _ = A.scaled_dot_product_attention(q, k, v)
    out_b, _ = A.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    assert calls == [("flash", torch.float16), ("flash_bias", torch.float16)]
    assert out.dtype == out_b.dtype == torch.float16
    want, _ = A.dense_attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-3)
    np.testing.assert_allclose(out_b.float().numpy(), want.numpy(),
                               atol=2e-3)
    for dt in (torch.float32, torch.bfloat16):
        A.scaled_dot_product_attention(q.to(dt), k.to(dt), v.to(dt))
    assert [c[1] for c in calls[2:]] == [torch.float32, torch.bfloat16]
