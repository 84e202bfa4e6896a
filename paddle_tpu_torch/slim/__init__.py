"""paddle.slim of the port — quantization-aware training (QAT) and int8
post-training quantization (PTQ), the port of `paddle_tpu/slim/__init__.py`
(Paddle's fluid/contrib/slim/quantization: quantization_pass.py's
fake-quant ops, imperative/qat.py, post_training_quantization.py).

  * Codes are the reference's: `clip(round(x / max(scale, 1e-12) * qmax))`,
    divide then multiply (one multiply by qmax / scale moves codes at
    rounding boundaries); `torch.round` rounds half to even, as
    `jnp.round`. A bf16 input quantizes in bf16 arithmetic against a
    Python-float scale, as the reference's weakly typed scale does.
  * `fake_quant` is a straight-through estimator (`_FakeQuant`): the
    gradient passes where |x| <= max(scale, 1e-12); the scale gets zero.
  * QAT's activation range is the registered 0-d buffer `act_scale` (an
    EMA, or with `abs_max` a running max, of max|x|), updated in place
    under no_grad on the device: no host sync in `forward`. Eval mode
    reads the frozen buffer. The weight scale is read from the current
    weight on every QAT forward, per tensor or per output channel (axis
    0 of an OIHW conv weight, the last axis of a Linear's [in, out]).
  * PTQ calibrates through host observers (`abs_max`, the EMA, and
    `hist`: the 99.9th percentile of |x| over samples taken every
    `max(1, n // 4096)`-th element of the logical (NCHW) order, strided
    on the device before the one copy to the host).
  * int8 inference is exact integer arithmetic: the activation's codes
    contract with the frozen int8 weight into int32 accumulators —
    `torch._int_mm` (cuBLASLt on the card), a conv as an int8 im2col
    (strided views, one copy) then `_int_mm` — and `acc.float() *
    ((a_scale / qmax) * w_rescale)` rescales. `_int_mm`'s CUDA shape
    rules (m > 16, k and n multiples of 8) are met by zero codes in k
    (exact) and rows or columns that are dropped; the CPU runs the same
    path. The reference computes this contraction in XLA
    (`preferred_element_type=int32`), not in a Pallas kernel.
  * `fuse_conv_bn` folds each adjacent (Conv2D, BatchNorm2D) pair inside
    a `Sequential`, as the reference's; it reports the count.
  * `save_quantized_model` raises until `jit.save` of an arbitrary layer
    is ported (ROADMAP §A 14.3).

The quantized layers' `state_dict()` is the reference's (`inner.weight`,
`inner.bias`, `act_scale`): `nn.layer.layers.load_reference_state`
carries it across, and `load_frozen` the frozen int8 state (`_wq`, the
weight scale, the activation scale).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn


def _qmax(bits):
    return (1 << (bits - 1)) - 1


def _scale_tensor(scale, like):
    if torch.is_tensor(scale):
        return scale.to(like.device)
    return torch.tensor(scale, dtype=torch.float32, device=like.device)


def quantize_symmetric(x, scale, bits=8):
    """x (float) -> int8/int16 codes with a symmetric scale: a scalar (per
    tensor) or a tensor broadcastable against x (per channel).

    jnp's typing is kept: a Python-number scale takes x's dtype (a bf16 x
    quantizes in bf16), a tensor scale promotes x (a bf16 x against a
    float32 scale quantizes in float32). The divisor is a tensor on x's
    device, so the division is a true division: CUDA divides by a CPU
    scalar as a multiply by its reciprocal, which moves codes."""
    qm = _qmax(bits)
    dt = torch.int8 if bits <= 8 else torch.int16
    if torch.is_tensor(scale):
        safe = torch.clamp_min(scale.to(x.device), 1e-12)
        x = x.to(torch.promote_types(x.dtype, safe.dtype))
    else:
        safe = torch.tensor(max(scale, 1e-12), dtype=torch.float32,
                            device=x.device).to(x.dtype)
    return torch.clamp(torch.round(x / safe * qm), -qm, qm).to(dt)


def dequantize(q, scale, bits=8):
    """Codes -> float32 values (float64 against a float64 scale)."""
    dt = torch.promote_types(torch.float32, scale.dtype) \
        if torch.is_tensor(scale) else torch.float32
    return q.to(dt) * (scale / _qmax(bits))


class _FakeQuant(torch.autograd.Function):
    """Quantize, dequantize; the straight-through gradient."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        ctx.save_for_backward(torch.abs(x) <= torch.clamp_min(scale, 1e-12))
        ctx.scale_shape, ctx.x_dtype = scale.shape, x.dtype
        out = dequantize(quantize_symmetric(x, scale, bits), scale, bits)
        return out.to(torch.promote_types(out.dtype, x.dtype))

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        gx = torch.where(in_range, g, torch.zeros_like(g)).to(ctx.x_dtype)
        return gx, g.new_zeros(ctx.scale_shape), None


def fake_quant(x, scale, bits=8):
    """Quantize -> dequantize with a straight-through gradient (the
    reference's fake_quantize_dequantize ops), per tensor or per channel
    by the scale's shape."""
    return _FakeQuant.apply(x, _scale_tensor(scale, x), bits)


def channel_axes(weight_ndim, kind):
    """Reduction axes of channel_wise_abs_max: a conv weight per output
    channel (OIHW axis 0), a Linear weight per output feature (the last
    axis)."""
    if kind == "conv":
        return tuple(range(1, weight_ndim))
    return tuple(range(weight_ndim - 1))


def weight_scale_of(w, quantize_type, kind):
    """The current weight's scale (a 0-d tensor, or keepdim per channel)."""
    if quantize_type == "channel_wise_abs_max":
        return torch.amax(torch.abs(w), dim=channel_axes(w.dim(), kind),
                          keepdim=True)
    return torch.amax(torch.abs(w))


# ---------------------------------------------------------------- observers

class AbsmaxObserver:
    """Running max(|x|) (algo 'abs_max')."""

    def __init__(self):
        self.scale = 0.0

    def update(self, x):
        self.scale = max(self.scale, float(torch.amax(torch.abs(x))))


class MovingAverageAbsmaxObserver:
    """EMA of per-batch max(|x|) (algo 'moving_average_abs_max')."""

    def __init__(self, momentum=0.9):
        self.momentum = momentum
        self.scale = 0.0
        self._init = False

    def update(self, x):
        cur = float(torch.amax(torch.abs(x)))
        if not self._init:
            self.scale, self._init = cur, True
        else:
            self.scale = self.momentum * self.scale \
                + (1 - self.momentum) * cur


class PercentileObserver:
    """Percentile of |x| over calibration (algo 'hist'): every
    max(1, n // 4096)-th element of |x| in logical order, taken on x's
    device, then copied to the host once."""

    def __init__(self, percentile=99.9):
        self.percentile = percentile
        self._samples = []

    def update(self, x):
        a = torch.abs(x.detach()).reshape(-1)
        if a.numel() > 4096:  # subsample to bound memory
            a = a[::max(1, a.numel() // 4096)]
        if a.dtype == torch.bfloat16:
            a = a.float()
        self._samples.append(a.cpu().numpy())

    @property
    def scale(self):
        if not self._samples:
            return 0.0
        return float(np.percentile(np.concatenate(self._samples),
                                   self.percentile))


_OBSERVERS = {
    "abs_max": AbsmaxObserver,
    "moving_average_abs_max": MovingAverageAbsmaxObserver,
    "hist": PercentileObserver,
}


# ------------------------------------------------------- integer contraction

def _round8(n):
    return -(-n // 8) * 8


def int8_weight_matrix(w2d):
    """A [K, N] int8 weight as `_int_mm`'s right operand: zero codes pad K
    and N to multiples of 8 (exact: they add nothing), stored column-major
    (the transpose of a contiguous [N, K]) — cuBLASLt's int8 kernels take
    that layout ("TN"); with a row-major operand it finds no kernel for
    some shapes."""
    k, n = w2d.shape
    return F.pad(w2d.t(), (0, _round8(k) - k, 0, _round8(n) - n)) \
        .contiguous().t()


def int8_matmul(a, wmat, n):
    """[M, K] int8 codes @ an `int8_weight_matrix` -> [M, n] int32, exact:
    rows are padded past 16 and K to the operand's, and dropped after."""
    m, k = a.shape
    pad_k, pad_m = wmat.shape[0] - k, max(0, 17 - m)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    return torch._int_mm(a.contiguous(), wmat)[:m, :n]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def im2col(x, kernel, stride, padding, dilation):
    """[B, C, H, W] (any dtype, int8 codes here) -> ([B·OH·OW, C·kh·kw]
    columns in (c, i, j) order — an OIHW weight's flattening — and (OH,
    OW)): zero padding, strided views, one copy."""
    (kh, kw), (sh, sw) = kernel, stride
    (ph, pw), (dh, dw) = padding, dilation
    b, c = x.shape[:2]
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    p = x.unfold(2, dh * (kh - 1) + 1, sh).unfold(3, dw * (kw - 1) + 1, sw)
    p = p[..., ::dh, ::dw]                      # [B, C, OH, OW, kh, kw]
    oh, ow = p.shape[2], p.shape[3]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(b * oh * ow, c * kh * kw), \
        (oh, ow)


# ---------------------------------------------------------- quantized layers

class _QuantedBase(nn.Layer):
    """What QuantedLinear and QuantedConv2D share.

    Modes:
    - 'qat': fake-quant the weight (its scale read from the current
      weight) and the input (the `act_scale` buffer), straight-through
      gradients;
    - 'calib': the float forward; the host observer and the buffer
      record the input's range;
    - 'int8': int8 x int8 -> int32 contraction, one rescale.
    """

    _kind = "linear"

    def __init__(self, inner, mode="qat", weight_bits=8, activation_bits=8,
                 act_observer="moving_average_abs_max",
                 weight_quantize_type="abs_max", moving_rate=0.9):
        super().__init__()
        self.inner = inner
        self.mode = mode
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate
        self.act_quantize_type = act_observer
        self.act_observer = _OBSERVERS[act_observer]()
        # 0.0 == not yet seen: abs_max keeps a running max, the others an
        # EMA (hist's percentile observer is calibration-only)
        self.register_buffer("act_scale", torch.zeros(
            (), dtype=torch.float32, device=inner.weight.device))
        self._wq = None
        self._w_scale_frozen = None
        self._a_scale_frozen = None
        self._wmat = None

    # -- activation range tracking ------------------------------------
    @torch.no_grad()
    def _track_act(self, x):
        """The range statistic, updated in place on the buffer's device."""
        cur = torch.amax(torch.abs(x)).to(torch.float32)
        old = self.act_scale
        if self.act_quantize_type == "abs_max":
            new = torch.maximum(old, cur)
        else:
            new = torch.where(
                old > 0,
                self.moving_rate * old + (1 - self.moving_rate) * cur, cur)
        old.copy_(new)
        return old

    def _act_scale_for_eval(self, x):
        """The frozen statistic for eval-mode QAT forwards: eval does not
        move it."""
        buf = self.act_scale
        return torch.where(buf > 0, buf, torch.amax(torch.abs(x.detach())))

    def _calib_scale(self):
        """The best activation scale known at convert time (a float)."""
        host = self.act_observer.scale
        buf = float(self.act_scale)
        return host or buf or 1.0

    # -- subclass hooks -----------------------------------------------
    def _contract(self, x, w):
        raise NotImplementedError

    def _contract_int8(self, xq):
        raise NotImplementedError

    def _weight_matrix(self):
        raise NotImplementedError

    def _add_bias(self, y, bias):
        raise NotImplementedError

    def _per_channel_acc_scale(self, ws):
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------
    @torch.no_grad()
    def convert(self):
        """Freeze to int8: quantize the weight once with its final scale."""
        w = self.inner.weight.detach()
        ws = weight_scale_of(w, self.weight_quantize_type, self._kind)
        self._freeze(quantize_symmetric(w, ws, self.weight_bits), ws,
                     self._calib_scale())
        return self

    def load_frozen(self, wq, w_scale, a_scale):
        """Set the frozen int8 state (the weight's codes, its scale, the
        activation scale) — for instance the reference's after its
        `convert` — and switch to int8 inference."""
        dev = self.inner.weight.device
        self._freeze(torch.as_tensor(np.asarray(wq), device=dev),
                     torch.as_tensor(np.asarray(w_scale), device=dev),
                     float(a_scale))
        return self

    def _freeze(self, wq, w_scale, a_scale):
        self._wq, self._w_scale_frozen = wq, w_scale
        self._a_scale_frozen = a_scale
        self._wmat = self._weight_matrix()
        self.mode = "int8"

    @property
    def w_scale(self):
        if self._w_scale_frozen is not None:
            return float(torch.amax(self._w_scale_frozen))
        return float(torch.amax(torch.abs(self.inner.weight.detach())))

    def forward(self, x):
        if self.mode == "calib":
            self.act_observer.update(x)
            self._track_act(x)
            return self.inner(x)
        if self.mode == "qat":
            a_scale = self._track_act(x) if self.training \
                else self._act_scale_for_eval(x)
            w = self.inner.weight
            ws = weight_scale_of(w.detach(), self.weight_quantize_type,
                                 self._kind)
            y = self._contract(fake_quant(x, a_scale, self.activation_bits),
                               fake_quant(w, ws, self.weight_bits))
            bias = self.inner.bias
            return y if bias is None else self._add_bias(y, bias)
        # int8 inference
        a_scale = self._a_scale_frozen if self._a_scale_frozen is not None \
            else self._calib_scale()
        acc = self._contract_int8(quantize_symmetric(
            x, a_scale, self.activation_bits))
        w_rescale = self._per_channel_acc_scale(
            self._w_scale_frozen / _qmax(self.weight_bits))
        y = acc.to(torch.float32) * \
            ((a_scale / _qmax(self.activation_bits)) * w_rescale)
        if self.inner.bias is not None:
            y = self._add_bias(y, self.inner.bias)
        # a bf16 pipeline gets bf16 back, as the reference's
        return y.to(torch.bfloat16) if x.dtype == torch.bfloat16 else y


class QuantedLinear(_QuantedBase):
    """Linear with per-tensor or per-output-feature (channel_wise_abs_max)
    weight quantization. Weight [in, out]; a channel scale [1, out]
    broadcasts over the weight and the [..., out] output."""

    _kind = "linear"

    def _contract(self, x, w):
        return torch.matmul(x, w)

    def _weight_matrix(self):
        return int8_weight_matrix(self._wq)

    def _contract_int8(self, xq):
        k, n = self._wq.shape
        lead = xq.shape[:-1]
        return int8_matmul(xq.reshape(-1, k), self._wmat, n).reshape(
            *lead, n)

    def _add_bias(self, y, bias):
        return y + bias

    def _per_channel_acc_scale(self, ws):
        return ws.reshape(-1) if ws.dim() else ws


class QuantedConv2D(_QuantedBase):
    """Conv2D counterpart (NCHW, OIHW weights; a channel scale over O)."""

    _kind = "conv"

    def _geometry(self):
        inner = self.inner
        return (_pair(inner.stride), _pair(inner.padding),
                _pair(inner.dilation), inner.groups)

    def _contract(self, x, w):
        st, pd, dl, groups = self._geometry()
        return F.conv2d(x, w, None, st, pd, dl, groups)

    def _weight_matrix(self):
        """One [Cg·kh·kw, Og] operand per group."""
        o, groups = self._wq.shape[0], self.inner.groups
        og = o // groups
        return [int8_weight_matrix(
            self._wq[g * og:(g + 1) * og].reshape(og, -1).t())
            for g in range(groups)]

    def _contract_int8(self, xq):
        st, pd, dl, groups = self._geometry()
        o, _, kh, kw = self._wq.shape
        b = xq.shape[0]
        cols, (oh, ow) = im2col(xq, (kh, kw), st, pd, dl)
        og, kg = o // groups, cols.shape[1] // groups
        acc = torch.cat([int8_matmul(cols[:, g * kg:(g + 1) * kg],
                                     self._wmat[g], og)
                         for g in range(groups)], dim=1) if groups > 1 \
            else int8_matmul(cols, self._wmat[0], o)
        return acc.reshape(b, oh, ow, o).permute(0, 3, 1, 2)

    def _add_bias(self, y, bias):
        return y + bias.reshape(1, -1, 1, 1)

    def _per_channel_acc_scale(self, ws):
        # [O, 1, 1, 1] -> [1, O, 1, 1] against NCHW accumulators
        return ws.reshape(1, -1, 1, 1) if ws.dim() else ws


def _swap(model, mode, weight_bits, activation_bits, act_observer,
          weight_quantize_type="abs_max", moving_rate=0.9):
    """Replace every Linear and Conv2D sublayer in place (by exact type);
    returns the wrappers in traversal order."""
    table = {nn.Linear: QuantedLinear, nn.Conv2D: QuantedConv2D}
    wrapped = []

    def visit(layer):
        for name, child in list(layer.named_children()):
            cls = table.get(type(child))
            if cls is not None:
                q = cls(child, mode=mode, weight_bits=weight_bits,
                        activation_bits=activation_bits,
                        act_observer=act_observer,
                        weight_quantize_type=weight_quantize_type,
                        moving_rate=moving_rate)
                setattr(layer, name, q)
                wrapped.append(q)
            else:
                visit(child)

    visit(model)
    return wrapped


def fuse_conv_bn_weights(w, b, running_mean, running_var, eps, gamma, beta):
    """Fold BatchNorm statistics into conv weights: w' = w·γ/σ per output
    channel, b' = (b - μ)·γ/σ + β."""
    std = torch.sqrt(running_var + eps)
    scale = (gamma / std) if gamma is not None else (1.0 / std)
    w2 = w * scale.reshape(-1, *([1] * (w.dim() - 1)))
    b0 = b if b is not None else torch.zeros_like(running_mean)
    b2 = (b0 - running_mean) * scale + (beta if beta is not None else 0.0)
    return w2, b2


@torch.no_grad()
def fuse_conv_bn(model):
    """Fuse every adjacent (Conv2D, BatchNorm2D) pair inside Sequential
    containers into one Conv2D with folded weights, the BatchNorm replaced
    by Identity (the transform run before PTQ / QAT, so that the int8
    conv sees the deployed weights). Returns the number of pairs."""
    from ..core.tensor import make_parameter

    fused = 0

    def visit(layer):
        nonlocal fused
        if isinstance(layer, nn.Sequential):
            names = [n for n, _ in layer.named_children()]
            i = 0
            while i + 1 < len(names):
                a = getattr(layer, names[i])
                bnl = getattr(layer, names[i + 1])
                if type(a) is nn.Conv2D and isinstance(
                        bnl, (nn.BatchNorm2D, nn.BatchNorm)):
                    w2, b2 = fuse_conv_bn_weights(
                        a.weight, a.bias, bnl._mean, bnl._variance,
                        bnl.epsilon, bnl.weight, bnl.bias)
                    a.weight.copy_(w2)
                    if a.bias is None:
                        a.bias = make_parameter(b2)
                    else:
                        a.bias.copy_(b2)
                    setattr(layer, names[i + 1], nn.Identity())
                    fused += 1
                    i += 2
                    continue
                i += 1
        for child in layer.children():
            visit(child)

    visit(model)
    return fused


def _no_save():
    raise NotImplementedError(
        "save_quantized_model needs jit.save of an arbitrary layer, which "
        "is not ported (ROADMAP §A 14.3); the converted model runs in "
        "process")


def _check_weight_type(weight_quantize_type):
    if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
        raise ValueError(
            f"unsupported weight_quantize_type {weight_quantize_type!r}")


class ImperativeQuantAware:
    """QAT (imperative/qat.py's ImperativeQuantAware): swaps
    Linear / Conv2D for fake-quant wrappers; after training,
    `.convert(model)` gives the int8 inference model."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_layer_type=None):
        _check_weight_type(weight_quantize_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_observer = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate
        self._wrapped = []

    def quantize(self, model):
        self._wrapped = _swap(model, "qat", self.weight_bits,
                              self.activation_bits, self.act_observer,
                              self.weight_quantize_type, self.moving_rate)
        return model

    def convert(self, model):
        for q in self._wrapped:
            q.convert()
        return model

    def save_quantized_model(self, layer, path, input_spec=None, **config):
        _no_save()


class PostTrainingQuantization:
    """PTQ (post_training_quantization.py): calibrate activation
    ranges over sample data, then convert weights and compute to int8."""

    def __init__(self, model=None, algo="hist", weight_bits=8,
                 activation_bits=8, executor=None,
                 weight_quantize_type="channel_wise_abs_max", **kw):
        _check_weight_type(weight_quantize_type)
        self.model = model
        self.algo = {"abs_max": "abs_max", "hist": "hist",
                     "avg": "moving_average_abs_max",
                     "mse": "hist", "KL": "hist"}.get(algo, "abs_max")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self._wrapped = []

    @property
    def act_observer_name(self):
        return self.algo

    def quantize(self, data_loader=None, batch_nums=None):
        """Calibration: run the model over `data_loader`'s batches (each a
        batch or a tuple whose first item is one; tensors or arrays,
        moved to the model's device) with the observers attached, then
        freeze to int8."""
        self._wrapped = _swap(self.model, "calib", self.weight_bits,
                              self.activation_bits, self.act_observer_name,
                              self.weight_quantize_type)
        self.model.eval()
        dev = next(iter(self.model.parameters())).device
        if data_loader is not None:
            with torch.no_grad():
                for i, batch in enumerate(data_loader):
                    x = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    if not torch.is_tensor(x):
                        x = torch.from_numpy(np.asarray(x))
                    self.model(x.to(dev))
                    if batch_nums is not None and i + 1 >= batch_nums:
                        break
        return self.convert()

    def convert(self):
        for q in self._wrapped:
            q.convert()
        return self.model

    def save_quantized_model(self, path, input_spec=None, **config):
        _no_save()


__all__ = ["quantize_symmetric", "dequantize", "fake_quant", "channel_axes",
           "weight_scale_of", "AbsmaxObserver",
           "MovingAverageAbsmaxObserver", "PercentileObserver",
           "QuantedLinear", "QuantedConv2D", "fuse_conv_bn_weights",
           "fuse_conv_bn", "ImperativeQuantAware",
           "PostTrainingQuantization", "int8_matmul", "int8_weight_matrix",
           "im2col"]
