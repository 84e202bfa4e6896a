"""Neural-network ops: the port of `paddle_tpu/ops/nn_ops.py` —
activations, convolutions and their transposes (1-3-D), pooling,
normalization, dropout, embedding, interpolation and the image
utilities — with the reference's semantics:

  * conv `padding` is an int, one int per spatial dim, a (lo, hi) pair
    per dim (flat or nested), "SAME" (XLA's: the output is ceil(in /
    stride), the odd pad at the end) or "VALID"; `data_format` "NHWC" /
    "NLC" / "NDHWC" puts the channels last (the weight stays [out, in /
    groups, *k]); a transposed conv's weight is [in, out / groups, *k]
    and its asymmetric padding crops the full transposed output;
  * `max_pool*` pad with -inf and `avg_pool*` with zeros; with
    `exclusive=True` (the default) an average divides by the window's
    cells inside the input, where torch's default counts the padding
    (`nn_ops.py:357-387`); "SAME" pools divide by the whole window;
    `ceil_mode` and `return_mask` are accepted and ignored, as the
    reference does; adaptive pools take torch's windows, which are the
    reference's;
  * `batch_norm` returns (out, new running mean, new running variance):
    the batch statistics in training (the running variance moves toward
    the unbiased one) with momentum 0.9 meaning running = 0.9 · running
    + 0.1 · batch (`nn/layer/norm.py:17`); the output keeps x's dtype;
  * `dropout` keeps with probability 1 - p, "upscale_in_train" by
    default, drawing from the port's generator of x's device (or
    `generator=`);
  * `embedding` gives the padding row no gradient; `linear`'s weight is
    [in, out];
  * `interpolate` is `jax.image.resize`'s, which the reference calls:
    "nearest" samples floor((i + 0.5) · in / out), "linear" /
    "bilinear" / "trilinear" / "area" the triangle kernel and "bicubic"
    Keys' cubic (a = -0.5), both at half-pixel centres and widened by
    in / out when shrinking (antialiased); `align_corners` is ignored,
    as there;
  * `grid_sample` / `affine_grid` are the reference's formulas, not
    torch's grid_sample.
`linear` and `conv*` consult `amp`. Library calls (cuBLAS, cuDNN
convolutions and pools) run where they compute the reference's numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import amp
from ..core import rng

# ------------------------------------------------------------ activations ---

relu = F.relu
relu6 = F.relu6
sigmoid = torch.sigmoid
tanh = torch.tanh
log_sigmoid = F.logsigmoid


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def prelu(x, weight):
    w = weight
    if w.numel() > 1:  # per channel on axis 1 (NCHW)
        shape = [1] * x.dim()
        shape[1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return F.celu(x, alpha)


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def hardsigmoid(x, slope=1 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


swish = F.silu
silu = F.silu


def mish(x):
    return x * torch.tanh(F.softplus(x))


def softplus(x, beta=1.0, threshold=20.0):
    return F.softplus(x, beta, threshold)


def softsign(x):
    return x / (1 + torch.abs(x))


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def tanhshrink(x):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, 0.0)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    u = torch.empty_like(x).uniform_(1e-20, 1.0,
                                     generator=rng.generator(x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


# ------------------------------------------------------------------ conv ----

def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(e) for e in v)
    return (int(v),) * n


def _same_pads(size, k, stride, dilation):
    """XLA's "SAME" (lo, hi): output ceil(size / stride), odd pad at the
    end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, nsp, sizes=None, kernel=None, stride=None,
          dilation=None):
    """[(lo, hi)] per spatial dim from any of the reference's padding
    forms."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * nsp
        if p != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        return [_same_pads(sizes[i], kernel[i], stride[i], dilation[i])
                for i in range(nsp)]
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nsp and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(int(e) for e in p) for p in padding]
        return pairs[-nsp:] if len(pairs) > nsp else pairs
    raise ValueError(f"bad padding {padding}")


def _pad_spatial(x, pads, value=0.0):
    """F.pad of the trailing spatial dims of a channels-first x."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _to_first(x, channels_last):
    """x channels-first. On the card a channels-last input stays a view
    (cuDNN's NHWC kernels read it as it lies); on the CPU it is copied
    into NCHW order, so an NHWC model computes bit for bit what the NCHW
    one does, as the reference's does on the CPU."""
    if not channels_last:
        return x
    x = x.movedim(-1, 1)
    if x.device.type != "cpu":
        return x
    # plain NCHW strides even where size-1 dims make the layout ambiguous
    # (a conv would read such a view as channels-last)
    return x.clone(memory_format=torch.contiguous_format)


def _to_last(x, channels_last):
    return x.movedim(1, -1) if channels_last else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv(x, weight, bias, stride, padding, dilation, groups, nsp,
          channels_last, name):
    (x, weight, bias), back = amp.cast_inputs(name, x, weight, bias)
    stride = _ntuple(stride, nsp)
    dilation = _ntuple(dilation, nsp)
    x = _to_first(x, channels_last)
    pads = _pads(padding, nsp, x.shape[2:], weight.shape[2:], stride,
                 dilation)
    if all(lo == hi for lo, hi in pads):
        pad_arg = tuple(lo for lo, _ in pads)
    else:
        x, pad_arg = _pad_spatial(x, pads), 0
    out = _CONV[nsp](x, weight, bias, stride, pad_arg, dilation, groups)
    return back(_to_last(out, channels_last))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format == "NDHWC", "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nsp, channels_last):
    stride = _ntuple(stride, nsp)
    dilation = _ntuple(dilation, nsp)
    opad = _ntuple(output_padding, nsp)
    x = _to_first(x, channels_last)
    k = weight.shape[2:]
    if isinstance(padding, str):
        # the reference's lax padding of the stride-dilated input, as a
        # crop of the full transposed output (output_padding unused)
        eff = [dilation[i] * (k[i] - 1) for i in range(nsp)]
        dil = [(x.shape[2 + i] - 1) * stride[i] + 1 for i in range(nsp)]
        lax = _pads(padding, nsp, dil, [e + 1 for e in eff], [1] * nsp,
                    [1] * nsp)
        crops = [(eff[i] - lax[i][0], eff[i] - lax[i][1])
                 for i in range(nsp)]
    else:
        crops = [(lo, hi - opad[i])
                 for i, (lo, hi) in enumerate(_pads(padding, nsp))]
    if all(lo == hi + opad[i] and lo >= 0 and opad[i] < max(stride[i],
                                                           dilation[i])
           for i, (lo, hi) in enumerate(crops)) and \
            not isinstance(padding, str):
        out = _CONV_T[nsp](x, weight, bias, stride,
                           tuple(lo for lo, _ in crops), opad, groups,
                           dilation)
        return _to_last(out, channels_last)
    out = _CONV_T[nsp](x, weight, None, stride, 0, 0, groups, dilation)
    for i, (lo, hi) in enumerate(crops):
        d = 2 + i
        if lo < 0 or hi < 0:
            flat = [0, 0] * (out.dim() - 1 - d) + [max(-lo, 0), max(-hi, 0)]
            out = F.pad(out, flat)
            lo, hi = max(lo, 0), max(hi, 0)
        out = out.narrow(d, lo, out.shape[d] - lo - hi)
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nsp)
    return _to_last(out, channels_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format == "NLC")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format == "NHWC")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format == "NDHWC")


# --------------------------------------------------------------- pooling ----

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_args(x, nsp, kernel_size, stride, padding):
    kernel = _ntuple(kernel_size, nsp)
    stride = _ntuple(stride if stride is not None else kernel, nsp)
    pads = _pads(padding, nsp, x.shape[2:], kernel, stride, (1,) * nsp)
    return kernel, stride, pads


def _max_pool(x, nsp, kernel_size, stride, padding, channels_last):
    x = _to_first(x, channels_last)
    kernel, stride, pads = _pool_args(x, nsp, kernel_size, stride, padding)
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    out = _MAX_POOL[nsp](_pad_spatial(x, pads, low), kernel, stride)
    return _to_last(out, channels_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    return _max_pool(x, 1, kernel_size, stride, padding, False)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW", return_mask=False):
    return _max_pool(x, 2, kernel_size, stride, padding,
                     data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _max_pool(x, 3, kernel_size, stride, padding,
                     data_format == "NDHWC")


def _avg_pool(x, nsp, kernel_size, stride, padding, exclusive,
              channels_last):
    x = _to_first(x, channels_last)
    kernel, stride, pads = _pool_args(x, nsp, kernel_size, stride, padding)
    out = _AVG_POOL[nsp](_pad_spatial(x, pads), kernel, stride)
    if exclusive and not isinstance(padding, str) and \
            any(lo or hi for lo, hi in pads):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / _AVG_POOL[nsp](_pad_spatial(ones, pads), kernel, stride)
    return _to_last(out, channels_last)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    return _avg_pool(x, 1, kernel_size, stride, padding, exclusive, False)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _avg_pool(x, 2, kernel_size, stride, padding, exclusive,
                     data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCDHW"):
    return _avg_pool(x, 3, kernel_size, stride, padding, exclusive,
                     data_format == "NDHWC")


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _adaptive(x, output_size, nsp, kind, channels_last=False):
    x = _to_first(x, channels_last)
    out = _ADAPTIVE[(kind, nsp)](x, _ntuple(output_size, nsp))
    return _to_last(out, channels_last)


def adaptive_avg_pool1d(x, output_size):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive(x, output_size, 2, "avg", data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive(x, output_size, 3, "avg", data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size):
    return _adaptive(x, output_size, 1, "max")


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive(x, output_size, 2, "max", data_format == "NHWC")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError("adaptive_max_pool3d: return_mask is "
                                  "not supported (as the reference)")
    return _adaptive(x, output_size, 3, "max")


# ------------------------------------------------------------------ norm ----

def _channel_axis(data_format, ndim):
    c = 1 if not data_format.endswith("C") or ndim == 2 else ndim - 1
    if data_format in ("NHWC", "NLC", "NDHWC") and ndim > 2:
        c = ndim - 1
    return c


def _normalize(x, mean, var, weight, bias, epsilon, c_axis):
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """(out in x's dtype, new running mean, new running variance)."""
    c_axis = _channel_axis(data_format, x.dim())
    if training and not use_global_stats:
        red = tuple(i for i in range(x.dim()) if i != c_axis)
        mean = x.mean(red)
        var = x.var(red, correction=0)
        n = x.numel() // x.shape[c_axis]
        unbiased = var.detach() * n / max(n - 1, 1)
        new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
        new_var = momentum * running_var + (1 - momentum) * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    out = _normalize(x, mean, var, weight, bias, epsilon, c_axis)
    return out.to(x.dtype), new_mean, new_var


def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=None,
               normalized_ndim=None):
    """Normalization over the trailing `normalized_ndim` dims (1 by
    default, or x.ndim - begin_norm_axis)."""
    if normalized_ndim is None:
        normalized_ndim = 1 if begin_norm_axis is None \
            else x.dim() - begin_norm_axis
    shape = tuple(x.shape[x.dim() - normalized_ndim:])
    if (weight is None or tuple(weight.shape) == shape) and \
            (bias is None or tuple(bias.shape) == shape):
        return F.layer_norm(x, shape, weight, bias, epsilon)
    axes = tuple(range(x.dim() - normalized_ndim, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    out = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                          + epsilon)
    return out * weight if weight is not None else out


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    shape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(axes, keepdim=True)
    var = xg.var(axes, correction=0, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    sq = torch.square(x)
    half, c = size // 2, x.shape[1]
    ch = torch.arange(c, device=x.device).reshape([1, c] + [1] *
                                                  (x.dim() - 2))
    acc = torch.zeros_like(x)
    for i in range(-half, half + 1):
        valid = (ch >= max(0, -i)) & (ch < c - max(0, i))
        acc = acc + torch.where(valid, torch.roll(sq, i, 1), 0.0)
    return x / torch.pow(k + alpha * acc, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=True), 1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


# --------------------------------------------------------------- dropout ----

def _gen(x, generator):
    return generator if generator is not None else rng.generator(x.device)


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None,
            generator=None):
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" or training else x * (1 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.empty(shape, dtype=x.dtype, device=x.device) \
        .bernoulli_(1.0 - p, generator=_gen(x, generator)).bool()
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    if not training or p == 0.0:
        return x
    c_axis = 1 if data_format in ("NCHW", "NCDHW") else x.dim() - 1
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[c_axis] = x.shape[c_axis]
    keep = torch.empty(shape, dtype=x.dtype, device=x.device) \
        .bernoulli_(1.0 - p, generator=_gen(x, generator)).bool()
    return torch.where(keep, x / (1.0 - p), 0.0)


dropout3d = dropout2d


def alpha_dropout(x, p=0.5, training=True, generator=None):
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.empty_like(x).bernoulli_(
        1.0 - p, generator=_gen(x, generator)).bool()
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


# ---------------------------------------------------- embedding / one-hot ---

def embedding(ids, weight, padding_idx=None, sparse=False):
    if padding_idx is not None:
        vocab = weight.shape[0]
        if not -vocab <= padding_idx < vocab:
            raise ValueError(f"padding_idx must be within [-{vocab}, "
                             f"{vocab}), got {padding_idx}")
        if padding_idx < 0:
            padding_idx += vocab
    return F.embedding(ids.long() if ids.dtype != torch.int64 else ids,
                       weight, padding_idx=padding_idx)


def one_hot(x, num_classes):
    return F.one_hot(x.long(), num_classes).float()


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def linear(x, weight, bias=None):
    """x @ weight + bias, weight [in_features, out_features]."""
    (x, weight, bias), back = amp.cast_inputs("linear", x, weight, bias)
    if bias is not None and x.dim() >= 2:
        y = torch.addmm(bias, x.reshape(-1, x.shape[-1]), weight)
        return back(y.reshape(*x.shape[:-1], weight.shape[-1]))
    y = torch.matmul(x, weight)
    return back(y + bias if bias is not None else y)


# ------------------------------------------------------- image-ish utils ----

def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """[n_in, n_out] weights of jax.image.resize's scale-and-translate
    along one dim (half-pixel centres, antialiased when shrinking)."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    d = torch.abs(f[None, :] - torch.arange(n_in, dtype=torch.float64)
                  [:, None]) / kscale
    w = kernel(d)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    nsp = x.dim() - 2
    channels_last = data_format.endswith("C") and x.dim() > 2
    x = _to_first(x, channels_last)
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * nsp
        size = tuple(int(x.shape[2 + i] * sf[i]) for i in range(nsp))
    else:
        size = _ntuple(size, nsp)
    if mode not in ("nearest", "linear", "bilinear", "trilinear", "area",
                    "bicubic"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    for i in range(nsp):
        d, n_in, n_out = 2 + i, x.shape[2 + i], size[i]
        if n_in == n_out:
            continue
        if mode == "nearest":
            src = torch.floor((torch.arange(n_out, dtype=torch.float32)
                               + 0.5) * n_in / n_out).long()
            x = x.index_select(d, src.clamp_max(n_in - 1).to(x.device))
            continue
        kernel = _keys_cubic if mode == "bicubic" else _triangle
        w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return _to_last(x, channels_last)


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    return F.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    return F.pixel_unshuffle(x, downscale_factor)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    k = _ntuple(kernel_sizes, 2)
    s = _ntuple(strides, 2)
    d = _ntuple(dilations, 2)
    pads = _pads(paddings, 2, x.shape[2:], k, s, d)
    return F.unfold(_pad_spatial(x, pads), k, d, 0, s)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix, iy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        ix, iy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device)[:, None, None, None]
    cidx = torch.arange(c, device=x.device)[None, :, None, None]

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yy = torch.clamp(yy, 0, h - 1).long()
        xx = torch.clamp(xx, 0, w - 1).long()
        out = x[bidx, cidx, yy[:, None], xx[:, None]]
        return torch.where(valid[:, None], out, 0.0)

    if mode == "nearest":
        return sample(torch.round(iy), torch.round(ix))
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1, y0 + 1
    wa, wb = (x1 - ix) * (y1 - iy), (x1 - ix) * (iy - y0)
    wc, wd = (ix - x0) * (y1 - iy), (ix - x0) * (iy - y0)
    return (sample(y0, x0) * wa[:, None] + sample(y1, x0) * wb[:, None]
            + sample(y0, x1) * wc[:, None] + sample(y1, x1) * wd[:, None])


def affine_grid(theta, out_shape, align_corners=True):
    n, _, h, w = out_shape
    dev, dt = theta.device, theta.dtype
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=dev, dtype=dt)
    else:
        ys = (torch.arange(h, device=dev, dtype=dt) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev, dtype=dt) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = torch.abs(x - y) + epsilon
    return torch.pow(torch.sum(torch.pow(d, p), dim=-1, keepdim=keepdim),
                     1.0 / p)


def temporal_shift(x, seg_num, shift_ratio=0.25):
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold], torch.zeros_like(x[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                       x[:, :-1, fold:2 * fold]], dim=1)
    out = torch.cat([left, right, x[:, :, 2 * fold:]], dim=2)
    return out.reshape(nt, c, h, w)


def sync_batch_norm(*args, **kwargs):
    """`nn.layer.norm.sync_batch_norm` under the op name the reference
    binds (`paddle_tpu/ops/nn_ops.py:564`); imported at the call, since
    `nn` imports this module."""
    from ..nn.layer.norm import sync_batch_norm as impl
    return impl(*args, **kwargs)


__all__ = [
    "relu", "relu6", "sigmoid", "tanh", "log_sigmoid", "leaky_relu",
    "prelu", "elu", "selu", "celu", "gelu", "hardsigmoid", "hardswish",
    "hardtanh", "swish", "silu", "mish", "softplus", "softsign",
    "softshrink", "hardshrink", "tanhshrink", "thresholded_relu", "stanh",
    "maxout", "glu", "softmax", "log_softmax", "gumbel_softmax", "conv1d",
    "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "batch_norm",
    "layer_norm", "rms_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize", "dropout", "dropout2d",
    "dropout3d", "alpha_dropout", "embedding", "one_hot", "label_smooth",
    "linear", "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
    "unfold", "grid_sample", "affine_grid", "cosine_similarity",
    "pairwise_distance", "temporal_shift", "sync_batch_norm"]
