"""Normalization layers: the port of `paddle_tpu/nn/layer/norm.py` as
`Layer`s.

`LayerNorm`: the normalisation over the trailing `normalized_shape` dims
with weight one and bias zero at init, and the reference's default
epsilon 1e-5 (BERT's embedding and MLM norms pass its config's 1e-12;
its encoder norms keep the default). `RMSNorm`, `GroupNorm` (groups of
channels on axis 1), `InstanceNorm1D/2D/3D` (per sample and channel),
`LocalResponseNorm` and `SpectralNorm` (a power-iteration step a call
on the weight it is given, its u / v vectors updated in place) are the
reference's formulas.

`BatchNorm1D/2D/3D`, the fluid-era `BatchNorm(num_channels, act=...)`
and `SyncBatchNorm` (`:80`), with `sync_batch_norm`
(`paddle_tpu/ops/nn_ops.py:564`): the cross-rank statistics over the
mesh's data-parallel ranks. Their running statistics are the buffers
`_mean` / `_variance` (float32), moved as momentum · running + (1 -
momentum) · batch (momentum 0.9, unbiased batch variance).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ... import ops
from ...device import device_guard, resolve_device
from .. import initializer as I
from .layers import Layer


def _ones_zeros(layer, shape, weight_attr, bias_attr, device=None):
    """(weight one, bias zero) parameters of `shape`, None where the attr
    is False."""
    with _on(device):
        w = layer.create_parameter(shape, attr=weight_attr,
                                   default_initializer=I.Constant(1.0)) \
            if weight_attr is not False else None
        b = layer.create_parameter(shape, attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None
    return w, b


def _on(device):
    return device_guard(device) if device is not None \
        else contextlib.nullcontext()


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight, self.bias = _ones_zeros(
            self, self.normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.epsilon,
                              normalized_ndim=len(self.normalized_shape))

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


def _channel_axis(data_format, ndim):
    """The channel dim of a `data_format` input (the reference's rule)."""
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


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    momentum=0.9, epsilon=1e-5, data_format="NCHW",
                    sync_axes=("dp",), mesh=None):
    """Training-mode batch norm with statistics over every rank of
    `sync_axes` of `mesh` (the port of `paddle_tpu/ops/nn_ops.py:564`):
    the float32 moments (sum, sum of squares, count) are summed over
    those axes by one `comm.psum` — differentiable, its backward the
    all-reduced cotangent — and axes of size 1, or absent from the mesh,
    keep the local statistics. The running statistics move toward the
    batch's (unbiased variance) with the reference's momentum. Returns
    (out in x's dtype, new running mean, new running variance)."""
    from ...parallel import comm
    from ...parallel.mesh import resolve_mesh

    mesh = resolve_mesh(mesh)
    c_axis = _channel_axis(data_format, x.dim())
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    xf = x.float()
    n_local = x.numel() // x.shape[c_axis]
    stats = torch.cat([xf.sum(red), (xf * xf).sum(red),
                       xf.new_full((1,), float(n_local))])
    axes = tuple(a for a in (sync_axes or ()) if mesh.size(a) > 1)
    if axes:
        stats = comm.psum(stats, axes, mesh)
    c = x.shape[c_axis]
    s1, s2, n = stats[:c], stats[c:2 * c], stats[2 * c]
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
    new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
    new_var = momentum * running_var + (1 - momentum) * unbiased.detach()
    out = _normalize(xf, mean, var, weight, bias, epsilon, c_axis)
    return out.to(x.dtype), new_mean, new_var


class _BatchNormBase(Layer):
    """Batch norm with the reference's conventions: running statistics
    `_mean` / `_variance` as buffers, updated as momentum * running +
    (1 - momentum) * batch (unbiased variance), weight one and bias zero
    at init, on `device` (None: the default device; "cpu" on request)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight, self.bias = _ones_zeros(self, (num_features,),
                                             weight_attr, bias_attr, dev)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        c = _channel_axis(self.data_format, x.dim())
        if (self.weight is not None and x.dtype != self.weight.dtype) \
                or x.dtype != self._mean.dtype:
            out, mean, var = ops.batch_norm(
                x, self._mean, self._variance, self.weight, self.bias,
                self.training, self.momentum, self.epsilon,
                self.data_format, self.use_global_stats)
            if self.training and not self.use_global_stats:
                with torch.no_grad():
                    self._mean.copy_(mean)
                    self._variance.copy_(var)
            return out
        xm = x.movedim(c, 1)
        if self.training and not self.use_global_stats:
            out = F.batch_norm(xm, self._mean, self._variance, self.weight,
                               self.bias, True, 1.0 - self.momentum,
                               self.epsilon)
        else:
            out = F.batch_norm(xm, self._mean, self._variance, self.weight,
                               self.bias, False, 0.0, self.epsilon)
        return out.movedim(1, c)


class BatchNorm(_BatchNormBase):
    """The fluid-era BatchNorm: an activation fused after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(ops, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics span every rank of the
    layer's `sync_axes` (default ("dp",): the data-parallel ranks, not mp,
    pp or sp, whose shards hold other channels or stages) on `mesh`
    (default: the current mesh; without one, the local batch — the
    reference's eager behaviour). Evaluation, and use_global_stats, read
    the running statistics as BatchNorm does."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, sync_axes=("dp",),
                 mesh=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device)
        self.sync_axes = tuple(sync_axes) if sync_axes else ()
        self.mesh = mesh

    def forward(self, x):
        if not self.training or self.use_global_stats:
            return super().forward(x)
        out, mean, var = sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            self.momentum, self.epsilon, self.data_format, self.sync_axes,
            self.mesh)
        with torch.no_grad():
            self._mean.copy_(mean)
            self._variance.copy_(var)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm below it replaced by a
        SyncBatchNorm holding the same parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            dev = layer._mean.device
            out = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon,
                                data_format=layer.data_format, device=dev)
            with torch.no_grad():
                if layer.weight is not None:
                    out.weight.copy_(layer.weight)
                if layer.bias is not None:
                    out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            tuple(normalized_shape), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return ops.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups, self.num_channels = num_groups, num_channels
        self.epsilon = epsilon
        self.weight, self.bias = _ones_zeros(self, (num_channels,),
                                             weight_attr, bias_attr)

    def forward(self, x):
        return ops.group_norm(x, self.num_groups, self.weight, self.bias,
                              self.epsilon)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = self.bias = None
        else:
            self.weight, self.bias = _ones_zeros(self, (num_features,),
                                                 weight_attr, bias_attr)

    def forward(self, x):
        return ops.instance_norm(x, self.weight, self.bias, self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return ops.local_response_norm(x, self.size, self.alpha, self.beta,
                                       self.k)


class SpectralNorm(Layer):
    """weight / σ, σ the largest singular value of the weight viewed as
    [shape[dim], -1], by `power_iters` power-iteration steps a call from
    the stored u / v (normal(0, 1) at init, not trained)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            (h,), default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.requires_grad_(False)
        self.weight_v = self.create_parameter(
            (w,), default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        w2 = torch.movedim(weight, self.dim, 0).reshape(
            weight.shape[self.dim], -1)
        with torch.no_grad():
            u, v = self.weight_u.clone(), self.weight_v.clone()
            for _ in range(self.power_iters):
                v = w2.T @ u
                v = v / (torch.linalg.vector_norm(v) + self.epsilon)
                u = w2 @ v
                u = u / (torch.linalg.vector_norm(u) + self.epsilon)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / (u @ w2 @ v)


__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "sync_batch_norm", "RMSNorm",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]
