"""Normalization layers, the counterparts of `paddle_tpu/nn/layer/
norm.py`'s.

`LayerNorm`: the normalisation over the trailing `normalized_shape` dims
with weight one and bias zero at init, and the reference's default
epsilon 1e-5 (BERT's embedding and MLM norms pass its config's 1e-12;
its encoder norms keep the default).

`BatchNorm1D/2D/3D` and `SyncBatchNorm` (`:80`), with
`sync_batch_norm` (`paddle_tpu/ops/nn_ops.py:564`): the cross-rank
statistics over the mesh's data-parallel ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


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


class _BatchNormBase(nn.Module):
    """Batch norm with the reference's conventions: running statistics
    `_mean` / `_variance` as buffers, updated as momentum * running +
    (1 - momentum) * batch (unbiased variance), weight one and bias zero
    at init, on `device` (None: the first card; "cpu" on request)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        from ...device import resolve_device
        dev = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(num_features, device=dev)) \
            if weight_attr is not False else None
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev)) \
            if bias_attr is not False else None
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        c = _channel_axis(self.data_format, x.dim())
        xm = x.movedim(c, 1)
        if self.training and not self.use_global_stats:
            out = F.batch_norm(xm, self._mean, self._variance, self.weight,
                               self.bias, True, 1.0 - self.momentum,
                               self.epsilon)
        else:
            out = F.batch_norm(xm, self._mean, self._variance, self.weight,
                               self.bias, False, 0.0, self.epsilon)
        return out.movedim(1, c)


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


__all__ = ["LayerNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "sync_batch_norm"]
