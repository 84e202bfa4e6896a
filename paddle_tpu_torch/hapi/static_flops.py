"""paddle.flops: the FLOPs of one forward, layer by layer (the port of
`paddle_tpu/hapi/static_flops.py`).

One forward of zeros of `input_size` (float32, on the network's device)
in eval mode; a forward hook on every leaf layer records its FLOPs from
its input and output shapes, with the reference's counts: Linear 2 · in
· out a row, a convolution 2 · (cin / groups · kernel) an output
element, a norm 5 an input element, a pool 9 an output element, an
activation 1 an output element, an embedding 0. `custom_ops` maps a
layer class to `fn(layer, input_shape, output_shape) -> flops`. Only the
hooks this function added are removed afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn


def _numel(shape):
    return int(np.prod([d for d in shape if d is not None])) if shape else 0


def _linear(layer, in_shape, out_shape):
    # [.., in] @ [in, out]: 2 * in * out a row
    batch = _numel(out_shape[:-1])
    return 2 * batch * layer.weight.shape[0] * layer.weight.shape[1]


def _conv(layer, in_shape, out_shape):
    return _numel(out_shape) * 2 * _numel(layer.weight.shape[1:])


def _norm(layer, in_shape, out_shape):
    return 5 * _numel(in_shape)  # mean, var, normalize, scale, shift


def _pool(layer, in_shape, out_shape):
    return _numel(out_shape) * 9


def _embedding(layer, in_shape, out_shape):
    return 0  # a gather


def _act(layer, in_shape, out_shape):
    return _numel(out_shape)


_DEFAULT = {nn.Linear: _linear, nn.Conv2D: _conv, nn.Conv3D: _conv,
            nn.Conv2DTranspose: _conv, nn.Embedding: _embedding,
            nn.ReLU: _act, nn.GELU: _act, nn.Sigmoid: _act}
_NORMS = (nn.BatchNorm, nn.BatchNorm1D, nn.BatchNorm2D, nn.BatchNorm3D,
          nn.LayerNorm, nn.GroupNorm, nn.InstanceNorm2D, nn.SyncBatchNorm)
_POOLS = (nn.MaxPool2D, nn.AvgPool2D, nn.AdaptiveAvgPool2D,
          nn.AdaptiveMaxPool2D)


def _shape(x):
    y = x[0] if isinstance(x, (list, tuple)) and x else x
    return tuple(getattr(y, "shape", ()) or ())


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The FLOPs of one forward at `input_size` (module docstring);
    prints the total (and with `print_detail` a per-layer table)."""
    custom_ops = custom_ops or {}
    rows = []

    def hook(layer, inputs, outputs):
        in_shape, out_shape = _shape(inputs), _shape(outputs)
        cls = type(layer)
        if cls in custom_ops:
            fl = custom_ops[cls](layer, in_shape, out_shape)
        elif cls in _DEFAULT:
            fl = _DEFAULT[cls](layer, in_shape, out_shape)
        elif isinstance(layer, _NORMS):
            fl = _norm(layer, in_shape, out_shape)
        elif isinstance(layer, _POOLS):
            fl = _pool(layer, in_shape, out_shape)
        else:
            return
        rows.append((cls.__name__, in_shape, out_shape, int(fl)))

    leaves = [m for _, m in net.named_sublayers() if not m._modules] \
        or [net]
    handles = [m.register_forward_post_hook(hook) for m in leaves]
    params = net.parameters()
    dev = params[0].device if params else torch.device("cpu")
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=dev))
    finally:
        if was_training:
            net.train()
        for h in handles:
            h.remove()

    total = sum(r[3] for r in rows)
    if print_detail:
        print(f"{'Layer':<20}{'Input':<22}"  # cli-print: the flops table
              f"{'Output':<22}{'FLOPs':>14}")
        for name, i, o, fl in rows:
            print(f"{name:<20}{str(i):<22}"  # cli-print
                  f"{str(o):<22}{fl:>14,}")
    print(f"Total Flops: {total}     Total Params: "  # cli-print
          f"{sum(int(np.prod(p.shape)) for p in params)}")
    return total


__all__ = ["flops"]
