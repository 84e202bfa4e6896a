"""The fluid-era functional ops that the legacy layer classes
(`nn/layer/legacy.py`) run: `pool2d`, `pool3d`, `gather_tree`,
`hsigmoid_loss` and `bilinear` (ports of the same functions of
`paddle_tpu/nn/functional/legacy.py`, in the reference's arithmetic;
differentiable through torch's autograd). The rest of that module is
not ported yet (ROADMAP §A 10 (e3)).
"""
from __future__ import annotations

import math

import torch

from ... import ops


def _pool(x, dims, pool_size, pool_type, pool_stride, pool_padding,
          global_pooling, ceil_mode, pool_max, pool_avg):
    if global_pooling:
        return x.mean(dim=dims, keepdim=True) if pool_type == "avg" \
            else x.amax(dim=dims, keepdim=True)
    f = pool_max if pool_type == "max" else pool_avg
    return f(x, pool_size, stride=pool_stride, padding=pool_padding,
             ceil_mode=ceil_mode)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    """1.x pooling over [N, C, H, W]: global mean / max, or
    max_pool2d / avg_pool2d with the given window."""
    return _pool(input, (2, 3), pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, ceil_mode, ops.max_pool2d,
                 ops.avg_pool2d)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCDHW", name=None):
    return _pool(input, (2, 3, 4), pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, ceil_mode, ops.max_pool3d,
                 ops.avg_pool3d)


def gather_tree(ids, parents):
    """Trace beam-search parent pointers back into whole sequences:
    ids, parents [T, B, beam] -> [T, B, beam]."""
    par = parents.to(torch.int64)
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).clone()
    out = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = torch.take_along_dim(ids[t], beam, dim=1)
        beam = torch.take_along_dim(par[t], beam, dim=1)
    return torch.stack(out)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over a complete binary tree: [N, 1] losses.
    Default tree: a label's path is its leaf's heap ancestors over
    ceil(log2(C)) internal nodes, the code its left / right bits."""
    lv = label.reshape(-1).to(torch.int64)
    n_nodes = weight.shape[0]
    if path_table is not None:
        table = path_table.to(torch.int64)
        code = path_code.to(input.dtype)
    else:
        depth = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
        node = lv + num_classes - 1  # the leaf's heap position
        tables, codes = [], []
        for _ in range(depth):
            codes.append((node % 2).to(input.dtype))  # left / right bit
            node = torch.div(node - 1, 2, rounding_mode="floor")
            tables.append(node)
        table = torch.stack(tables[::-1], dim=1)  # [N, depth]
        code = torch.stack(codes[::-1], dim=1)
    valid = (table >= 0) & (table < n_nodes)
    tsafe = table.clamp(0, n_nodes - 1)
    logits = torch.einsum("nd,nkd->nk", input, weight[tsafe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[tsafe]
    logsig = torch.nn.functional.logsigmoid
    lo = torch.where(code > 0.5, logsig(logits), logsig(-logits))
    return -torch.where(valid, lo, torch.zeros_like(lo)).sum(dim=1,
                                                              keepdim=True)


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1ᵀ W_o x2 (+ b_o) for every output o: [B, I], [B, J], [O, I, J]
    -> [B, O]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


__all__ = ["pool2d", "pool3d", "gather_tree", "hsigmoid_loss", "bilinear"]
