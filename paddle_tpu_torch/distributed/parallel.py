"""DataParallel (the port of `paddle_tpu/distributed/parallel.py`).

An `nn.Module` wrapper in the reference's API. Each rank runs the wrapped
layers on its shard of the batch; after `backward`,
`apply_collective_grads()` averages every parameter's gradient over the
world (or `group`) — one all-reduce over a flat buffer — so each rank
holds the full-batch gradient of a mean loss, as the reference's reducer
does. `scale_loss` passes the loss through: per-rank losses are means,
and the average is taken on the gradients.
"""
from __future__ import annotations

import torch
from torch import nn

from .collective import ReduceOp, all_reduce, get_world_size


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every parameter gradient over the group (in place)."""
        grads = [p.grad for p in self._layers.parameters()
                 if p.grad is not None]
        if not grads or get_world_size(self._group) == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce(flat, op=ReduceOp.AVG, group=self._group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state, *a, **k):
        return self._layers.load_state_dict(state, *a, **k)

    @property
    def _inner_layers(self):
        return self._layers


__all__ = ["DataParallel"]
