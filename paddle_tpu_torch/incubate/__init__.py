"""paddle.incubate of the port (the reference's
`paddle_tpu/incubate/__init__.py`, Paddle's python/paddle/incubate/):
the causal-masked softmax, the LookAhead optimizer wrapper, the complex
ops (`complex`), the MultiSlot data generators (`data_generator`), and
the re-exports of `reader` and `distributed.fleet`."""
from __future__ import annotations

import torch


def softmax_mask_fuse_upper_triangle(x):
    """Softmax over the last axis with the upper triangle (key > query)
    masked to -1e30, as the reference's."""
    s = x.shape[-1]
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
    return torch.softmax(torch.where(mask, x, torch.full_like(x, -1e30)),
                         dim=-1)


class LookAhead:
    """Every k inner steps the slow weights move alpha of the way to the
    fast ones and the fast weights take their value (the first k-th step
    only records the slow weights, as the reference's)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._count = 0
        self._slow = None

    @torch.no_grad()
    def step(self):
        self.inner.step()
        self._count += 1
        if self._count % self.k == 0:
            params = self.inner._parameter_list or []
            if self._slow is None:
                self._slow = [p.detach().clone() for p in params]
            else:
                for slow, p in zip(self._slow, params):
                    slow.add_(self.alpha * (p - slow))
                    p.copy_(slow)

    def clear_grad(self):
        self.inner.clear_grad()

    def minimize(self, loss):
        loss.backward()
        self.step()


from .. import reader  # noqa: E402,F401
from . import complex  # noqa: E402,F401,A004
from . import data_generator  # noqa: E402,F401
from ..distributed import fleet  # noqa: E402,F401
