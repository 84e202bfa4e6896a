"""paddle.optimizer.momentum module path (ref: optimizer/momentum.py)."""
from .optimizer import Momentum  # noqa: F401

__all__ = ["Momentum"]
