"""paddle.optimizer.sgd module path (ref: optimizer/sgd.py)."""
from .optimizer import SGD  # noqa: F401

__all__ = ["SGD"]
