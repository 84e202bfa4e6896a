"""paddle.optimizer.rmsprop module path (ref: optimizer/rmsprop.py)."""
from .optimizer import RMSProp  # noqa: F401

__all__ = ["RMSProp"]
