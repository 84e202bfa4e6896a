"""paddle.optimizer.adadelta module path (ref: optimizer/adadelta.py)."""
from .optimizer import Adadelta  # noqa: F401

__all__ = ["Adadelta"]
