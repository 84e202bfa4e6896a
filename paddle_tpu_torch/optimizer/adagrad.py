"""paddle.optimizer.adagrad module path (ref: optimizer/adagrad.py)."""
from .optimizer import Adagrad  # noqa: F401

__all__ = ["Adagrad"]
