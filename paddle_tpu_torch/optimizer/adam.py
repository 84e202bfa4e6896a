"""paddle.optimizer.adam module path (ref: optimizer/adam.py)."""
from .optimizer import Adam  # noqa: F401

__all__ = ["Adam"]
