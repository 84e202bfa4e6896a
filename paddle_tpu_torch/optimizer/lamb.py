"""paddle.optimizer.lamb module path (ref: optimizer/lamb.py)."""
from .optimizer import Lamb  # noqa: F401

__all__ = ["Lamb"]
