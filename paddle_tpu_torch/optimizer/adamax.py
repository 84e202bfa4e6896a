"""paddle.optimizer.adamax module path (ref: optimizer/adamax.py)."""
from .optimizer import Adamax  # noqa: F401

__all__ = ["Adamax"]
