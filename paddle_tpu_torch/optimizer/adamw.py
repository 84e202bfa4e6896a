"""paddle.optimizer.adamw module path (ref: optimizer/adamw.py)."""
from .optimizer import AdamW  # noqa: F401

__all__ = ["AdamW"]
