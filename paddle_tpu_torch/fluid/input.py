"""fluid.input module path (ref: fluid/input.py — embedding/one_hot with
1.x signatures)."""
from .layers import embedding, one_hot  # noqa: F401

__all__ = ["embedding", "one_hot"]
