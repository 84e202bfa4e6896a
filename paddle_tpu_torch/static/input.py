"""paddle.static.input (ref: static/input.py)."""
from .program import InputSpec, data  # noqa: F401

__all__ = ["data", "InputSpec"]
