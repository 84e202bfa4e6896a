"""Optimizers of the port (the functional Adam/AdamW rules)."""
from .optimizer import Adam, AdamW  # noqa: F401

__all__ = ["Adam", "AdamW"]
