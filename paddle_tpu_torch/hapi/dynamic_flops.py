"""paddle.hapi.dynamic_flops: the flops counter (`static_flops` holds
the shared implementation)."""
from .static_flops import flops  # noqa: F401

__all__ = ["flops"]
