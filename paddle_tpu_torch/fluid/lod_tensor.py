"""fluid.lod_tensor module path (ref: fluid/lod_tensor.py)."""
from .compat1x import create_lod_tensor, create_random_int_lodtensor  # noqa: F401,E501

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]
