"""paddle.tensor.attribute module path (ref: tensor/attribute.py)."""
from ..compat import rank, shape  # noqa: F401
from ..ops import (imag, is_complex, is_floating_point,  # noqa: F401
                   is_integer, real)

__all__ = ["rank", "shape", "real", "imag", "is_complex", "is_integer",
           "is_floating_point"]
