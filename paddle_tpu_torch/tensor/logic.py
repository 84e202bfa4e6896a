"""paddle.tensor.logic module path (ref: tensor/logic.py)."""
from ..compat import is_empty  # noqa: F401
from ..ops import (  # noqa: F401
    allclose, equal, equal_all, greater_equal, greater_than, isclose,
    less_equal, less_than, logical_and, logical_not, logical_or,
    logical_xor, not_equal,
)

__all__ = ["is_empty", "equal", "equal_all", "greater_equal", "greater_than",
           "less_equal", "less_than", "logical_and", "logical_not",
           "logical_or", "logical_xor", "not_equal", "allclose", "isclose"]
