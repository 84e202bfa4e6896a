"""paddle.tensor.stat module path (ref: tensor/stat.py)."""
from ..compat import numel  # noqa: F401
from ..ops import mean, median, std, var  # noqa: F401

__all__ = ["numel", "mean", "median", "std", "var"]
