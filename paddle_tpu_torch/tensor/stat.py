"""paddle.tensor.stat module path (ref: tensor/stat.py)."""
from ..ops import mean, median, std, var  # noqa: F401

__all__ = ["mean", "median", "std", "var"]
