"""fluid.data_feeder module path (ref: fluid/data_feeder.py)."""
from .compat1x import DataFeeder  # noqa: F401

__all__ = ["DataFeeder"]
