"""paddle.nn.layer.distance module path (ref: nn/layer/distance.py)."""
from .common import PairwiseDistance  # noqa: F401

__all__ = ["PairwiseDistance"]
