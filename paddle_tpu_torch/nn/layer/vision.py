"""paddle.nn.layer.vision module path (ref: nn/layer/vision.py)."""
from .common import PixelShuffle  # noqa: F401

__all__ = ["PixelShuffle"]
