"""paddle.nn.layer.extension module path (the reference's
`nn/layer/extension.py`)."""
from .legacy import RowConv  # noqa: F401

__all__ = ["RowConv"]
