"""paddle.tensor.tensor module path (ref: tensor/tensor.py): the port's
tensor is `torch.Tensor`."""
from ..core.tensor import Tensor  # noqa: F401

__all__ = ["Tensor"]
