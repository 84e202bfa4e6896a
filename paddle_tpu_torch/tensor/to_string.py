"""paddle.tensor.to_string module path (the reference's
`tensor/to_string.py`)."""
from ..compat import set_printoptions  # noqa: F401

__all__ = ["set_printoptions"]
