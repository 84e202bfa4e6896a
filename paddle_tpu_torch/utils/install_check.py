"""paddle.utils.install_check module path (the reference's
`utils/install_check.py`)."""
from . import run_check  # noqa: F401

__all__ = ["run_check"]
