"""fluid.layer_helper_base module path (ref: fluid/layer_helper_base.py)."""
from .layer_helper import LayerHelperBase  # noqa: F401

__all__ = ["LayerHelperBase"]
