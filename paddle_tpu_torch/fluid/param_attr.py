"""fluid.param_attr module path (ref: fluid/param_attr.py)."""
from ..core.param_attr import ParamAttr  # noqa: F401
from ..static import WeightNormParamAttr  # noqa: F401

__all__ = ["ParamAttr", "WeightNormParamAttr"]
