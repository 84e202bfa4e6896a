"""paddle.nn.utils.weight_norm_hook module path (ref:
nn/utils/weight_norm_hook.py)."""
from . import remove_weight_norm, weight_norm  # noqa: F401

__all__ = ["weight_norm", "remove_weight_norm"]
