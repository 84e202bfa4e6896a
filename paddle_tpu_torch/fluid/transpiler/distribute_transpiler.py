"""fluid.transpiler.distribute_transpiler module path (ref:
fluid/transpiler/distribute_transpiler.py)."""
from .. import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401,E501

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]
