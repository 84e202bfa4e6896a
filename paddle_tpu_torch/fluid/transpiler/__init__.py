"""fluid.transpiler package path (ref: fluid/transpiler/) — the 1.x
distribute-transpiler API; implementations live in the fluid compat
layer (DistributeTranspiler lowers to this stack's PS/collective
mechanisms; memory_optimize/release_memory are documented no-ops:
torch's caching allocator plans device memory)."""
from .. import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig, memory_optimize,
    release_memory,
)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "memory_optimize", "release_memory"]
