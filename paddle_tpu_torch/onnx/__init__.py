"""paddle.onnx of the port (the reference's `paddle_tpu/onnx/`): ONNX
export is not supported, by the reference's design decision; `export`
raises with that guidance. A package, so that both
`paddle.onnx.export(...)` and `from paddle.onnx.export import export`
resolve before raising."""
from .export import export  # noqa: F401

__all__ = ["export"]
