"""paddle.onnx.export module path (the reference's `onnx/export.py`)."""


def export(*a, **kw):
    raise NotImplementedError(
        "ONNX export is intentionally not supported, as in the reference: "
        "the deployment artifact is the one paddle_tpu_torch.jit.save "
        "writes, loaded without model classes by jit.load.")


__all__ = ["export"]
