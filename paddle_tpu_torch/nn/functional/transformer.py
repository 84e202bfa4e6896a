"""paddle.nn.functional.transformer module path (ref:
nn/functional/transformer.py): `scaled_dot_product_attention` and the
fused ops `fused_multi_head_attention` / `fused_feedforward` (their
attention is the dense path, `ops.attention.dense_attention`, as the
reference's is `_xla_attention`)."""
from ...ops import scaled_dot_product_attention  # noqa: F401
from ...ops.attention import (fused_feedforward,  # noqa: F401
                              fused_multi_head_attention)

__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "scaled_dot_product_attention"]
