"""paddle.nn.functional.transformer module path (ref:
nn/functional/transformer.py): `scaled_dot_product_attention`. The
fused ops `fused_multi_head_attention` / `fused_feedforward` are not
ported yet (ROADMAP §A 10 (e2))."""
from ...ops import scaled_dot_product_attention  # noqa: F401

__all__ = ["scaled_dot_product_attention"]
