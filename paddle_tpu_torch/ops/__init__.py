"""Ops of the port: attention (`attention`: the dense op of the training
path and the paged ops of the serving path), flash attention with its
autograd rule (`flash_attention`), the loss (`loss`) and the CUDA kernels
behind them (`kernels`)."""
from .attention import (paged_decode_attention,  # noqa: F401
                        ragged_prefill_attention,
                        scaled_dot_product_attention)
from .loss import cross_entropy  # noqa: F401

__all__ = ["paged_decode_attention", "ragged_prefill_attention",
           "scaled_dot_product_attention", "cross_entropy"]
