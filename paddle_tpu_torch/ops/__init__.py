"""Ops of the port: attention (`attention`: the dense op of the training
path and the paged ops of the serving path), flash attention with its
autograd rule (`flash_attention`), the losses (`loss`: cross_entropy and
softmax_with_cross_entropy; `chunked_xent`: the vocab-chunked loss), the
top-k (`search`) and the CUDA kernels behind them (`kernels`)."""
from .attention import (paged_decode_attention,  # noqa: F401
                        ragged_prefill_attention,
                        scaled_dot_product_attention)
from .chunked_xent import chunked_softmax_xent  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401

__all__ = ["paged_decode_attention", "ragged_prefill_attention",
           "scaled_dot_product_attention", "cross_entropy",
           "softmax_with_cross_entropy", "chunked_softmax_xent"]
