"""Ops of the port: the paged attention ops (`attention`) and the CUDA
kernels behind them (`kernels`)."""
from .attention import paged_decode_attention, ragged_prefill_attention  # noqa: F401

__all__ = ["paged_decode_attention", "ragged_prefill_attention"]
