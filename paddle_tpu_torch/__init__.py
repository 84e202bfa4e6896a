"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package carries
the same functions in PyTorch, slice by slice, and replaces each Pallas
TPU kernel on a ported path with a CUDA C++ kernel written for Hopper
(`csrc/`, built at first use by `ops/kernels.py`).

Slice 1 is the default serving path of `PagedGenerationServer` for a
GPT-2-layout decoder: the weight bridge (`models.gpt2`), the paged KV
pool (`inference.kv_cache`, `inference.kv_quant`), the paged attention
ops and their kernels (`ops.attention`, `ops.kernels`), the decoder
programs (`nn.decode`), greedy sampling (`sampling`) and the server
core (`inference.serving`). Slice 2 is GPT-2 training: the functional
loss (`models.gpt2.build_train_step`), flash attention with its
autograd rule and kernels (`ops.flash_attention`), the loss
(`ops.loss`) and AdamW (`optimizer`).

This package imports `torch` and numpy only — never `jax` and nothing
of `paddle_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"` (see `device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
