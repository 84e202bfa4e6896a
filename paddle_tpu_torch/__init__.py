"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package carries
the same functions in PyTorch, slice by slice, and replaces each Pallas
TPU kernel on a ported path with a CUDA C++ kernel written for Hopper
(`csrc/`, built at first use by `ops/kernels.py`).

Slice 1 is the default serving path of `PagedGenerationServer` for a
GPT-2-layout decoder: the weight bridge (`models.gpt2`), the paged KV
pool (`inference.kv_cache`, `inference.kv_quant`), the paged attention
ops and their kernels (`ops.attention`, `ops.kernels`), the decoder
programs (`nn.decode`), the sampler (`sampling`: per-request sampling
and penalties on the reference's PRNG streams) and the server core
(`inference.serving`). Slice 2 is GPT-2 training: the functional
loss (`models.gpt2.build_train_step`), flash attention with its
autograd rule and kernels (`ops.flash_attention`), the loss
(`ops.loss`) and AdamW (`optimizer`). Slices 3-15 add BERT/ERNIE,
long-context training, the Hopper kernels, sampling, the prefix cache,
decode graphs, W8A16, speculation and the seq2seq Transformer. Slice 16
is offline generation: `GPT2.generate` (the dense fixed-cache program of
`models.gpt2_decode`, one CUDA graph per program on the card, and the
paged engine), `models.gpt2.export_generator` and `jit.load` (the
port's own artifact), and the dense `inference.GenerationServer`.
Slice 17 is fault-tolerant, observable serving: `reliability` (fault
plans, the recovery policy, the session journal), `observability`
(metrics, tracing, the flight recorder, the capture tracker, the ops
endpoint) and `utils.watchdog`, with their hooks in both servers.

This package imports `torch` and numpy only — never `jax` and nothing
of `paddle_tpu`. Entry points run on CUDA unless the caller passes
`device="cpu"` (see `device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
