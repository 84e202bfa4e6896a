"""Serving: the paged KV pool and the continuous-batching server."""
from .kv_cache import BlockPoolExhausted, PagedKVCache, blocks_for  # noqa: F401
from .kv_quant import QuantizedKV, kv_encode  # noqa: F401
from .serving import PagedGenerationServer  # noqa: F401

__all__ = ["PagedGenerationServer", "PagedKVCache", "BlockPoolExhausted",
           "blocks_for", "QuantizedKV", "kv_encode"]
