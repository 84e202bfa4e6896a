"""Serving: the paged KV pool, the continuous-batching server and the
dynamic batcher over a fixed-shape decode program."""
from .kv_cache import BlockPoolExhausted, PagedKVCache, blocks_for  # noqa: F401
from .kv_quant import QuantizedKV, kv_encode  # noqa: F401
from .serving import (GenerationServer, PagedGenerationServer,  # noqa: F401
                      RequestMeta, measure_offered_load)

__all__ = ["PagedGenerationServer", "GenerationServer", "RequestMeta",
           "measure_offered_load", "PagedKVCache", "BlockPoolExhausted",
           "blocks_for", "QuantizedKV", "kv_encode"]
