"""int8 KV-cache quantization primitives.

A quantized pool stores each K or V vector as int8 codes plus ONE
symmetric absmax scale per stored vector — per (layer, block, row, head)
over the Dh lanes: `scales[l, b, r, h] = max|K[l, b, r, h, :]| / 127`.
Every cache append quantizes only the vectors it writes, so no stored
code ever needs rescaling. Scales live in the compute dtype.

Round-trip bound: symmetric round-to-nearest gives
|x - dequant(quant(x))| <= scale/2 = absmax/254 per element.

The attention ops detect a `QuantizedKV` by its `codes`/`scales`
attributes and dequantize inside the kernel (`csrc/kv_load.cuh`) or
inside the plain version's contractions, so a dequantized copy of the
pool is never built.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QuantizedKV(NamedTuple):
    """One K or V pool quantized: int8 `codes` plus the per-vector
    `scales` buffer (codes.shape[:-1], compute dtype)."""
    codes: Any   # int8  [..., BS, H, Dh]
    scales: Any  # float [..., BS, H]


def kv_encode(t, scale_dtype=None):
    """Quantize `t` [..., Dh] to (int8 codes, per-vector scales [...]).

    Absmax over the last axis in float32 whatever the input dtype;
    zero vectors get the 1e-12 floor, so their codes are 0 and the round
    trip is exact. `torch.round` rounds half to even, as `jnp.round`
    does."""
    sd = t.dtype if scale_dtype is None else scale_dtype
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    sc = amax.clamp_min(1e-12) / 127.0
    codes = torch.round(tf / sc[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), sc.to(sd)


__all__ = ["QuantizedKV", "kv_encode"]
