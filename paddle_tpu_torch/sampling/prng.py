"""Counter-based per-request PRNG streams: `jax.random`'s threefry2x32,
bit for bit, in PyTorch.

The reference draws row r's sampling noise at generation step s from
`jax.random.gumbel(fold_in(PRNGKey(seed_r), s), (V,), float32)`
(`paddle_tpu/sampling/processors.py`, `fold_in_keys` and
`sample_tokens`), with `jax_threefry_partitionable=True`. This module
computes the same keys, the same random bits and the same uniforms, and
the Gumbel noise from them, vectorised over rows:

  * `threefry2x32(k1, k2, x0, x1)` — Threefry-2x32 with 20 rounds (5
    groups of 4, rotations [13, 15, 26, 6] / [17, 29, 16, 24]), key
    injections after each group;
  * `PRNGKey(seed)` for a uint32 seed is the key (0, seed);
  * `fold_in(key, s)` is `threefry2x32(key, 0, s)`, the two output words
    being the new key;
  * the bits of shape (V,) hash the 64-bit counters i = 0..V-1, split
    into (i >> 32, i & 0xFFFFFFFF), and XOR the two output words;
  * `uniform` keeps the top 23 bits as the mantissa of a float in
    [1, 2), subtracts 1, and clamps below at float32's `tiny`;
  * `gumbel` is `-log(-log(u))`.

uint32 words are held in int64 tensors and masked to 32 bits after every
add and shift: torch's `>>` is arithmetic on signed types, and its
uint32 operations are incomplete on CUDA. Every function is pure tensor
arithmetic on its inputs' device, with no host reads, so a decode step
that samples can be captured whole. The bits and uniforms equal JAX's
bitwise on any device; `log` may differ from XLA's by an ulp or two, so
the Gumbel noise agrees within a few ulp.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key (k1, k2). Every argument is an int64 tensor of uint32 values;
    they broadcast. Returns the two output words, int64 in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in_keys(seeds, steps):
    """[R] uint32 request seeds and [R] step counters -> the [R, 2] keys
    `fold_in(PRNGKey(seed_r), step_r)` (int64 words). Counter-based: key
    (r, s) depends only on (seed_r, s)."""
    seeds = seeds.to(torch.int64) & _MASK
    steps = steps.to(torch.int64) & _MASK
    k1, k2 = threefry2x32(torch.zeros_like(seeds), seeds,
                          torch.zeros_like(steps), steps)
    return torch.stack((k1, k2), dim=-1)


def random_bits(keys, n):
    """[R, 2] keys -> [R, n] uint32 random bits (int64), each row
    `jax.random.bits(key_r, (n,), uint32)`."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & _MASK)
    return o0 ^ o1


def uniform(keys, n):
    """[R, 2] keys -> [R, n] float32 in [tiny, 1): each row
    `jax.random.uniform(key_r, (n,), minval=tiny, maxval=1)`, bitwise."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    # a float32 bit pattern in int32 (the low word of the int64)
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(keys, n):
    """[R, 2] keys -> [R, n] float32 Gumbel noise, each row
    `jax.random.gumbel(key_r, (n,), float32)`."""
    return -torch.log(-torch.log(uniform(keys, n)))


__all__ = ["threefry2x32", "fold_in_keys", "random_bits", "uniform",
           "gumbel"]
