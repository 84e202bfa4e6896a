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
    being the new key; `split(key)[i]` is `fold_in(key, i)` (what
    `jax.random.split` gives under `jax_threefry_partitionable`);
  * the bits of shape (V,) hash the 64-bit counters i = 0..V-1, split
    into (i >> 32, i & 0xFFFFFFFF), and XOR the two output words;
  * `uniform` keeps the top 23 bits as the mantissa of a float in
    [1, 2), subtracts 1, and clamps below at float32's `tiny`;
  * bits of a shape (B, V) from ONE key hash the flat counters b·V + v,
    so they are the (B·V,) bits reshaped;
  * `gumbel` is `-log(-log(u))`, each log rounded to float32 as the
    reference rounds it, but computed by `_log`: float64 arithmetic of
    IEEE-exact operations only, so the noise has the same bits on every
    host and on the card (with library logs, which the host picks, one
    machine gave noise on the card 841 ulp from its CPU's).

uint32 words are held in int64 tensors and masked to 32 bits after every
add and shift: torch's `>>` is arithmetic on signed types, and its
uint32 operations are incomplete on CUDA. Every function is pure tensor
arithmetic on its inputs' device, with no host reads, so a decode step
that samples can be captured whole. The bits and uniforms equal JAX's
bitwise on any device; XLA's float32 `log` may differ from a correctly
rounded one by an ulp or two, so the Gumbel noise agrees with the
reference's within a few ulp.

`seed_key`, `split` and `categorical` serve the fixed-cache decode
program (`models/gpt2_decode.py`), which, as the reference's
(`paddle_tpu/models/gpt2.py:610-636, 687`), draws from `key(seed)`,
splits it once a step and samples all of [B, V] from one key:
`jax.random.categorical(key, l)` is `argmax(l + gumbel(key, l.shape))`
in its default "low" mode.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny
_LN2 = 0.6931471805599453
_SQRT_HALF = 0.7071067811865476


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


def _log(x):
    """log of positive normal float32 values, rounded to float32: x =
    m 2^e with m in [sqrt(1/2), sqrt(2)), log x = e ln 2 + 2 atanh(s),
    s = (m - 1) / (m + 1), |s| <= 0.1716, the series to s^11 (truncation
    below 5e-11 of the result), all in float64 from frexp, +, -, * and
    /, which round the same on every host and on the card."""
    m, e = torch.frexp(x.double())
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).double()
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = torch.full_like(s, 1.0 / 11.0)
    for k in (4, 3, 2, 1, 0):
        p = p * s2 + 1.0 / (2 * k + 1)
    return (e * _LN2 + 2.0 * s * p).float()


def gumbel(keys, n):
    """[R, 2] keys -> [R, n] float32 Gumbel noise, each row
    `jax.random.gumbel(key_r, (n,), float32)`: -log(-log(u)) with each
    log rounded to float32, by `_log` (the same bits on every device)."""
    return -_log(-_log(uniform(keys, n)))


def seed_key(seed, device=None):
    """`jax.random.key(seed)` for a uint32 seed: the [2] int64 key words
    (0, seed), on `device`."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key, num=2):
    """[..., 2] keys -> [num, ..., 2]: `jax.random.split(key, num)`,
    whose i-th key is `fold_in(key, i)` = threefry2x32(key, 0, i)."""
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    i = i.reshape((-1,) + (1,) * (key.dim() - 1))
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(i), i)
    return torch.stack((o0, o1), dim=-1)  # one hash for all num keys


def categorical(key, logits):
    """One [2] key over [B, V] float32 logits -> [B] int32 draws:
    `jax.random.categorical(key, logits, axis=-1)`, the argmax of the
    logits plus one Gumbel draw of shape (B, V) from that key (the flat
    counters b·V + v). -inf logits are never drawn."""
    B, V = logits.shape
    g = gumbel(key.reshape(1, 2), B * V).reshape(B, V)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


__all__ = ["threefry2x32", "fold_in_keys", "random_bits", "uniform",
           "gumbel", "seed_key", "split", "categorical"]
