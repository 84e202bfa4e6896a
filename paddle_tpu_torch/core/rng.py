"""Seeding: the port of `paddle_tpu/core/rng.py` onto explicit torch
generators.

One `torch.Generator` for the CPU and one per card (made at first use),
all reseeded by `seed(s)` (with numpy's global generator, as the
reference does). `generator(device)` is the one the random ops, dropout
and the initializers draw from on `device`. `get_rng_state()` /
`set_rng_state(state)` save and restore every generator's state, so a
stream replays exactly under the same seed. The bits are torch's, not
JAX's: random ops are held to the reference by their arithmetic (shape,
dtype, bounds, moments), never bit for bit.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_seed = 0
_gens = {}  # str(torch.device) -> torch.Generator


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def generator(device="cpu") -> torch.Generator:
    """The generator of `device` (made and seeded at first use)."""
    key = _key(device)
    with _lock:
        g = _gens.get(key)
        if g is None:
            g = _gens[key] = torch.Generator(device=key)
            g.manual_seed(_seed)
        return g


def seed(s: int):
    """paddle.seed: reseed every generator (and numpy's global one)."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _gens.values():
            g.manual_seed(_seed)
    np.random.seed(_seed % (2 ** 32))
    return generator("cpu")


def get_rng_state():
    """{"seed": s, "<device>": that generator's state, ...}."""
    with _lock:
        state = {"seed": _seed}
        state.update({k: g.get_state() for k, g in _gens.items()})
    return state


def set_rng_state(state):
    global _seed
    _seed = int(state["seed"])
    for key, st in state.items():
        if key != "seed":
            generator(key).set_state(st)


__all__ = ["generator", "seed", "get_rng_state", "set_rng_state"]
