"""Random ops: the port of `paddle_tpu/ops/random.py`, drawing from the
port's seeded generators (`core.rng.generator(device)`) on the default
device (the `*_like` ops and those with a tensor input: on its device).

The bits are torch's, not JAX's; each op keeps the reference's
distribution, shape and dtype: `uniform` over [min, max), `normal` as
mean + std · N(0, 1) (float32), `truncated_normal` cut at ±2 standard
deviations before scaling, `randint` in [low, high) (int64),
`multinomial` from unnormalised weights, `bernoulli` / `poisson` as
float32.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core import rng
from ..device import resolve_device
from .creation import _shape


def _dt(dtype, default="float32"):
    return dtype_mod.convert_dtype(dtype if dtype is not None else default)


def _new(shape, dtype, device=None):
    dev = resolve_device(device)
    return torch.empty(_shape(shape), dtype=dtype, device=dev), \
        rng.generator(dev)


def uniform(shape, dtype=None, min=-1.0, max=1.0):  # noqa: A002
    t, g = _new(shape, _dt(dtype))
    return t.uniform_(min, max, generator=g)


def rand(shape, dtype=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None):
    t, g = _new(shape, _dt(dtype))
    return t.normal_(0.0, 1.0, generator=g)


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None):
    if shape is None:
        shape = torch.broadcast_shapes(
            *[tuple(v.shape) for v in (mean, std) if torch.is_tensor(v)])
    dev = next((v.device for v in (mean, std) if torch.is_tensor(v)), None)
    t, g = _new(shape, torch.float32, dev)
    return mean + std * t.normal_(0.0, 1.0, generator=g)


gaussian = normal


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(low, high, _shape(shape), dtype=_dt(dtype),
                         device=dev, generator=rng.generator(dev))


def randint_like(x, low=0, high=None, dtype=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape),
                         dtype=_dt(dtype) if dtype else x.dtype,
                         device=x.device, generator=rng.generator(x.device))


def randperm(n, dtype="int64"):
    dev = resolve_device()
    return torch.randperm(n, dtype=_dt(dtype), device=dev,
                          generator=rng.generator(dev))


def bernoulli(x):
    return torch.bernoulli(x, generator=rng.generator(x.device)).float()


def poisson(x):
    return torch.poisson(x, generator=rng.generator(x.device)).float()


def multinomial(x, num_samples=1, replacement=False):
    return torch.multinomial(x, num_samples, replacement,
                             generator=rng.generator(x.device))


def truncated_normal(shape, mean=0.0, std=1.0, dtype=None):
    t, g = _new(shape, _dt(dtype))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t * std + mean


def uniform_random_like(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.empty_like(x).uniform_(min, max,
                                        generator=rng.generator(x.device))


def normal_like(x, mean=0.0, std=1.0):
    return mean + std * torch.empty_like(x).normal_(
        generator=rng.generator(x.device))


def shuffle(x, axis=0):
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=rng.generator(x.device))
    return x.index_select(axis, perm)


def exponential(x, lam=1.0):
    return torch.empty_like(x).exponential_(
        1.0, generator=rng.generator(x.device)) / lam


__all__ = ["uniform", "rand", "randn", "standard_normal", "normal",
           "gaussian", "randint", "randint_like", "randperm", "bernoulli",
           "poisson", "multinomial", "truncated_normal",
           "uniform_random_like", "normal_like", "shuffle", "exponential"]
