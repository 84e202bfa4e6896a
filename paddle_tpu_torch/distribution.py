"""Probability distributions (the port of `paddle_tpu/distribution.py`):
`Uniform`, `Normal`, `Categorical`, `Bernoulli`, `MultivariateNormalDiag`,
`kl_divergence`, `sampling_id`.

Densities, entropies and divergences are the reference's formulas in
float32. Draws come from the port's seeded generators
(`core.rng.generator(device)`; `seed=` nonzero: a generator of that
seed) — torch's bits, not JAX's, so a draw is held to the reference by
its arithmetic (bounds, moments, repeatability under one seed), never
bit for bit. Parameters given as tensors keep their device; others go
to the default device. Categorical and sampling_id draws are int64.

`Categorical(logits)` keeps the reference's semantics: the "logits" are
non-negative WEIGHTS for `sample` / `probs` / `log_prob` (probs = w /
w.sum(), raising on negative or all-zero weights), while `entropy` and
`kl_divergence` read them in softmax space.
"""
from __future__ import annotations

import math

import torch

from .core import dtype as dtype_mod
from .core import rng as rng_mod


def _as(x):
    if torch.is_tensor(x):
        return x.to(torch.float32)
    from .core.tensor import to_tensor
    return to_tensor(x, dtype="float32")


def _gen(device, seed):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return rng_mod.generator(device)


def _shape(shape, *params):
    return tuple(shape) + tuple(torch.broadcast_shapes(
        *(p.shape for p in params)))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _as(low)
        self.high = _as(high)

    def sample(self, shape=(), seed=0):
        dev = self.low.device
        u = torch.rand(_shape(shape, self.low, self.high), device=dev,
                       generator=_gen(dev, seed))
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        v = _as(value)
        lp = -torch.log(self.high - self.low)
        inside = (v >= self.low) & (v < self.high)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _as(loc)
        self.scale = _as(scale)

    def sample(self, shape=(), seed=0):
        dev = self.loc.device
        eps = torch.randn(_shape(shape, self.loc, self.scale), device=dev,
                          generator=_gen(dev, seed))
        return self.loc + self.scale * eps

    def log_prob(self, value):
        v = _as(value)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)
                + torch.zeros_like(self.loc))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Categorical(Distribution):
    """Weights for sample / probs / log_prob, softmax space for entropy
    and kl_divergence (module docstring)."""

    def __init__(self, logits, name=None):
        self.logits = _as(logits)

    @property
    def _weight_probs(self):
        w = self.logits
        s = w.sum(dim=-1, keepdim=True)
        if bool((w < 0).any()) or bool((s <= 0).any()):
            raise ValueError(
                "Categorical logits are non-negative weights with a "
                "positive sum (probs = w / w.sum()); got negative or "
                "all-zero weights")
        return w / s

    def sample(self, shape=(), seed=0):
        p = self._weight_probs
        k = p.shape[-1]
        n = math.prod(shape) if shape else 1
        draws = torch.multinomial(p.reshape(-1, k), n, replacement=True,
                                  generator=_gen(p.device, seed))
        return draws.T.reshape(tuple(shape) + tuple(p.shape[:-1]))

    def probs(self, value=None):
        p = self._weight_probs
        if value is None:
            return p
        idx = (value if torch.is_tensor(value) else torch.as_tensor(
            value)).to(device=p.device, dtype=torch.int64)
        if p.dim() == 1:  # one distribution: gather categories
            return p[idx]
        return torch.take_along_dim(p, idx[..., None], dim=-1)[..., 0]

    def log_prob(self, value):
        # a plain log: a zero-probability category gives -inf
        return torch.log(self.probs(value))

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(logp.exp() * logp).sum(dim=-1)

    def kl_divergence(self, other):
        logp = torch.log_softmax(self.logits, dim=-1)
        return (logp.exp() * (logp - torch.log_softmax(other.logits, dim=-1))
                ).sum(dim=-1)


class Bernoulli(Distribution):
    def __init__(self, probs=None, logits=None, name=None):
        if probs is not None:
            self.probs_ = _as(probs)
            self.logits = torch.log(self.probs_ / (1 - self.probs_))
        else:
            self.logits = _as(logits)
            self.probs_ = torch.sigmoid(self.logits)

    def sample(self, shape=(), seed=0):
        p = self.probs_.expand(tuple(shape) + tuple(self.probs_.shape))
        return torch.bernoulli(p, generator=_gen(p.device, seed))

    def log_prob(self, value):
        v = _as(value)
        return (v * torch.nn.functional.logsigmoid(self.logits)
                + (1 - v) * torch.nn.functional.logsigmoid(-self.logits))

    def entropy(self):
        p = self.probs_
        return -(p * torch.log(p.clamp_min(1e-30))
                 + (1 - p) * torch.log((1 - p).clamp_min(1e-30)))


def kl_divergence(p, q):
    return p.kl_divergence(q)


class MultivariateNormalDiag(Distribution):
    """A diagonal-covariance normal: `scale` is the per-dimension standard
    deviation (batched as loc), or a matrix whose diagonal is taken."""

    def __init__(self, loc, scale):
        self.loc = loc if torch.is_tensor(loc) else torch.as_tensor(loc)
        self.scale = scale if torch.is_tensor(scale) \
            else torch.as_tensor(scale)

    def _diag(self):
        s = self.scale
        if s.dim() == self.loc.dim() + 1 and s.shape[-1] == s.shape[-2]:
            return torch.diagonal(s, dim1=-2, dim2=-1)
        return s

    def sample(self, shape=()):
        lv = self.loc
        eps = torch.randn(tuple(shape) + tuple(lv.shape), dtype=lv.dtype,
                          device=lv.device,
                          generator=rng_mod.generator(lv.device))
        return lv + self._diag() * eps

    def log_prob(self, value):
        v = value if torch.is_tensor(value) else torch.as_tensor(value)
        d = self._diag()
        z = (v - self.loc) / d
        return (-0.5 * (z * z).sum(-1) - torch.log(d).sum(-1)
                - 0.5 * d.shape[-1] * math.log(2 * math.pi))

    def entropy(self):
        d = self._diag()
        k = d.shape[-1]
        return 0.5 * k * (1 + math.log(2 * math.pi)) + torch.log(d).sum(-1)

    def kl_divergence(self, other):
        d0, d1 = self._diag(), other._diag()
        m0, m1 = self.loc, other.loc
        return (torch.log(d1) - torch.log(d0)
                + (d0 ** 2 + (m0 - m1) ** 2) / (2 * d1 ** 2) - 0.5).sum(-1)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):  # noqa: A002
    """One column index a row of the weight matrix `x`, drawn in
    proportion to the weights (each at least 1e-30)."""
    xv = x if torch.is_tensor(x) else torch.as_tensor(x)
    idx = torch.multinomial(xv.float().clamp_min(1e-30), 1,
                            generator=_gen(xv.device, seed))[:, 0]
    return idx.to(dtype_mod.convert_dtype(dtype))


__all__ = ["Distribution", "Uniform", "Normal", "Categorical", "Bernoulli",
           "MultivariateNormalDiag", "kl_divergence", "sampling_id"]
