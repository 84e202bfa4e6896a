"""The fixed-cache decode program of `GPT2.generate(kv_cache="dense")` and
of the exported generator: the port of the reference's `_build_decode_fn`
and its program cache `_generate_impl` (`paddle_tpu/models/gpt2.py:
471-702`).

One program per static configuration (spec, max_new, top_k, nucleus,
kv_quant), as the reference's `lru_cache`d `jax.jit`:

  * LEFT padding by value: `valid = ids != pad` (pad -1 disables it),
    positions `max(cumsum(valid) - 1, 0)`, pads masked from every key;
    the rightmost prompt token is always real, so the readout is
    `x[:, -1]`;
  * a prefill over the prompt (causal attention masked by `valid`), then
    `max_new - 1` single-token steps against a cache of fixed size
    [L, B, H, S0 + max_new, Dh], written in place. A step at cache slot
    t attends the slots [0, t] (the reference masks the rest of the
    fixed cache; the masked scores add exact zeros there);
  * the int8 cache (`kv_quant`): one scale per stored vector in the
    weights' dtype (`inference.kv_quant.kv_encode`, the reference's
    `kv_enc`); scores are scaled by k's scales after the contraction and
    v's scales multiply the probabilities;
  * W8A16 params (`name::w8c` / `name::w8s`) through
    `nn.decode._LayerHelpers`, the reference's `matw`, the embedding's
    row scales and the tied head;
  * `pick`: greedy argmax, or temperature, top-k through the k-th value
    (values tied with it kept), nucleus through an exclusive cumsum
    `< top_p` over the sorted, filtered logits (at least one token),
    then `sampling.prng.categorical` from one key per step
    (`split` once a step from `seed_key(seed)`, as `jax.random`; the
    greedy program, which reads no key, skips the splits);
  * eos: a row that emitted eos keeps emitting it; `max_new == 1` runs
    no step.

Greedy or sampled is chosen on the host from the scalar temperature
(the reference's `lax.cond` on the traced `temp > 0`): each is its own
program and, on the card, its own graph. Seed, temperature, eos, top_p
and pad are inputs, so new values never rebuild or recapture.

On the card a `DecodeProgram` runs through `nn.decode_graph.
ProgramGraphs`: the prefill and the whole step loop captured as ONE
CUDA graph per (sampled, B, S0, params), replayed with the inputs copied
into its static buffers (the reference runs two XLA programs, the
prefill and the scan). A capture or replay that fails raises. On the
CPU the eager function runs. The products stay `torch.matmul`: the
reference computes this program in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..inference.kv_quant import kv_encode
from ..nn.decode import _LayerHelpers, config_spec
from ..nn.decode_graph import ProgramGraphs
from ..sampling import prng
from ..sampling.buffers import host_to_device

_NEG_INF = float("-inf")


def pick(logits, key, temp, top_p, top_k, nucleus):
    """One sampled token per row of [B, V] float32 logits (the reference's
    `pick`, sampled branch): temperature, then top-k through the k-th
    largest value (`top_k` static; ties with it survive), then nucleus
    (`nucleus` static): the smallest prefix of the descending-sorted,
    filtered logits whose exclusive cumulative probability stays under
    `top_p`, at least one token, cut at its last value (ties survive);
    then `prng.categorical` with `key`. temp and top_p are 0-d float32
    tensors. Returns [B] int32."""
    l = logits / torch.clamp_min(temp, 1e-6)
    if top_k > 0:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, _NEG_INF, l)
    if nucleus:
        sl = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        n_keep = torch.clamp_min(
            (cum < top_p).sum(dim=-1, keepdim=True), 1)
        kth_val = sl.gather(-1, n_keep - 1)
        l = torch.where(l < kth_val, _NEG_INF, l)
    return prng.categorical(key, l)


class DecodeProgram:
    """The decode program of one static configuration (module
    docstring). `run` is the eager function; calling the program runs it
    on the CPU, or its graph on the card."""

    def __init__(self, spec, max_new, top_k=0, nucleus=False,
                 kv_quant=False):
        self.spec = tuple(spec)
        self.max_new = int(max_new)
        self.top_k = int(top_k)
        self.nucleus = bool(nucleus)
        self.kv_quant = bool(kv_quant)
        self._hp = _LayerHelpers(self.spec)
        self._scale = self.spec[2] ** -0.5
        self.graphs = ProgramGraphs()
        # a replay and the copy of its output, one caller at a time (a
        # server's worker and other threads may share a program)
        self._lock = threading.Lock()

    def _pick(self, logits, key, temp, top_p, sampled):
        if not sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return pick(logits, key, temp, top_p, self.top_k, self.nucleus)

    @torch.no_grad()
    def run(self, params, ids, key0, temp, eos, top_p, pad, sampled):
        """ids [B, S0] int32; key0 [2] int64 (`prng.seed_key`); temp,
        top_p 0-d float32; eos, pad 0-d int32 (-1 disables); `sampled` a
        host bool. Returns [B, S0 + max_new] int32, every tensor on ids'
        device."""
        hp, n_new = self._hp, self.max_new
        L, H, Dh, E = hp.L, hp.H, hp.Dh, hp.E
        B, S0 = ids.shape
        S = S0 + n_new
        dev = ids.device
        dt = params["ln_f.weight"].dtype
        wpe = params["wpe.weight"]
        valid = ids != pad                                   # [B, S0]
        pos = torch.clamp_min(torch.cumsum(valid, dim=1) - 1, 0)
        n_valid = valid.sum(dim=1)                           # [B]
        x = hp.embed(params, ids) + wpe[pos]
        if self.kv_quant:
            ck = torch.zeros((L, B, H, S, Dh), dtype=torch.int8, device=dev)
            cv = torch.zeros_like(ck)
            ksc = torch.zeros((L, B, H, S), dtype=dt, device=dev)
            vsc = torch.zeros_like(ksc)
        else:
            ck = torch.zeros((L, B, H, S, Dh), dtype=dt, device=dev)
            cv = torch.zeros_like(ck)

        causal = torch.ones((S0, S0), dtype=torch.bool, device=dev).tril()
        kmask = causal[None, None] & valid[:, None, None, :]
        for i in range(L):
            a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                      params[f"h.{i}.ln_1.bias"])
            q, k, v = (u.transpose(1, 2) for u in hp.qkv_split(params, i, a))
            if self.kv_quant:                            # [B, H, S0, Dh]
                ck[i, :, :, :S0], ksc[i, :, :, :S0] = kv_encode(k, dt)
                cv[i, :, :, :S0], vsc[i, :, :, :S0] = kv_encode(v, dt)
            else:
                ck[i, :, :, :S0] = k
                cv[i, :, :, :S0] = v
            s = (q @ k.transpose(-1, -2)).float() * self._scale
            s = torch.where(kmask, s, -1e30)
            w = torch.softmax(s, dim=-1).to(dt)
            o = (w @ v).transpose(1, 2).reshape(B, S0, E)
            x = hp.block_and_mlp(params, i, x, o)
        xf = hp.ln(x[:, -1], params["ln_f.weight"], params["ln_f.bias"])
        # the greedy program reads no key: it skips the splits, whose
        # threefry hashes are most of a small step's kernels
        key, sub = prng.split(key0) if sampled else (None, None)
        tok = self._pick(hp.head(params, xf), sub, temp, top_p, sampled)
        done = (tok == eos) & (eos >= 0)
        toks = [tok]

        vfull = torch.cat([valid, torch.ones((B, n_new), dtype=torch.bool,
                                             device=dev)], dim=1)
        for step in range(n_new - 1):
            t = S0 + step                      # the cache slot of `tok`
            x = hp.embed(params, tok) + wpe[n_valid + step]
            keep = vfull[:, None, :t + 1]
            for i in range(L):
                a = hp.ln(x, params[f"h.{i}.ln_1.weight"],
                          params[f"h.{i}.ln_1.bias"])
                q, k, v = hp.qkv_split(params, i, a)        # [B, H, Dh]
                if self.kv_quant:
                    ck[i, :, :, t], ksc[i, :, :, t] = kv_encode(k, dt)
                    cv[i, :, :, t], vsc[i, :, :, t] = kv_encode(v, dt)
                    s = (q[:, :, None] @ ck[i, :, :, :t + 1].to(dt)
                         .transpose(-1, -2))[:, :, 0].float() \
                        * ksc[i, :, :, :t + 1].float() * self._scale
                else:
                    ck[i, :, :, t] = k
                    cv[i, :, :, t] = v
                    s = (q[:, :, None] @ ck[i, :, :, :t + 1]
                         .transpose(-1, -2))[:, :, 0].float() * self._scale
                s = torch.where(keep, s, -1e30)
                w = torch.softmax(s, dim=-1).to(dt)
                if self.kv_quant:
                    o = ((w * vsc[i, :, :, :t + 1])[:, :, None]
                         @ cv[i, :, :, :t + 1].to(dt))
                else:
                    o = w[:, :, None] @ cv[i, :, :, :t + 1]
                x = hp.block_and_mlp(params, i, x, o.reshape(B, E))
            xf = hp.ln(x, params["ln_f.weight"], params["ln_f.bias"])
            key, sub = prng.split(key) if sampled else (None, None)
            nxt = self._pick(hp.head(params, xf), sub, temp, top_p, sampled)
            # eos is an input (-1 disables): once done, keep emitting eos
            nxt = torch.where(done, eos, nxt)
            done = done | ((nxt == eos) & (eos >= 0))
            toks.append(nxt)
            tok = nxt
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)

    def __call__(self, params, ids, seed, temperature, eos, top_p, pad):
        """The program on the params' device: ids [B, S0] (array or
        tensor), seed a uint32, temperature/top_p floats, eos/pad ints (-1
        disables). Returns [B, S0 + max_new] int32 on that device, a
        tensor of the caller's own (a graph's output is copied out)."""
        dev = params["ln_f.weight"].device
        sampled = float(temperature) > 0.0
        if isinstance(ids, torch.Tensor) and ids.device == dev:
            ids = ids.to(torch.int32)
        else:
            ids = host_to_device(np.asarray(
                ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                np.int32), dev)
        inputs = (ids, prng.seed_key(seed, dev),
                  torch.tensor(float(temperature), dtype=torch.float32,
                               device=dev),
                  torch.tensor(int(eos), dtype=torch.int32, device=dev),
                  torch.tensor(float(top_p), dtype=torch.float32,
                               device=dev),
                  torch.tensor(int(pad), dtype=torch.int32, device=dev))
        if dev.type != "cuda":
            return self.run(params, *inputs, sampled)
        with self._lock:
            (out,) = self.graphs(
                ("dense_decode", sampled),
                lambda p, *a: (self.run(p, *a, sampled),), params, inputs)
            return out.clone()


@functools.lru_cache(maxsize=16)
def _generate_impl(spec, max_new, top_k=0, nucleus=False, kv_quant=False):
    """The program cache (the reference's `_generate_impl`): one
    `DecodeProgram` per static configuration; seed, temperature, eos,
    top_p and pad are inputs of the program it returns."""
    return DecodeProgram(spec, max_new, top_k, nucleus, kv_quant)


def decode_program(cfg, max_new, top_k=0, nucleus=False, kv_quant=False):
    """The cached program for a GPT2Config (top_k clipped to the
    vocabulary, as the reference's `min(top_k, vocab_size)`)."""
    return _generate_impl(config_spec(cfg), int(max_new),
                          min(int(top_k), cfg.vocab_size), bool(nucleus),
                          bool(kv_quant))


__all__ = ["DecodeProgram", "decode_program", "pick"]
