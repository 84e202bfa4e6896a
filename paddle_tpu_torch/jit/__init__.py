"""The deployment artifact of the port: the exported text generator
(`models.gpt2.export_generator`) and its loader, the counterpart of the
reference's `paddle_tpu.jit` artifact pair (`paddle_tpu/jit/__init__.py:
218-341, 442`).

The reference's `.pdmodel` carries a serialized StableHLO program; the
port cannot write one. Its artifact names the program instead of holding
it, and `load` rebuilds that program from the port's own code
(`models/gpt2_decode.py`):

  * `.pdmodel`: `MAGIC` (the port's own, so neither loader takes the
    other's file for a program it can run), an 8-byte little-endian
    header length, the JSON meta, and no program body. The meta holds
    the reference's keys (`kind`, `prompt_len`, `max_new_tokens`,
    `top_k`, `top_p_enabled`, `batch_size`, `weight_quant`, `kv_quant`,
    `inputs`) plus `format` and `config`, the `GPT2Config` fields the
    loader rebuilds the program from;
  * `.pdiparams`: the reference's npz, params under `p:` keys. Dtypes
    numpy lacks (bfloat16) are stored as the reference stores them: a
    uint8 view with the itemsize as a last axis, and a `dt:` sidecar
    naming the dtype; read back with `torch.Tensor.view`.

`load(prefix, device=None)` returns a `TranslatedLayer`: a callable
`(ids, seed, temperature, eos, top_p, pad) -> [B, prompt_len +
max_new_tokens]` int32 CPU tensor, with the artifact's meta as `_meta`.
Its weights go to the device once, at load (CUDA unless device="cpu";
raises when no card is present). `batch_size=None` artifacts take any
batch: one graph per B on the card.

Left out (§A 14): `jit.save` / `jit.load` of arbitrary layers and
`to_static`; `save` raises naming it.
"""
from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from ..device import resolve_device

MAGIC = b"PTTORCH1"
FORMAT = "paddle_tpu_torch.generator/1"
# the reference's artifact magic (`paddle_tpu/jit/__init__.py`)
_REFERENCE_MAGIC = b"PTPUEXP1"
CONFIG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                 "max_position", "intermediate_size", "layer_norm_epsilon",
                 "tie_embeddings")


def _to_numpy(t):
    """(array, dtype name for a `dt:` sidecar or None) of a tensor."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).reshape(*t.shape, 2).numpy(), "bfloat16"
    return t.numpy(), None


def write_artifact(path_prefix, params, meta):
    """Write the (.pdmodel, .pdiparams) pair: magic, 8-byte header length
    and JSON meta; params as an npz of `p:` keys (bf16 as a uint8 view
    with a `dt:` sidecar). Returns the .pdmodel path."""
    parent = os.path.dirname(path_prefix)
    if parent:
        os.makedirs(parent, exist_ok=True)
    header = json.dumps(meta).encode("utf-8")
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
    arrays = {}
    for k, v in params.items():
        a, dt = _to_numpy(v)
        if dt is not None:
            arrays["dt:p:" + k] = np.frombuffer(dt.encode(), dtype=np.uint8)
        arrays["p:" + k] = a
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path_prefix + ".pdiparams", "wb") as f:
        f.write(buf.getvalue())
    return path_prefix + ".pdmodel"


def read_artifact(path_prefix, device=None):
    """(params on `device`, meta) of an artifact pair; the params are
    uploaded here, once. Raises on another magic (the reference's
    StableHLO artifact among them) or format."""
    dev = resolve_device(device)
    with open(path_prefix + ".pdmodel", "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            what = ("the JAX package's StableHLO artifact, which this "
                    "package cannot run; re-export with paddle_tpu_torch."
                    "models.gpt2.export_generator"
                    if magic == _REFERENCE_MAGIC else
                    f"not a paddle_tpu_torch artifact (magic {magic!r})")
            raise ValueError(f"{path_prefix}.pdmodel is {what}")
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode("utf-8"))
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path_prefix}.pdmodel: unknown format "
                         f"{meta.get('format')!r} (expected {FORMAT!r})")
    params = {}
    with open(path_prefix + ".pdiparams", "rb") as f:
        npz = np.load(f, allow_pickle=False)
        for key in npz.files:
            if not key.startswith("p:"):
                continue
            t = torch.from_numpy(np.array(npz[key]))
            side = "dt:" + key
            if side in npz.files:
                name = bytes(npz[side]).decode()
                if name != "bfloat16":
                    raise ValueError(f"{key}: unknown dtype sidecar "
                                     f"{name!r}")
                t = t.view(torch.bfloat16).reshape(t.shape[:-1])
            params[key[2:]] = t.to(dev)
    return params, meta


class TranslatedLayer:
    """A loaded generator: `layer(ids, seed, temperature, eos, top_p,
    pad)` -> [B, prompt_len + max_new_tokens] int32 CPU tensor (module
    docstring). ids [B, prompt_len] (B fixed by the artifact unless its
    batch_size is None); seed uint32; temperature, top_p floats (top_p
    filters only in an artifact exported with top_p_enabled); eos, pad
    ints (-1 disables; otherwise prompts are LEFT-padded with pad)."""

    def __init__(self, params, meta, cfg):
        from ..models.gpt2_decode import decode_program

        self._params = params
        self._meta = meta
        self.cfg = cfg
        self._program = decode_program(
            cfg, meta["max_new_tokens"], meta["top_k"],
            meta["top_p_enabled"], meta["kv_quant"] == "int8")

    @property
    def device(self):
        return self._params["ln_f.weight"].device

    def forward(self, ids, seed, temperature, eos, top_p, pad):
        ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                         else ids)
        P, B = self._meta["prompt_len"], self._meta["batch_size"]
        if ids.ndim != 2 or ids.shape[1] != P or (
                B is not None and ids.shape[0] != B):
            raise ValueError(
                f"ids of shape {ids.shape}: this generator takes "
                f"[{'B' if B is None else B}, {P}]")
        out = self._program(self._params, ids, int(seed) & 0xFFFFFFFF,
                            float(temperature), int(eos), float(top_p),
                            int(pad))
        return out.cpu()

    __call__ = forward


def load(path_prefix, device=None):
    """Rebuild a runnable `TranslatedLayer` from an `export_generator`
    artifact pair, with no model class (module docstring)."""
    from ..models.gpt2 import GPT2Config

    params, meta = read_artifact(path_prefix, device)
    if meta.get("kind") != "gpt2_generator":
        raise ValueError(f"{path_prefix}: unknown artifact kind "
                         f"{meta.get('kind')!r}")
    cfg = GPT2Config(**{k: meta["config"][k] for k in CONFIG_FIELDS})
    return TranslatedLayer(params, meta, cfg)


def save(layer, path, input_spec=None, **configs):
    """`jit.save` of an arbitrary layer is not ported (ROADMAP §A 14):
    the port exports the text generator only
    (`models.gpt2.export_generator`)."""
    raise NotImplementedError(
        "paddle_tpu_torch.jit.save of arbitrary layers is not ported "
        "(ROADMAP §A 14); export a GPT-2 text generator with "
        "paddle_tpu_torch.models.gpt2.export_generator")


__all__ = ["load", "save", "read_artifact", "write_artifact",
           "TranslatedLayer", "MAGIC", "FORMAT"]
