"""GPT-2 pipeline-parallel training step.

The port of `paddle_tpu/models/gpt2_pipeline.py`. The L transformer
blocks are stacked into per-leaf [L, ...] tensors, the leading dim split
over the `pp` axis, and each rank runs its L/S blocks inside the GPipe or
interleaved schedule (`parallel.pipeline`). Each block is the port's
GPT-2 block (`models.gpt2._block`), so its attention goes through
`ops.scaled_dot_product_attention` and, where the head dim allows, the
flash route (K4, and K6 + K9 in the backward, on the card). The
embedding and the final layer norm and tied head run on every rank; the
embedding enters the pipeline through `comm.copy_to`, so every rank's
gradients of those leaves are complete.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.loss import cross_entropy
from ..parallel.mesh import resolve_mesh
from .gpt2 import GPT2, _block


def _split_block_params(params):
    """(stacked {sub: [L, ...]}, other) from flat 'h.{i}.{sub}' params."""
    blocks, other = {}, {}
    for name, v in params.items():
        if name.startswith("h."):
            _, idx, sub = name.split(".", 2)
            blocks.setdefault(sub, {})[int(idx)] = v
        else:
            other[name] = v
    stacked = {sub: torch.stack([d[i] for i in range(len(d))])
               for sub, d in blocks.items()}
    return stacked, other


def _merge_block_params(stacked, other):
    params = dict(other)
    for sub, arr in stacked.items():
        for i in range(arr.shape[0]):
            params[f"h.{i}.{sub}"] = arr[i]
    return params


def build_pp_train_step(cfg, mesh=None, num_microbatches=4, pp_axis="pp",
                        schedule="gpipe", num_virtual=1, device=None):
    """(loss_fn(stacked_local, other, batch), init()).

    init() gives the global (stacked [L, ...], other) params of
    `GPT2(cfg, seed=0)`; `pp_stage_params` cuts a rank's stacked slice
    ([L/S, ...] leaves for gpipe, [V, 1, L/(V*S), ...] for interleaved).
    loss_fn runs the schedule and returns the mean next-token loss on
    every rank."""
    from ..parallel.pipeline import pipeline_apply, pipeline_apply_interleaved

    mesh = resolve_mesh(mesh)
    assert cfg.dropout == 0.0, "pp step: disable dropout"
    s_pp = mesh.size(pp_axis)
    assert cfg.num_layers % s_pp == 0
    if schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    interleaved = schedule == "interleaved" and num_virtual > 1
    if interleaved:
        assert cfg.num_layers % (s_pp * num_virtual) == 0
        assert num_microbatches % s_pp == 0

    def stage_fn(stage, x):
        for j in range(next(iter(stage.values())).shape[0]):
            p = {f"h.0.{sub}": v[j] for sub, v in stage.items()}
            x = _block(p, 0, x, cfg, 0.0, None)
        return x

    def init():
        model = GPT2(cfg, seed=0, device=device)
        params = {n: p.detach() for n, p in model.named_parameters()}
        return _split_block_params(params)

    def head_loss(other, h, labels):
        h = F.layer_norm(h, (cfg.hidden_size,), other["ln_f.weight"],
                         other["ln_f.bias"], cfg.layer_norm_epsilon)
        logits = h.reshape(-1, cfg.hidden_size) @ other["wte.weight"].T
        return cross_entropy(logits.float(), labels.reshape(-1).long())

    def loss_fn(stacked_local, other, batch):
        ids = batch["input_ids"]
        pos = torch.arange(ids.shape[1], device=ids.device)
        x0 = F.embedding(ids, other["wte.weight"]) \
            + F.embedding(pos, other["wpe.weight"])
        m = num_microbatches
        mbs = x0.reshape((m, x0.shape[0] // m) + tuple(x0.shape[1:]))
        if interleaved:
            chunks = {k: v[:, 0] for k, v in stacked_local.items()}
            outs = pipeline_apply_interleaved(stage_fn, chunks, mbs, pp_axis,
                                              mesh)
        else:
            outs = pipeline_apply(stage_fn, stacked_local, mbs, pp_axis,
                                  mesh)
        h = outs.reshape((x0.shape[0],) + tuple(outs.shape[2:]))
        return head_loss(other, h, batch["labels"])

    return loss_fn, init


def pp_stage_params(cfg, stacked, mesh=None, schedule="gpipe",
                    num_virtual=1, pp_axis="pp"):
    """This rank's slice of the stacked block params for
    `build_pp_train_step`'s schedule."""
    from ..parallel.pipeline import stage_slice
    mesh = resolve_mesh(mesh)
    chunk = cfg.num_layers // (mesh.size(pp_axis) * num_virtual)
    return stage_slice(stacked, mesh, schedule, num_virtual, pp_axis,
                       chunk_layers=chunk)


__all__ = ["build_pp_train_step", "pp_stage_params", "_split_block_params",
           "_merge_block_params"]
