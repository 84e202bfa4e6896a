"""GPT-2 with 4-D hybrid parallelism: dp x pp x mp x sp over one mesh.

The port of `paddle_tpu/models/gpt2_hybrid.py`, one process per rank
(`parallel.mesh`). Parameters are a flat dict; the stage leaves are
stacked [pp, L/pp, ...] globally and every rank holds the slice its spec
gives it (`hybrid_local_params`, `hybrid_params_from_reference`):

  dp — the batch split; gradients summed over dp after the backward.
  pp — GPipe or the circular-interleaved schedule (`parallel.pipeline`).
  mp — Megatron tensor parallelism: column-split QKV (stored [E, H, 3, d],
       so a rank's heads keep their q/k/v together) and fc1, row-split wo
       and w2 with one all-reduce after each (`comm.reduce_from`), and
       `comm.copy_to` where the replicated activations enter them; a
       vocab-parallel embedding (masked local gather + all-reduce) and
       cross-entropy from all-reduced softmax statistics with a detached
       max (`:217-273`).
  sp — ring attention over the sequence shards (flash kernels in every
       ring step when `_flash_ok`), "zigzag" (the caller feeds the batch
       in `zigzag_order` layout; positions follow) or "ulysses".

Gradients. The reference gets them from shard_map's transpose; here the
loss is `comm.mean_over` the (dp, sp) ranks of the local mean (its
backward only divides) and the Megatron pair (f, g) makes every rank of
mp and pp hold the full gradient of what it repeats: the embedding
output enters the pipeline through `copy_to` over pp and the last stage's
output leaves it through `reduce_from`. So each leaf's gradient is
summed over dp and sp only, on every rank, by
`reduce_hybrid_gradients`. `hybrid_shardings` gives the ZeRO-1 slot
specs (each dp rank keeps and updates 1/dp of the moments of the
replicated leaves: `zero_init` / `zero_update`).

`reference_loss` computes the same math without a mesh (the parity
oracle); `params_from_gpt2` carries a flat GPT-2 (`models/gpt2.py`'s
layout) into this one. The loss carries `grad_axes` ("dp", "sp"): the
fleet's train step (`distributed.fleet.build_hybrid_train_step`) runs it
as a mesh-aware loss on this rank's params and batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel import comm
from ..parallel.mesh import P, local_slice, resolve_mesh
from ..parallel.zero import DPAxis, zero_dim


def pad_vocab(vocab_size, mp):
    """Megatron vocab padding: V rounded up to a multiple of mp; the
    padded logit columns are masked to -inf in the loss."""
    return -(-vocab_size // mp) * mp


def init_hybrid_gpt2_params(generator, vocab_size, hidden, num_heads,
                            num_layers, pp, max_position, intermediate=None,
                            dtype=torch.float32, mp=1, device=None):
    """The global flat param dict (stage leaves [pp, L/pp, ...], the
    embedding padded to a multiple of mp with zero rows), drawn from the
    torch.Generator `generator` (N(0, 0.02), as the reference's shapes),
    on `device` (None: the first card; "cpu" on request)."""
    device = resolve_device(device)
    assert num_layers % pp == 0, (num_layers, pp)
    lps = num_layers // pp
    e, h = hidden, num_heads
    d = e // h
    f = intermediate or 4 * e

    def nrm(*shape):
        return (torch.randn(*shape, generator=generator,
                            device=generator.device) * 0.02).to(
            dtype=dtype, device=device)

    def full(v, *shape):
        return torch.full(shape, v, dtype=dtype, device=device)

    wte = nrm(vocab_size, e)
    v_pad = pad_vocab(vocab_size, mp)
    if v_pad > vocab_size:
        wte = torch.cat([wte, full(0.0, v_pad - vocab_size, e)])
    return {
        "wte": wte, "wpe": nrm(max_position, e),
        "ln_f.w": full(1.0, e), "ln_f.b": full(0.0, e),
        "blk.ln1.w": full(1.0, pp, lps, e),
        "blk.ln1.b": full(0.0, pp, lps, e),
        "blk.wqkv": nrm(pp, lps, e, h, 3, d),
        "blk.bqkv": full(0.0, pp, lps, h, 3, d),
        "blk.wo": nrm(pp, lps, h, d, e), "blk.bo": full(0.0, pp, lps, e),
        "blk.ln2.w": full(1.0, pp, lps, e),
        "blk.ln2.b": full(0.0, pp, lps, e),
        "blk.w1": nrm(pp, lps, e, f), "blk.b1": full(0.0, pp, lps, f),
        "blk.w2": nrm(pp, lps, f, e), "blk.b2": full(0.0, pp, lps, e),
    }


def hybrid_param_specs(params):
    """The spec of each leaf: stage dim -> pp, tensor-parallel dim -> mp,
    the rest replicated (the reference's `hybrid_param_specs`)."""
    specs = {
        "wte": P("mp", None), "wpe": P(), "ln_f.w": P(), "ln_f.b": P(),
        "blk.ln1.w": P("pp"), "blk.ln1.b": P("pp"),
        "blk.wqkv": P("pp", None, None, "mp"),
        "blk.bqkv": P("pp", None, "mp"),
        "blk.wo": P("pp", None, "mp"), "blk.bo": P("pp"),
        "blk.ln2.w": P("pp"), "blk.ln2.b": P("pp"),
        "blk.w1": P("pp", None, None, "mp"), "blk.b1": P("pp", None, "mp"),
        "blk.w2": P("pp", None, "mp"), "blk.b2": P("pp"),
    }
    assert set(specs) == set(params)
    return specs


def _regroup(v, num_virtual, s_pp):
    """blk [pp, lps, ...] (layer order p*lps + i) -> [V, S, nblk, ...]:
    splitting dim 1 over pp gives rank r the chunks {l*S + r}."""
    L = v.shape[0] * v.shape[1]
    if L % (num_virtual * s_pp):
        raise ValueError(
            f"interleaved schedule needs num_layers ({L}) divisible by "
            f"num_virtual*pp ({num_virtual}*{s_pp})")
    nblk = L // (num_virtual * s_pp)
    return v.reshape((L,) + tuple(v.shape[2:])).reshape(
        (num_virtual, s_pp, nblk) + tuple(v.shape[2:]))


def _local_specs(params, pp_schedule, num_virtual, mesh):
    specs = hybrid_param_specs(params)
    if pp_schedule == "interleaved" and num_virtual > 1 and \
            mesh.size("pp") > 1:
        specs = {k: (P(None, "pp", None, *tuple(s)[2:])
                     if k.startswith("blk.") else s)
                 for k, s in specs.items()}
    return specs


def hybrid_local_params(mesh, params, pp_schedule="gpipe", num_virtual=1):
    """This rank's slice of the global params (the interleaved schedule
    regroups the stage leaves first, as the reference's loss does)."""
    mesh = resolve_mesh(mesh)
    specs = _local_specs(params, pp_schedule, num_virtual, mesh)
    out = {}
    for k, v in params.items():
        if k.startswith("blk.") and tuple(specs[k])[:2] == (None, "pp"):
            v = _regroup(v, num_virtual, mesh.size("pp"))
        out[k] = local_slice(v, specs[k], mesh.coords, mesh.shape)
    return out


def hybrid_params_from_reference(params_np, mesh=None, pp_schedule="gpipe",
                                 num_virtual=1, device=None, dtype=None):
    """The reference's global numpy params -> this rank's local tensors
    (copies, requiring grad) on `device` (None: the first card)."""
    device = resolve_device(device)
    mesh = resolve_mesh(mesh)
    glob = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    loc = hybrid_local_params(mesh, glob, pp_schedule, num_virtual)
    return {k: v.to(device=device, dtype=dtype or v.dtype).clone()
            .requires_grad_(True) for k, v in loc.items()}


def reduce_hybrid_gradients(grads, mesh=None):
    """Sum each gradient over dp and sp, in place (one all-reduce)."""
    return comm.reduce_gradients(grads, lambda _name: ("dp", "sp"), mesh)


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _causal_attention(q, k, v):
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, logits.new_tensor(-1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)


def _stage_fn(stage, x, *, mesh, sp, mp, ring_impl):
    """One pipeline stage: its layers in order. `stage` leaves are this
    rank's [L_stage, ...] (tensor-parallel dims already local)."""
    from ..parallel.ring_attention import (ring_attention,
                                           zigzag_ring_attention)
    from ..parallel.ulysses import ulysses_attention

    h = x
    for li in range(stage["blk.w1"].shape[0]):
        wl = {k: v[li] for k, v in stage.items()}
        a = _ln(h, wl["blk.ln1.w"], wl["blk.ln1.b"])
        if mp:
            a = comm.copy_to(a, "mp", mesh)
        qkv = torch.einsum("bse,ehtd->bshtd", a, wl["blk.wqkv"]) \
            + wl["blk.bqkv"]
        q, k, v = (qkv[:, :, :, i].movedim(1, 2) for i in range(3))
        if not sp:
            o = _causal_attention(q, k, v)
        elif ring_impl == "ulysses":
            o = ulysses_attention(q, k, v, "sp", causal=True, mesh=mesh)
        elif ring_impl == "zigzag":
            o = zigzag_ring_attention(q, k, v, "sp", mesh=mesh)
        else:
            o = ring_attention(q, k, v, "sp", causal=True, impl=ring_impl,
                               mesh=mesh)
        att = torch.einsum("bhsd,hde->bse", o, wl["blk.wo"])
        if mp:
            att = comm.reduce_from(att, "mp", mesh)
        h = h + att + wl["blk.bo"]
        m = _ln(h, wl["blk.ln2.w"], wl["blk.ln2.b"])
        if mp:
            m = comm.copy_to(m, "mp", mesh)
        m = F.gelu(torch.einsum("bse,ef->bsf", m, wl["blk.w1"])
                   + wl["blk.b1"], approximate="tanh")
        m = torch.einsum("bsf,fe->bse", m, wl["blk.w2"])
        if mp:
            m = comm.reduce_from(m, "mp", mesh)
        h = h + m + wl["blk.b2"]
    return h


def build_hybrid_gpt2_loss(mesh=None, num_microbatches=2, ring_impl=None,
                           vocab_size=None, pp_schedule="gpipe",
                           num_virtual=1):
    """loss_fn(params, batch) running dp x pp x mp x sp on `mesh`.

    params: this rank's slice (`hybrid_local_params` with the same
    pp_schedule / num_virtual); batch: {"input_ids", "labels"} this rank's
    [B/dp, S/sp] block (in zigzag layout for ring_impl="zigzag"). Returns
    the global mean loss on every rank; its gradients, summed over dp and
    sp (`reduce_hybrid_gradients`), are the reference's.
    `vocab_size`: the true vocab when the embedding is padded."""
    from ..parallel.pipeline import pipeline_apply, pipeline_apply_interleaved

    mesh = resolve_mesh(mesh)
    if pp_schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {pp_schedule!r}")
    use_pp = mesh.size("pp") > 1
    interleaved = use_pp and pp_schedule == "interleaved" and num_virtual > 1
    sp = mesh.size("sp") > 1
    mp = mesh.size("mp") > 1

    def stage_fn(stage, x):
        return _stage_fn(stage, x, mesh=mesh, sp=sp, mp=mp,
                         ring_impl=ring_impl)

    def loss_fn(params, batch, key=None):
        ids, labels = batch["input_ids"], batch["labels"]
        dev = ids.device
        sp_idx = mesh.axis_index("sp") if sp else 0
        s_l = ids.shape[1]
        if ring_impl == "zigzag" and sp:
            n_sp, half = mesh.size("sp"), s_l // 2
            pos = torch.cat([sp_idx * half + torch.arange(half, device=dev),
                             (2 * n_sp - 1 - sp_idx) * half
                             + torch.arange(half, device=dev)])
        else:
            pos = sp_idx * s_l + torch.arange(s_l, device=dev)
        wte = params["wte"]
        v_loc = wte.shape[0]
        if mp:
            v_start = mesh.axis_index("mp") * v_loc
            lids = ids - v_start
            ok = (lids >= 0) & (lids < v_loc)
            x = torch.where(ok[..., None], wte[lids.clamp(0, v_loc - 1)],
                            wte.new_zeros(()))
            x = comm.reduce_from(x, "mp", mesh)
        else:
            v_start = 0
            x = wte[ids]
        x = x + params["wpe"][pos][None]
        m = num_microbatches
        if interleaved:
            chunks = {k: v[:, 0] for k, v in params.items()
                      if k.startswith("blk.")}
            mbs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
            outs = pipeline_apply_interleaved(stage_fn, chunks, mbs, "pp",
                                              mesh)
            y = outs.reshape((x.shape[0],) + tuple(outs.shape[2:]))
        else:
            stage = {k: v[0] for k, v in params.items()
                     if k.startswith("blk.")}
            if use_pp:
                mbs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
                outs = pipeline_apply(stage_fn, stage, mbs, "pp", mesh)
                y = outs.reshape((x.shape[0],) + tuple(outs.shape[2:]))
            else:
                y = stage_fn(stage, x)
        y = _ln(y, params["ln_f.w"], params["ln_f.b"])
        if mp:
            y = comm.copy_to(y, "mp", mesh)
        # logits stay vocab-sharded: [B, S_l, V_pad/mp] on each rank
        logits = torch.einsum("bse,ve->bsv", y, wte).float()
        if vocab_size is not None:
            col = v_start + torch.arange(v_loc, device=dev)
            logits = torch.where(col < vocab_size, logits,
                                 logits.new_tensor(-torch.inf))
        if mp:
            lmax = comm.pmax(logits.amax(-1), "mp", mesh)
            sumexp = comm.reduce_from(
                torch.exp(logits - lmax[..., None]).sum(-1), "mp", mesh)
            lt = labels - v_start
            ok = (lt >= 0) & (lt < v_loc)
            tgt = logits.gather(-1, lt.clamp(0, v_loc - 1)[..., None])[..., 0]
            tgt = comm.reduce_from(torch.where(ok, tgt, tgt.new_zeros(())),
                                   "mp", mesh)
            nll = torch.log(sumexp) + lmax - tgt
        else:
            logp = torch.log_softmax(logits, -1)
            nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        return comm.mean_over(nll.mean(), ("dp", "sp"), mesh)

    # mesh-aware: the fleet's train step sums its gradients over these
    loss_fn.grad_axes = ("dp", "sp")
    return loss_fn


def params_from_gpt2(flat, num_heads, pp=1):
    """The global hybrid params of a GPT-2 in the flat layout of
    `models/gpt2.py` (numpy arrays or tensors, "h.{i}.qkv_proj.weight"
    [E, 3E] ...; tied embeddings): the fused QKV as [E, H, 3, d] (its
    column t*E + h*d + j is wqkv[:, h, t, j]), the output projection as
    [H, d, E], the layers stacked [pp, L/pp, ...]."""
    t = {k: torch.as_tensor(np.array(v)) for k, v in flat.items()}
    E = t["wte.weight"].shape[1]
    H, d = num_heads, E // num_heads
    L = 1 + max(int(k.split(".")[1]) for k in t if k.startswith("h."))

    def stack(fn):
        per = torch.stack([fn(f"h.{i}.") for i in range(L)])
        return per.reshape((pp, L // pp) + tuple(per.shape[1:]))

    return {
        "wte": t["wte.weight"], "wpe": t["wpe.weight"],
        "ln_f.w": t["ln_f.weight"], "ln_f.b": t["ln_f.bias"],
        "blk.ln1.w": stack(lambda p: t[p + "ln_1.weight"]),
        "blk.ln1.b": stack(lambda p: t[p + "ln_1.bias"]),
        "blk.wqkv": stack(lambda p: t[p + "qkv_proj.weight"].reshape(
            E, 3, H, d).permute(0, 2, 1, 3)),
        "blk.bqkv": stack(lambda p: t[p + "qkv_proj.bias"].reshape(
            3, H, d).permute(1, 0, 2)),
        "blk.wo": stack(lambda p: t[p + "out_proj.weight"].reshape(H, d,
                                                                   E)),
        "blk.bo": stack(lambda p: t[p + "out_proj.bias"]),
        "blk.ln2.w": stack(lambda p: t[p + "ln_2.weight"]),
        "blk.ln2.b": stack(lambda p: t[p + "ln_2.bias"]),
        "blk.w1": stack(lambda p: t[p + "fc1.weight"]),
        "blk.b1": stack(lambda p: t[p + "fc1.bias"]),
        "blk.w2": stack(lambda p: t[p + "fc2.weight"]),
        "blk.b2": stack(lambda p: t[p + "fc2.bias"]),
    }


def reference_loss(params, batch, vocab_size=None):
    """The same math on the global params and batch, without a mesh."""
    ids, labels = batch["input_ids"], batch["labels"]
    s = ids.shape[1]
    x = params["wte"][ids] + params["wpe"][torch.arange(s,
                                                        device=ids.device)][None]
    pp, lps = params["blk.w1"].shape[:2]
    for pi in range(pp):
        for li in range(lps):
            wl = {k: v[pi, li] for k, v in params.items()
                  if k.startswith("blk.")}
            a = _ln(x, wl["blk.ln1.w"], wl["blk.ln1.b"])
            qkv = torch.einsum("bse,ehtd->bshtd", a, wl["blk.wqkv"]) \
                + wl["blk.bqkv"]
            q, k, v = (qkv[:, :, :, i].movedim(1, 2) for i in range(3))
            o = _causal_attention(q, k, v)
            x = x + torch.einsum("bhsd,hde->bse", o, wl["blk.wo"]) \
                + wl["blk.bo"]
            m = _ln(x, wl["blk.ln2.w"], wl["blk.ln2.b"])
            m = F.gelu(torch.einsum("bse,ef->bsf", m, wl["blk.w1"])
                       + wl["blk.b1"], approximate="tanh")
            x = x + torch.einsum("bsf,fe->bse", m, wl["blk.w2"]) \
                + wl["blk.b2"]
    x = _ln(x, params["ln_f.w"], params["ln_f.b"])
    logits = torch.einsum("bse,ve->bsv", x, params["wte"]).float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=ids.device)
        logits = torch.where(col < vocab_size, logits,
                             logits.new_tensor(-torch.inf))
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def hybrid_shardings(mesh, params, optimizer_state=None, zero_dp=True):
    """(param specs, slot specs): params per `hybrid_param_specs`; with an
    optimizer state, each replicated leaf's slots split over dp on the
    first dim dp divides (ZeRO-1), the others following their param."""
    mesh = resolve_mesh(mesh)
    specs = hybrid_param_specs(params)

    def slot_spec(name, v):
        base = specs[name]
        if zero_dp and tuple(base) == ():
            i = zero_dim(v.shape, mesh.size("dp"))
            if i is not None:
                return P(*([None] * i + ["dp"] + [None] * (v.dim() - i - 1)))
        return base

    if optimizer_state is None:
        return specs, None
    slots = {name: {k: slot_spec(name, params[name])
                    for k in optimizer_state["slots"][name]}
             for name in optimizer_state["slots"]}
    return specs, {"slots": slots, "t": P()}


def _zero_dims(slot_specs, names, mesh):
    """{name: the dim its slots split over dp} for the split leaves."""
    if mesh.size("dp") == 1:
        return {}
    out = {}
    for n in names:
        spec = tuple(next(iter(slot_specs["slots"][n].values())))
        if "dp" in spec:
            out[n] = spec.index("dp")
    return out


def zero_init(optimizer, params, mesh, slot_specs):
    """The optimizer state with ZeRO-1 slots: a dp-split leaf keeps
    moments of its 1/dp chunk only."""
    mesh = resolve_mesh(mesh)
    dp, split = DPAxis(mesh), _zero_dims(slot_specs, params, mesh)
    return optimizer.functional_init(
        {n: (dp.chunk(p.detach(), split[n]) if n in split else p.detach())
         for n, p in params.items()})


@torch.no_grad()
def zero_update(optimizer, params, grads, opt_state, mesh, slot_specs):
    """One optimizer step in place: each dp rank updates its chunk of the
    dp-split leaves (Lamb's and Lars' norms over the whole leaf) and all
    of the others, then the chunks are all-gathered over dp."""
    mesh = resolve_mesh(mesh)
    dp, split = DPAxis(mesh), _zero_dims(slot_specs, params, mesh)
    views = {n: (dp.chunk(p, split[n]) if n in split else p)
             for n, p in params.items()}
    gviews = {n: (dp.chunk(g, split[n]) if n in split else g)
              for n, g in grads.items()}
    optimizer.functional_update(views, gviews, opt_state, norms={
        n: dp.norm_fn() for n in split} or None)
    for n, w in dp.gather({n: views[n] for n in split}, split).items():
        params[n].copy_(w)
    return params, opt_state


__all__ = ["pad_vocab", "init_hybrid_gpt2_params", "hybrid_param_specs",
           "hybrid_local_params", "hybrid_params_from_reference",
           "params_from_gpt2",
           "reduce_hybrid_gradients",
           "build_hybrid_gpt2_loss", "reference_loss", "hybrid_shardings",
           "zero_init", "zero_update"]
