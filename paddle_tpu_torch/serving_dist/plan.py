"""The GPT-2 decode sharding plan: flat param names -> partition specs,
and the cut of the flat params to one rank's part.

The port of `paddle_tpu/serving_dist/plan.py`. The specs are the
reference's (the training TP plan, `parallel.api.tp_spec_for`, on the
decode programs' flat names):

  * column-split (output dim over mp): qkv_proj, fc1, with their biases
    and per-output-column W8A16 scales;
  * row-split (contraction dim over mp): out_proj, fc2 — one all-reduce
    after each; their biases and scales are replicated (they apply after
    the sum);
  * the embedding and the tied head: wte's rows over mp (vocab parallel);
  * everything else (wpe, the layer norms) replicated.

In the reference a spec is a PLACEMENT: XLA partitions the program and
moves data as it likes. In the port a spec says which slice of a leaf a
rank KEEPS, and the decode programs compute on those slices
(`nn.decode`'s sharded helpers). Two leaves need more than the spec:

  * qkv_proj is fused [E, 3E]. A contiguous column split would hand a
    rank a mix of q, k and v columns of different heads; the port cuts
    it BY HEAD inside each of q, k and v (rank m keeps heads
    [m * H/tp, (m + 1) * H/tp) of each), so a rank's attention and its
    pool slice hold the same heads. `models/gpt2_hybrid.py`'s
    `params_from_gpt2` does the same arithmetic for the trainer.
  * `_fit` drops an axis that does not divide a dim, as the reference's
    placement does: GPT-2's vocabulary of 50257 stays whole on every rank
    and the head then runs replicated; a vocabulary tp divides takes the
    vocab-parallel embedding and head.

The KV pool's spec is heads over mp and blocks over dp: a rank's pool
tensors hold [L, num_blocks / dp, BS, H / tp, Dh] (int8 codes and scales
in lockstep).
"""
from __future__ import annotations

from ..parallel.api import tp_spec_for
from ..parallel.mesh import P

W8_CODES, W8_SCALES = "::w8c", "::w8s"


def _base_weight_spec(name, ndim):
    """Spec of a base (non-suffixed) decode param name."""
    if name == "wte.weight":
        return P("mp", *([None] * (ndim - 1)))  # vocab-parallel
    if name == "wpe.weight" or ".ln_" in name or name.startswith("ln_f"):
        return P()
    if name.endswith(".bias"):
        # biases follow their weight's output columns: column-split
        # projections get sharded biases, row-split ones replicated
        w = tp_spec_for(name[:-len(".bias")] + ".weight", 2)
        return P("mp") if tuple(w) and tuple(w)[-1] == "mp" else P()
    return tp_spec_for(name, ndim)  # Megatron column/row rules


def decode_spec_for(name, ndim):
    """Partition spec of one flat decode param (the W8A16 key
    convention: codes split like the weight, per-output-column scales
    like its last dim, wte's per-row scales with its rows)."""
    if name.endswith(W8_CODES):
        return _base_weight_spec(name[:-len(W8_CODES)], ndim)
    if name.endswith(W8_SCALES):
        base = name[:-len(W8_SCALES)]
        if base == "wte.weight":
            return P("mp", *([None] * (ndim - 1)))
        w = _base_weight_spec(base, max(ndim + 1, 2))
        last = tuple(w)[-1] if tuple(w) else None
        return P(*([None] * (ndim - 1) + [last]))
    return _base_weight_spec(name, ndim)


def _fit(mesh_shape, spec, shape):
    """Drop the spec axes whose mesh size does not divide the dim (the
    leaf stays whole on that dim: GPT-2's 50257 vocabulary)."""
    shape = tuple(shape)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return P(*[ax if ax is not None and shape[i] % mesh_shape[ax] == 0
               else None for i, ax in enumerate(entries)])


def kv_pool_specs(kv_dtype=None):
    """(k_blocks, v_blocks) specs of the pool [L, num_blocks, BS, H, Dh]:
    heads over mp, blocks over dp; an int8 pool's scales
    [L, num_blocks, BS, H] split alike (a (codes, scales) pair)."""
    codes = P(None, "dp", None, "mp", None)
    if kv_dtype == "int8":
        spec = (codes, P(None, "dp", None, "mp"))
    elif kv_dtype is None:
        spec = codes
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                         "(supported: None, 'int8')")
    return spec, spec


def _qkv_columns(width, num_heads, tp, m):
    """Column indices of rank m's heads inside each of q, k and v of a
    fused [.., 3E] qkv leaf (E = width / 3)."""
    import torch

    E = width // 3
    d = E // num_heads
    hl = num_heads // tp
    lo, hi = m * hl * d, (m + 1) * hl * d
    return torch.cat([torch.arange(t * E + lo, t * E + hi)
                      for t in range(3)])


def shard_decode_params(params, mesh, num_heads):
    """{name: this rank's part} of the flat decode params (base or W8A16
    keys) on `mesh`: each leaf cut by its `_fit` spec over the mesh's mp
    axis (dp and sp replicate weights), the fused qkv by head inside each
    of q, k and v. With one rank on mp the leaves pass through untouched
    (the same tensors)."""
    tp = mesh.shape.get("mp", 1)
    if tp == 1:
        return dict(params)
    m = mesh.coords["mp"]
    out = {}
    for name, v in params.items():
        spec = _fit(mesh.shape, decode_spec_for(name, v.dim()), v.shape)
        if ".qkv_proj." in name and tuple(spec) and tuple(spec)[-1] \
                == "mp":
            cols = _qkv_columns(v.shape[-1], num_heads, tp, m)
            out[name] = v.index_select(-1, cols.to(v.device)).contiguous()
            continue
        for dim, ax in enumerate(tuple(spec)):
            if ax == "mp":
                c = v.shape[dim] // tp
                v = v.narrow(dim, m * c, c)
        out[name] = v.contiguous()
    return out


def vocab_split(mesh_shape, vocab):
    """Whether the plan splits the vocabulary over mp (tp divides it)."""
    tp = mesh_shape.get("mp", 1)
    return tp > 1 and vocab % tp == 0


class DecodeShardings:
    """The port's sharding bundle of one server: the mesh, the per-name
    specs its params were cut by and the pool specs. `shard_label` is the
    `shard` label of the ops plane's compile metrics ("mp2xdp1", with
    "xsp{n}" when sp > 1), the reference's."""

    def __init__(self, mesh, params, kv_dtype=None):
        self.mesh = mesh
        self.params = {name: _fit(mesh.shape,
                                  decode_spec_for(name, v.dim()), v.shape)
                       for name, v in params.items()}
        self.kv = kv_pool_specs(kv_dtype)[0]

    @property
    def shard_label(self):
        shape = dict(self.mesh.shape)
        label = f"mp{shape.get('mp', 1)}xdp{shape.get('dp', 1)}"
        if shape.get("sp", 1) > 1:
            label += f"xsp{shape['sp']}"
        return label


def build_decode_shardings(mesh, params, kv_dtype=None):
    """The reference's bundle constructor: `DecodeShardings`."""
    return DecodeShardings(mesh, params, kv_dtype)


#: The reference places the full params on the mesh; the port cuts them.
place_decode_params = shard_decode_params

__all__ = ["decode_spec_for", "kv_pool_specs", "shard_decode_params",
           "place_decode_params", "build_decode_shardings", "vocab_split",
           "DecodeShardings", "W8_CODES", "W8_SCALES"]
