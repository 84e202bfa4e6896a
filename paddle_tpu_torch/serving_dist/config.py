"""ShardedEngineConfig — the mesh of one sharded `PagedGenerationServer`.

The port of `paddle_tpu/serving_dist/config.py`. Serving reuses the
training mesh (`parallel.mesh.make_mesh`, axes dp/pp/mp/sp), so both
sides agree on axis names: serving tensor parallel IS the `mp` axis
(column/row-split weights, the vocab-parallel head), `dp` splits the
pool's block axis (each dp group holds a contiguous range of blocks and
serves the slots pinned to it), and `sp` shards one packed prefill
stream's token axis. pp stays 1.

The reference places arrays on devices (`devices=`); the port's mesh is
one process a rank, so a config names ranks (`ranks=`, default: the
first tp * dp * sp ranks of the world).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

_log = logging.getLogger(__name__)

#: Attention strategies of the sequence-parallel packed-prefill trunk:
#: "allgather" all-gathers the fresh K/V stream over sp before the pool
#: write (linear memory in chunk length; K1 then runs on the rank's own
#: rows); "ring" rotates fixed-size K/V sub-blocks around sp with an
#: online softmax; "ulysses" all-to-alls heads <-> sequence so each rank
#: attends its head slice over the whole stream. Both keep the peak
#: cross-rank fresh-K/V bytes a rank O(block), flat in chunk length.
SP_ATTENTION_MODES = ("allgather", "ring", "ulysses")


@dataclass(frozen=True)
class ShardedEngineConfig:
    """How to shard one `PagedGenerationServer` over the ranks of a
    torch.distributed world.

    tp: tensor-parallel degree over the mesh `mp` axis: qkv_proj and fc1
        split by output column (qkv by head inside each of q, k and v),
        out_proj and fc2 by input row (one all-reduce after each), the
        embedding and the tied head by vocabulary row when tp divides
        the vocabulary. The pool's HEAD axis splits with them.
    dp: the pool's BLOCK axis over the mesh `dp` axis: dp contiguous
        block ranges, each slot pinned to one range's group. Weights are
        replicated over dp.
    sp: sequence-parallel degree of the PACKED PREFILL stream: the chunk
        budget becomes `prefill_chunk_tokens * sp` and each sp rank runs
        the trunk on T/sp rows. Decode stays tensor parallel and the pool
        is replicated over sp. sp > 1 requires dp == 1.
    ranks: the world ranks of the mesh (None: the first tp * dp * sp).
    collective_quant: None (the exact collectives) | "int8" | "int4g":
        quantize the decode path's mp collectives (the row-split
        all-reduces, the embedding's, the vocab-parallel logits). tp = 1
        ignores it (no wire).
    int4_group: scale-group width of the "int4g" wire.
    sp_attention: one of SP_ATTENTION_MODES; sp = 1 normalizes ring and
        ulysses to "allgather" (nothing to rotate).
    """

    tp: int = 1
    dp: int = 1
    sp: int = 1
    ranks: tuple = None
    collective_quant: str = None
    int4_group: int = 32
    sp_attention: str = "allgather"

    def __post_init__(self):
        for field_name in ("tp", "dp", "sp", "int4_group"):
            v = getattr(self, field_name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"ShardedEngineConfig.{field_name}={v!r} must be a "
                    f"positive int")
        if self.sp > 1 and self.dp > 1:
            raise ValueError(
                f"ShardedEngineConfig(sp={self.sp}, dp={self.dp}): "
                f"sp>1 requires dp==1 — sequence parallel shards ONE "
                f"packed prefill stream while dp splits the pool's "
                f"block axis into independent groups; the composed "
                f"layout is not implemented")
        from .collectives import normalize_collective_quant

        normalize_collective_quant(self.collective_quant)
        if self.sp_attention not in SP_ATTENTION_MODES:
            raise ValueError(
                f"ShardedEngineConfig.sp_attention="
                f"{self.sp_attention!r} must be one of "
                f"{SP_ATTENTION_MODES}")
        if self.sp == 1 and self.sp_attention != "allgather":
            _log.debug("ShardedEngineConfig(sp=1, sp_attention=%r): "
                       "normalized to 'allgather'", self.sp_attention)
            object.__setattr__(self, "sp_attention", "allgather")
        if self.ranks is not None:
            object.__setattr__(self, "ranks",
                               tuple(int(r) for r in self.ranks))

    @property
    def total(self):
        return self.tp * self.dp * self.sp

    def build_mesh(self):
        """The (dp, pp, mp, sp) mesh of this config — pp = 1, mp = tp.
        Collective (group creation): every rank of the world calls it.
        Raises naming the world size it needs when the world is short."""
        from ..parallel.mesh import _world, make_mesh

        world, _ = _world()
        ranks = self.ranks
        if ranks is None:
            if world < self.total:
                raise ValueError(
                    f"ShardedEngineConfig(tp={self.tp}, dp={self.dp}, "
                    f"sp={self.sp}) needs {self.total} ranks, the "
                    f"torch.distributed world has {world} (start "
                    f"{self.total} processes and init_process_group with "
                    f"world_size={self.total})")
            ranks = tuple(range(self.total))
        elif len(ranks) != self.total:
            raise ValueError(
                f"ShardedEngineConfig(tp={self.tp}, dp={self.dp}, "
                f"sp={self.sp}) needs exactly {self.total} ranks, got "
                f"{len(ranks)}")
        elif max(ranks) >= world:
            raise ValueError(
                f"ShardedEngineConfig ranks {list(ranks)} need a world of "
                f"{max(ranks) + 1} ranks, the world has {world}")
        return make_mesh(dp=self.dp, mp=self.tp, pp=1, sp=self.sp,
                         ranks=list(ranks))

    def stats_block(self):
        """The `stats()["sharding"]` dict of an enabled server."""
        return {
            "enabled": True,
            "mesh_shape": {"dp": self.dp, "mp": self.tp, "sp": self.sp},
            "tp_degree": self.tp,
            "dp_degree": self.dp,
            "sp_degree": self.sp,
            "collective_quant": self.collective_quant or "none",
            "sp_attention": self.sp_attention,
        }


def normalize_sharding(sharding, num_heads):
    """The server's `sharding=` value (True -> the default config),
    checked eagerly: tp must divide the head count (the pool splits its
    head axis over mp), and ulysses needs the mp-local heads divisible
    by sp."""
    if sharding is True:
        sharding = ShardedEngineConfig()
    if not isinstance(sharding, ShardedEngineConfig):
        raise TypeError(f"sharding must be a ShardedEngineConfig, True "
                        f"or None, got {type(sharding).__name__}")
    if num_heads % sharding.tp:
        raise ValueError(
            f"ShardedEngineConfig.tp={sharding.tp} must divide the "
            f"model's num_heads={num_heads}: the KV pool shards its "
            f"head axis over the mp mesh axis")
    if sharding.sp_attention == "ulysses":
        local_heads = num_heads // sharding.tp
        if local_heads % sharding.sp:
            raise ValueError(
                f"ShardedEngineConfig(sp_attention='ulysses', "
                f"sp={sharding.sp}, tp={sharding.tp}): ulysses needs "
                f"the mp-local head count ({local_heads}) divisible by "
                f"sp ({sharding.sp}); use ring attention for "
                f"head-count-agnostic sequence parallelism")
    return sharding


def disabled_stats_block():
    """The zeroed `stats()["sharding"]` block of an unsharded server."""
    return {
        "enabled": False,
        "mesh_shape": {},
        "tp_degree": 0,
        "dp_degree": 0,
        "sp_degree": 0,
        "collective_quant": "none",
        "sp_attention": "none",
    }
