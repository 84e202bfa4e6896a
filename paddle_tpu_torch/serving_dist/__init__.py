"""Sharded serving: the paged engine over the ranks of a torch.distributed
world.

The port of `paddle_tpu/serving_dist/`.
`PagedGenerationServer(model, sharding=ShardedEngineConfig(tp, dp, sp))`
serves with its weights and its KV pool split over a mesh
(`parallel.mesh`, axes dp/pp/mp/sp):

  * tp (the `mp` axis): Megatron column/row splits of the weights
    (`plan.shard_decode_params`; the fused qkv cut by head), the pool's
    HEAD axis with them, one all-reduce after each row-split product,
    and the vocab-parallel embedding and head when tp divides the
    vocabulary (`collectives` quantizes these with
    `collective_quant="int8"` / `"int4g"`);
  * dp: the pool's BLOCK axis, split into dp contiguous ranges;
  * sp: the packed prefill stream's token axis (`sp_attention` for the
    memory-flat ring and ulysses modes).

Every rank runs the decode kernels (K1 the ragged stream, K2 the paged
decode) on its own slice of the pool.

THE DESIGN RULE: rank 0 plans, the other ranks follow. The reference has
one controller that drives every device through jits with explicit
shardings; the port's mesh is one process a rank. Rank 0 runs the whole
engine loop: the queue, admission, the front door, `PagedKVCache`'s host
bookkeeping, the drafter and the journal. For each dispatch it
broadcasts one small host-packed header (the program and its mode; the
tokens, seg, pos, block tables and sample indices; the sampling columns
and the penalty counts), then runs the program on its own slices. Every
other rank runs a follower loop (`serve_follower()`): it receives each
header, runs the same `PagedDecoder` program on its slices, and returns
when rank 0 stops. Why not let every rank run the same deterministic
loop? The engine's scheduling reads the wall clock — timeouts and
shedding, SLO lanes and EDF, token buckets, the stall watchdog — so
independent loops would drift apart.

Every DEVICE-SIDE pool operation is mirrored on every rank: a follower
holds only its slice of the pool and sees no host bookkeeping, so rank 0
sends each in-place write as an operation of its own (`engine.
PoolMirror`): the copy-on-write block copy, the tier's demote (each rank
keeps its own slice of the demoted rows) and promote, `import_prefix`
(each rank writes its heads of the payload) and `export_prefix` (the
slices are gathered to rank 0). A missed mirror would show as a token
difference once the prefix cache or preemption is on.

THE DP RULE. In the reference dp is a placement of the pool's block
axis: every device computes every slot and XLA fetches the blocks it
lacks. A rank of the port cannot read another rank's blocks, so: the
block axis splits into dp contiguous ranges (group g holds blocks
[g * N/dp, (g + 1) * N/dp), its first block its own trash block); each
slot is pinned to one group (slot i to group i % dp) and its sequence
allocates only there (a prefix match stops at another group's block);
each group runs every row of a dispatch, the rows of other groups'
slots reading and writing only its trash block, and each row's outputs
(tokens, flags, penalty counts, the async carry) are then taken from the
group that owns it, so every rank ends the dispatch with the same
outputs. Tokens equal the unsharded engine's; block ids, and the pool's
default size (each group sized for its own slots), differ from the
reference's. A host tier is refused under dp > 1.

Every rank constructs the server with the same arguments (SPMD). On rank
0 `start()` / `submit()` / `stop()` behave as unsharded; ranks above 0
call `serve_follower()`, which blocks until rank 0 stops. A world of one
needs no follower: `sharding=True` (or any config of one rank) builds
the unsharded programs, bitwise the unsharded server. With more than one
rank the decode, verify and window dispatches run EAGERLY (gloo
collectives cannot be captured in a CUDA graph, and NCCL refuses two
ranks on one card): K1 and K2 still launch on the card, layer by layer.

An unsharded server never imports this package.
"""
from __future__ import annotations

from .config import (SP_ATTENTION_MODES, ShardedEngineConfig,
                     disabled_stats_block, normalize_sharding)
from .plan import (DecodeShardings, build_decode_shardings,
                   decode_spec_for, kv_pool_specs, place_decode_params,
                   shard_decode_params)
from .engine import (apply_sharding, max_slots_for_budget,
                     pool_blocks_for_budget)
from .collectives import (CollectiveQuant, build_collective_quant,
                          normalize_collective_quant)
from .sp_attention import (build_sp_fresh_attention,
                           sp_attention_flat_bound,
                           sp_attention_peak_bytes)

__all__ = [
    "ShardedEngineConfig", "normalize_sharding", "disabled_stats_block",
    "DecodeShardings", "decode_spec_for", "kv_pool_specs",
    "build_decode_shardings", "place_decode_params", "shard_decode_params", "apply_sharding", "pool_blocks_for_budget",
    "max_slots_for_budget", "CollectiveQuant", "build_collective_quant",
    "normalize_collective_quant", "SP_ATTENTION_MODES",
    "build_sp_fresh_attention", "sp_attention_peak_bytes",
    "sp_attention_flat_bound",
]
