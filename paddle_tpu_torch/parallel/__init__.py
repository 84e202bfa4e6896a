"""paddle_tpu_torch.parallel — the mesh over torch.distributed, its
collectives, sequence parallelism (ring, zigzag ring, Ulysses), the
pipeline schedules, MoE, and the dp axis's batch split and ZeRO shards
(`zero`).

The port of `paddle_tpu/parallel/`: one process per rank
(`mesh.make_mesh` maps ranks to (dp, pp, mp, sp) coordinates), explicit
differentiable collectives (`comm`) where the reference has shard_map's
transposes, and the flash kernels inside every ring step
(`ring_attention`).
"""
from __future__ import annotations

from .mesh import (  # noqa: F401
    current_mesh, get_mesh, make_mesh, mesh_guard, MeshConfig, P, set_mesh,
)
from .api import (  # noqa: F401
    data_parallel_shardings, replicate, shard_batch, shard_params_tp,
    sharded_train_step, tp_spec_for,
)
from .ring_attention import (  # noqa: F401
    ring_attention, ring_attention_sharded, zigzag_ring_attention,
    zigzag_ring_attention_sharded)
from .ulysses import sp_attention, ulysses_attention  # noqa: F401
