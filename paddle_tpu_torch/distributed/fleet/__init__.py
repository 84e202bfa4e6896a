"""paddle_tpu_torch.distributed.fleet — the fleet API over
torch.distributed: the strategy (`base`), its lowering into the train
step (`meta`), the module facade, `metrics`, `utils` (filesystems, the
KV rendezvous server) and the data generators.

The port of `paddle_tpu/distributed/fleet/`. As in the reference every
Fleet method is also a module attribute bound to the `fleet` singleton
(`fleet.init_worker()`, `fleet.minimize(loss)`).
"""
from __future__ import annotations

from .base import (  # noqa: F401
    DistributedStrategy, Fleet, PaddleCloudRoleMaker, UserDefinedRoleMaker,
    distributed_model, distributed_optimizer, fleet, init, is_first_worker,
    worker_index, worker_num,
)
from .meta import apply_strategy, build_hybrid_train_step  # noqa: F401
from .data_generator import (  # noqa: F401
    DataGenerator, MultiSlotDataGenerator, MultiSlotStringDataGenerator)

_final_strategy = fleet._final_strategy
_get_applied_meta_list = fleet._get_applied_meta_list
_get_applied_graph_list = fleet._get_applied_graph_list
is_worker = fleet.is_worker
worker_endpoints = fleet.worker_endpoints
server_num = fleet.server_num
server_index = fleet.server_index
server_endpoints = fleet.server_endpoints
is_server = fleet.is_server
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
minimize = fleet.minimize
step = fleet.step
clear_grad = fleet.clear_grad
set_lr = fleet.set_lr
get_lr = fleet.get_lr
state_dict = fleet.state_dict
set_state_dict = fleet.set_state_dict


class UtilBase:
    """fleet.util: collectives on host values over the world."""

    def all_reduce(self, input, mode="sum"):  # noqa: A002
        from ..collective import ReduceOp, all_reduce as _ar
        op = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
              "min": ReduceOp.MIN, "avg": ReduceOp.AVG}[mode]
        return _ar(input, op=op)

    def barrier(self):
        from ..collective import barrier as _b
        _b()

    def all_gather(self, input):  # noqa: A002
        from ..collective import all_gather as _ag
        out = []
        _ag(out, input)
        return out


class Role:
    WORKER = 1
    SERVER = 2


from . import metrics  # noqa: E402,F401
from . import utils  # noqa: E402,F401

util = UtilBase()
