"""Fleet base: DistributedStrategy, the role makers and the Fleet
singleton — the port of `paddle_tpu/distributed/fleet/base.py`.

The strategy keeps the reference's field names (their lowering is
`meta.py`'s). `Fleet.init` resolves this rank's device first — the card
(`collective.rank_device`), raising without one unless `device="cpu"`
is passed — then joins the world (`init_parallel_env`). After
`distributed_optimizer(opt)` the fleet is the optimizer's facade
(`minimize`, `step`, `get_lr`, ...), on the optimizer the strategy
swapped in (lamb, lars).
"""
from __future__ import annotations

import os


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {"sharding_degree": 1, "stage": 2}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005}
        self.fp16_allreduce = False
        # int8 blockwise-quantized gradient all-reduce (EQuARX pattern),
        # lowered through the explicit-dp step
        self.int8_allreduce = False
        self.nccl_comm_num = 1
        self.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                               "pp_degree": 1, "sp_degree": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.without_graph_optimization = False

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"


class _RoleMakerBase:
    def __init__(self, is_collective=True, **kw):
        self._is_collective = is_collective
        # PS-mode roles come from the launcher's environment; collective
        # mode is all workers
        self._role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()

    def worker_index(self):
        from ..collective import get_rank
        return get_rank()

    def worker_num(self):
        from ..collective import get_world_size
        return get_world_size()

    def is_worker(self):
        return self._role == "TRAINER"

    def is_server(self):
        return self._role == "PSERVER"

    def is_first_worker(self):
        return self.is_worker() and self.worker_index() == 0


class PaddleCloudRoleMaker(_RoleMakerBase):
    pass


class UserDefinedRoleMaker(_RoleMakerBase):
    def __init__(self, is_collective=True, current_id=0, role=None,
                 worker_num=None, server_endpoints=None, **kw):
        super().__init__(is_collective, **kw)
        if role is not None:
            self._role = str(role).upper()
            if self._role == "WORKER":
                self._role = "TRAINER"
        self._current_id = current_id
        self._worker_num = worker_num

    def worker_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num or super().worker_num()


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._origin_optimizer = None
        self._origin_model = None
        self._wrapped_optimizer = None
        self.device = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None):
        """Resolve this rank's device (None: its card; "cpu" on request),
        join the world, keep the role maker and strategy."""
        from ..collective import init_parallel_env, rank_device
        self.device = rank_device(device)
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=self.device)
        return self

    # ---- role queries ----
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    def worker_endpoints(self, to_string=False):
        eps = getattr(self._role_maker, "worker_endpoints", None)
        eps = eps() if callable(eps) else (eps or [])
        return ",".join(eps) if to_string else list(eps)

    def server_num(self):
        f = getattr(self._role_maker, "server_num", None)
        return f() if callable(f) else 0

    def server_index(self):
        f = getattr(self._role_maker, "server_index", None)
        return f() if callable(f) else 0

    def server_endpoints(self, to_string=False):
        eps = getattr(self._role_maker, "server_endpoints", None)
        eps = eps() if callable(eps) else (eps or [])
        return ",".join(eps) if to_string else list(eps)

    # ---- training ----
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        self._origin_optimizer = optimizer
        from .meta import wrap_optimizer
        self._wrapped_optimizer = wrap_optimizer(self, optimizer,
                                                 self._strategy)
        return self._wrapped_optimizer

    def distributed_model(self, model):
        from ..parallel import DataParallel
        self._origin_model = model
        return DataParallel(model)

    @property
    def strategy(self):
        return self._strategy

    # ---- the optimizer's facade ----
    def _user_opt(self):
        if self._wrapped_optimizer is not None:
            return self._wrapped_optimizer
        if self._origin_optimizer is None:
            raise RuntimeError(
                "call fleet.distributed_optimizer(optimizer) first")
        return self._origin_optimizer

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._user_opt().minimize(
            loss, startup_program=startup_program, parameters=parameters,
            no_grad_set=no_grad_set)

    def step(self):
        return self._user_opt().step()

    def clear_grad(self):
        return self._user_opt().clear_grad()

    def set_lr(self, value):
        return self._user_opt().set_lr(value)

    def get_lr(self):
        return self._user_opt().get_lr()

    def state_dict(self):
        return self._user_opt().state_dict()

    def set_state_dict(self, state_dict):
        return self._user_opt().set_state_dict(state_dict)

    # ---- introspection ----
    def _final_strategy(self):
        return self._strategy

    def _get_applied_meta_list(self):
        from .meta import applied_mechanisms
        return applied_mechanisms(self._strategy)

    def _get_applied_graph_list(self):
        return []  # the port has no graph passes

    # ---- io (worker 0) ----
    def save_persistables(self, executor, dirname, main_program=None):
        if self.is_first_worker():
            os.makedirs(dirname, exist_ok=True)

    def save_inference_model(self, *a, **kw):
        pass

    # ---- the parameter server's lifecycle (`distributed/ps.py`) ----
    def stop_worker(self):
        from .. import ps
        ps.stop_worker()

    def init_worker(self):
        from .. import ps
        ps.init_worker()

    def init_server(self, *a, **kw):
        from .. import ps
        ps.init_server(*a, **kw)

    def run_server(self):
        from .. import ps
        ps.run_server()


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    return fleet.init(role_maker, is_collective, strategy, device)


def is_first_worker():
    return fleet.is_first_worker()


def worker_index():
    return fleet.worker_index()


def worker_num():
    return fleet.worker_num()


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def distributed_model(model):
    return fleet.distributed_model(model)


__all__ = ["DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Fleet", "fleet", "init",
           "is_first_worker", "worker_index", "worker_num",
           "distributed_optimizer", "distributed_model"]
