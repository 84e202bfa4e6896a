"""Strategy lowering — the meta-optimizers, over torch.distributed.

The port of `paddle_tpu/distributed/fleet/meta.py`. Each strategy flag
lowers to one mechanism of the train step `build_hybrid_train_step`
builds, one process a rank on `parallel.mesh`:

  amp             -> the float leaves cast to bf16 inside the loss; the
                     float32 masters take the gradients (amp_optimizer)
  recompute       -> torch.utils.checkpoint (use_reentrant=False) around
                     the loss; "selective" saves the weight GEMMs (mm,
                     addmm), "dots" every product (bmm and baddbmm too),
                     "full" nothing (recompute_optimizer)
  gradient_merge  -> k microbatches, gradients summed (and averaged)
                     before one reduction (gradient_merge_optimizer)
  sharding (ZeRO) -> stage 1: slots split over dp; stage 2: gradients
                     reduce-scattered into the slot shard; stage 3: the
                     params split too, all-gathered before the forward
                     (sharding_optimizer)
  fp16_allreduce  -> the reduced float32 gradient rounded to bf16 and
                     back, the reference's arithmetic (:166-168)
  localsgd        -> a copy a rank, averaged over dp every k steps
  dgc             -> top-k gradient compression with a residual a rank
  int8_allreduce  -> `distributed.collective.bucketed_quantized_all_reduce`
  lamb / lars     -> the optimizer swapped (`wrap_optimizer`)
  pipeline        -> `parallel.pipeline.make_pipeline_loss` over pp

The step keeps the reference's contract, `step(params, opt_state, batch,
key) -> (loss, params, opt_state)`, with the GLOBAL batch (a dict of
tensors or numpy arrays, dim 0 the batch): every rank takes its dp rows
(with gradient merge, its rows of each of the k microbatches, as the
reference's reshape to [k, B/k] sharded on dp). The loss is the mean over
dp of the ranks' losses and each gradient the mean over dp, which for a
loss that is a mean over equal shards is the reference's global mean.
Params and slots are updated in place and returned.

The reference's GSPMD shards any pure loss; the port has no partitioner.
A plain `loss_fn(params, batch, key)` runs REPLICATED over mp, sp and pp
(every rank of a dp group computes the same loss on the same rows: the
reference's result, computed redundantly; ROADMAP §C 20). A mesh-aware
loss — one that carries `loss_fn.grad_axes`, like
`models.gpt2_hybrid.build_hybrid_gpt2_loss`'s — runs on this rank's
params and batch as given, returns the global loss itself, and its
gradients are summed over `grad_axes`.

Placement. Where the reference's `in_shardings` reshards a full array, the
step takes a full leaf (params, or slots from `optimizer.functional_init`)
and keeps this rank's part: the first dim dp divides for ZeRO
(`_zero_spec`, :181-187; leaves with none stay replicated), the stage
slice for the pipeline. `step.init_opt_state(params, device=None)` places
both at once and returns (params for the step, opt state);
`step.gather_params(params)` gives the full leaves back. `compile_for`
returns the step: nothing compiles here.

Lamb and Lars under ZeRO take their trust ratios' norms over the whole
leaf: the squared norms of the shards are all-reduced over dp first.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ... import optimizer as opt_mod
from ...device import resolve_device
from ...parallel import comm
from ...parallel.mesh import make_mesh, set_mesh
from ...parallel.zero import DPAxis, zero_dim


def wrap_optimizer(fleet_obj, optimizer, strategy):
    """lamb replaces any other optimizer, lars a Momentum (the reference's
    `_can_apply`); the other flags act when the step is built."""
    if strategy.lamb and not isinstance(optimizer, opt_mod.Lamb):
        optimizer = opt_mod.Lamb(
            learning_rate=optimizer._lr,
            lamb_weight_decay=strategy.lamb_configs.get("lamb_weight_decay",
                                                        0.01),
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip, device=optimizer.device)
    elif strategy.lars and isinstance(optimizer, opt_mod.Momentum):
        optimizer = opt_mod.Lars(
            learning_rate=optimizer._lr, momentum=optimizer._momentum,
            lars_coeff=strategy.lars_configs.get("lars_coeff", 0.001),
            lars_weight_decay=strategy.lars_configs.get("lars_weight_decay",
                                                        0.0005),
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip, device=optimizer.device)
    optimizer._fleet_strategy = strategy
    return optimizer


def _saving(ops):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _remat_policy(strategy):
    """recompute_configs["granularity"] -> a selective-checkpoint policy
    (None: recompute everything): "selective" saves the products without
    batch dims (the weight GEMMs), "dots" every product."""
    gran = (strategy.recompute_configs or {}).get("granularity", "full")
    aten = torch.ops.aten
    weight = {aten.mm.default, aten.addmm.default}
    table = {"full": None, "selective": weight,
             "dots": weight | {aten.bmm.default, aten.baddbmm.default}}
    if gran not in table:
        raise ValueError(
            f"recompute_configs.granularity must be one of {list(table)}, "
            f"got {gran!r}")
    return None if table[gran] is None else _saving(table[gran])


def _cast_bf16(params):
    if torch.is_tensor(params):
        return params.to(torch.bfloat16) if params.is_floating_point() \
            else params
    return {n: _cast_bf16(v) for n, v in params.items()}


def apply_strategy(strategy, loss_fn):
    """Wrap a loss_fn(params, batch, key) by the recompute and amp flags.
    Under recompute a torch.Generator `key` is rewound before the
    recomputation, so dropout draws the same masks."""
    fn = loss_fn
    if strategy.recompute:
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        policy = _remat_policy(strategy)
        kw = {} if policy is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
        inner = fn

        def remat_fn(params, batch, key):
            state = key.get_state() if isinstance(key, torch.Generator) \
                else None

            def run(params, batch):
                if state is not None:
                    key.set_state(state)
                return inner(params, batch, key)
            return checkpoint(run, params, batch, use_reentrant=False, **kw)
        fn = remat_fn
    if strategy.amp:
        inner_amp = fn

        def amp_fn(params, batch, key):
            return inner_amp(_cast_bf16(params), batch, key)
        fn = amp_fn
    return fn


def _to_device(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _grads_of(fn, leaves, batch, key):
    loss = fn(leaves, batch, key)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, {n: (torch.zeros_like(p) if g is None else g)
                  for (n, p), g in zip(leaves.items(), gs)}


def _mesh_from(strategy, mesh):
    if mesh is not None:
        return mesh
    hybrid = strategy.hybrid_configs
    dp = hybrid.get("dp_degree", -1)
    mesh = make_mesh(dp=None if dp in (-1, None) else dp,
                     mp=hybrid.get("mp_degree", 1),
                     pp=hybrid.get("pp_degree", 1),
                     sp=hybrid.get("sp_degree", 1))
    set_mesh(mesh)
    return mesh


def _pipeline_loss(strategy, mesh, stage_fn, loss_head):
    if stage_fn is None or loss_head is None:
        raise ValueError(
            "strategy.pipeline with pp_degree>1 needs stage_fn and "
            "loss_head (the per-stage computation and the loss on the last "
            "stage's output)")
    from ...parallel.pipeline import make_pipeline_loss
    cfg = strategy.pipeline_configs
    sched = cfg.get("schedule", "gpipe")
    nv = cfg.get("num_virtual", 1)
    pl_loss = make_pipeline_loss(stage_fn, loss_head, mesh,
                                 cfg.get("accumulate_steps", 1), "pp",
                                 schedule=sched, num_virtual=nv)

    def loss_fn(params, batch, key):
        return pl_loss(params, batch["x"], batch.get("labels",
                                                     batch.get("y")))
    return loss_fn, sched, nv


def build_hybrid_train_step(strategy, loss_fn, optimizer, mesh=None,
                            stage_fn=None, loss_head=None):
    """The train step of `strategy` (module docstring). Returns (step,
    mesh). strategy.pipeline with pp > 1 needs `stage_fn` ((stage_params,
    x) -> y) and `loss_head` ((y, labels) -> scalar); the params are then
    stacked [stages, ...] leaves (or one tensor) and `loss_fn` may be
    None."""
    mesh = _mesh_from(strategy, mesh)
    pipe = None
    if strategy.pipeline and mesh.size("pp") > 1:
        loss_fn, sched, nv = _pipeline_loss(strategy, mesh, stage_fn,
                                            loss_head)
        pipe = (sched, nv)
    if strategy.localsgd or strategy.dgc or strategy.int8_allreduce:
        return _build_explicit_dp_step(strategy, loss_fn, optimizer, mesh)

    wrapped = apply_strategy(strategy, loss_fn)
    aware = getattr(loss_fn, "grad_axes", None)
    k_steps = strategy.gradient_merge_configs.get("k_steps", 1) \
        if strategy.gradient_merge else 1
    avg = strategy.gradient_merge_configs.get("avg", True)
    stage = strategy.sharding_configs.get("stage", 2) \
        if strategy.sharding else 0
    if stage and (pipe is not None or aware is not None):
        raise ValueError(
            "sharding (ZeRO) is lowered for a plain loss over dp; with "
            "the pipeline or a mesh-aware loss it is not (the hybrid GPT-2 "
            "has its own ZeRO-1: gpt2_hybrid.zero_update)")
    dp = DPAxis(mesh)
    clip = getattr(optimizer._grad_clip, "clip_tree", None) \
        if optimizer._grad_clip is not None else None
    layout = {}  # name -> (full shape, ZeRO dim or None)

    def learn(params):
        if not layout:
            for n, p in params.items():
                d = zero_dim(p.shape, dp.n) if stage and dp.n > 1 else None
                layout[n] = (tuple(p.shape), d)

    def dims_of(names):
        return {n: layout[n][1] for n in names if layout[n][1] is not None}

    def place_params(params):
        """Full leaves -> this rank's part (ZeRO-3 chunk, pipeline stage)."""
        if pipe is not None:
            from ...parallel.pipeline import stage_slice
            s = mesh.size("pp") * pipe[1]
            if all(p.shape[0] == s for p in params.values()):
                return {n: p.detach().clone() for n, p in stage_slice(
                    params, mesh, pipe[0], pipe[1]).items()}
            return params
        learn(params)
        if stage < 3:
            return params
        return {n: (dp.chunk(p, layout[n][1]).clone()
                    if layout[n][1] is not None
                    and tuple(p.shape) == layout[n][0] else p)
                for n, p in params.items()}

    def place_state(opt_state):
        """Full slots -> the ZeRO chunk (stages 1-3) or the stage slice."""
        if pipe is not None:
            from ...parallel.pipeline import stage_slice
            s = mesh.size("pp") * pipe[1]
            for n, slots in opt_state["slots"].items():
                for k, v in slots.items():
                    if v.dim() and v.shape[0] == s:
                        slots[k] = stage_slice({"": v}, mesh, pipe[0],
                                               pipe[1])[""].clone()
            return opt_state
        if not stage:
            return opt_state
        for n, slots in opt_state["slots"].items():
            full, d = layout[n]
            if d is None:
                continue
            for k, v in slots.items():
                if tuple(v.shape) == full:
                    slots[k] = dp.chunk(v, d).clone()
        return opt_state

    def value_and_grad(params, batch, key, reduce=True):
        """(loss, grads): the wrapped loss on this rank's rows (merged over
        the k microbatches), the mean over dp, and its gradients — the
        mean over dp too unless reduce=False (a mesh-aware loss: summed
        over its grad_axes). params are full (a dict, or one tensor)."""
        if torch.is_tensor(params):
            loss, grads = value_and_grad({"": params}, batch, key, reduce)
            return loss, grads[""]
        fn = wrapped
        if list(params) == [""]:
            def fn(p, b, k):
                return wrapped(p[""], b, k)
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        if aware is None:
            dev = next(iter(params.values())).device
            batch = dp.rows({n: _to_device(x, dev) for n, x in
                             batch.items()}, k_steps)
        elif k_steps > 1:
            batch = {n: x.reshape((k_steps, x.shape[0] // k_steps)
                                  + tuple(x.shape[1:]))
                     for n, x in batch.items()}
        if k_steps > 1:
            loss, grads = 0.0, None
            for i in range(k_steps):
                li, gi = _grads_of(fn, leaves,
                                   {n: x[i] for n, x in batch.items()}, key)
                loss = loss + li.detach()
                grads = gi if grads is None else \
                    {n: grads[n] + gi[n] for n in grads}
            if avg:
                loss = loss / k_steps
                grads = {n: g / k_steps for n, g in grads.items()}
        else:
            loss, grads = _grads_of(fn, leaves, batch, key)
            loss = loss.detach()
        if aware is not None:
            comm.reduce_gradients(grads, lambda _n: aware, mesh)
            return loss, grads
        lf = loss.float().reshape(1)
        dp.mean_([lf])
        if reduce:
            with torch.no_grad():
                dp.mean_(list(grads.values()))
        return lf[0].to(loss.dtype), grads

    def step(params, opt_state, batch, key):
        single = torch.is_tensor(params)
        if single:
            params = {"": params}
            opt_state = {"slots": {"": opt_state["slots"]},
                         "t": opt_state["t"]}
        params = place_params(params)
        opt_state = place_state(opt_state)
        sharded = dims_of(params) if stage else {}
        full = dict(params)
        if stage >= 3 and sharded:
            full.update(dp.gather({n: params[n] for n in sharded}, sharded))
        loss, grads = value_and_grad(full, batch, key, reduce=False)
        with torch.no_grad():
            if aware is None:
                repl = [grads[n] for n in grads
                        if stage < 2 or n not in sharded]
                dp.mean_(repl)
                if stage >= 2 and sharded:
                    grads.update(dp.reduce_scatter_mean(
                        {n: grads[n] for n in sharded}, sharded))
            if strategy.fp16_allreduce:
                grads = {n: g.to(torch.bfloat16).to(g.dtype)
                         for n, g in grads.items()}
            if clip is not None:
                grads = _clip(clip, grads, sharded if stage >= 2 else {},
                              dp)
            if stage == 1 and sharded:
                grads = {n: (dp.chunk(g, sharded[n]) if n in sharded else g)
                         for n, g in grads.items()}
            views = {n: (dp.chunk(p, sharded[n])
                         if n in sharded and stage < 3 else p)
                     for n, p in params.items()}
            norms = {n: dp.norm_fn() for n in sharded} or None
            optimizer.functional_update(views, grads, opt_state,
                                        norms=norms)
            if stage in (1, 2) and sharded:
                whole = dp.gather({n: views[n] for n in sharded}, sharded)
                for n, w in whole.items():
                    params[n].copy_(w)
        if single:
            return loss, params[""], {"slots": opt_state["slots"][""],
                                      "t": opt_state["t"]}
        return loss, params, opt_state

    def init_opt_state(params, device=None):
        """(params for the step, opt state) on `device` (None: the first
        card; "cpu" on request): the leaves copied there and placed, the
        slots built for this rank's part."""
        dev = resolve_device(device)
        single = torch.is_tensor(params)
        tree = {"": params} if single else params
        tree = place_params({n: _to_device(p, dev).detach().clone()
                             for n, p in tree.items()})
        sharded = dims_of(tree) if stage else {}
        views = {n: (dp.chunk(p, sharded[n])
                     if n in sharded and stage < 3 else p)
                 for n, p in tree.items()}
        state = optimizer.functional_init(views)
        if single:
            return tree[""], {"slots": state["slots"][""], "t": 0}
        return tree, state

    def gather_params(params):
        """The full leaves of params the step returned."""
        single = torch.is_tensor(params)
        tree = {"": params} if single else params
        if pipe is not None:
            out = {n: _gather_stage(p, mesh, pipe) for n, p in tree.items()}
        elif stage >= 3:
            sh = {n: d for n, d in dims_of(tree).items()
                  if tuple(tree[n].shape) != layout[n][0]}
            out = dict(tree)
            out.update(dp.gather({n: tree[n] for n in sh}, sh))
        else:
            out = tree
        return out[""] if single else out

    step.compile_for = lambda params, batch, opt_state=None: step
    step.init_opt_state = init_opt_state
    step.gather_params = gather_params
    step.value_and_grad = value_and_grad
    step.mesh = mesh
    return step, mesh


def _gather_stage(p, mesh, pipe):
    """A pipeline leaf's stage slice -> the full [stages * V, ...] stack."""
    sched, nv = pipe
    group = mesh.group("pp")
    parts = comm.all_gather(p.contiguous(), group)
    if sched == "interleaved" and nv > 1:
        full = torch.cat(parts, 1)  # [V, S, ...] in layer order l*S + r
        return full.reshape((-1,) + tuple(full.shape[2:]))
    return torch.cat(parts, 0)


def _clip(clip, grads, sharded, dp):
    """Global-norm clipping; the sum of squares of sharded leaves is
    all-reduced over dp."""
    repl = sum(torch.sum(g * g) for n, g in grads.items()
               if n not in sharded)
    if sharded:
        sq = sum(torch.sum(grads[n] * grads[n]) for n in sharded).reshape(1)
        comm.all_reduce_(sq, dp.group)
        repl = repl + sq[0]
    return clip(grads, sq_sum=repl)


def _build_explicit_dp_step(strategy, loss_fn, optimizer, mesh):
    """localsgd / dgc / int8_allreduce: each rank's own gradient meets the
    collective by hand.

    localsgd: every rank keeps its own params and slots, updates them from
    its own gradients, and they are averaged over dp when the step counter
    ct satisfies ct % k == k - 1 (the reference stacks the copies [dp,
    ...]; rank r's copy here is its row r). dgc: the gradient plus the
    rank's residual keeps its entries of magnitude >= the k-th largest (k
    = max(1, int(n * (1 - sparsity))); ties keep all), the rest stays in
    the residual, and the kept gradient is averaged over dp.
    int8_allreduce (off under localsgd, which has its own schedule): the
    bucketed quantized all-reduce, divided by dp."""
    from ..collective import bucketed_quantized_all_reduce

    wrapped = apply_strategy(strategy, loss_fn)
    dp = DPAxis(mesh)
    use_localsgd, use_dgc = strategy.localsgd, strategy.dgc
    k_steps = strategy.localsgd_configs.get("k_steps", 1)
    sparsity = strategy.dgc_configs.get("sparsity", [0.999])[-1] \
        if use_dgc else 0.0

    def compress(g, e):
        g = g + e
        flat = g.reshape(-1)
        kk = max(1, int(flat.numel() * (1.0 - sparsity)))
        thresh = torch.topk(flat.abs(), kk).values[-1]
        send = torch.where(g.abs() >= thresh, g, torch.zeros_like(g))
        return send, g - send

    def step(params, opt_state, batch, key):
        inner, err, ct = opt_state["inner"], opt_state["dgc_err"], \
            opt_state["step"]
        dev = next(iter(params.values())).device
        rows = dp.rows({n: _to_device(x, dev) for n, x in batch.items()})
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss, grads = _grads_of(wrapped, leaves, rows, key)
        with torch.no_grad():
            if use_dgc:
                pairs = {n: compress(g, err[n]) for n, g in grads.items()}
                grads = {n: s for n, (s, _) in pairs.items()}
                err = {n: e for n, (_, e) in pairs.items()}
                dp.mean_(list(grads.values()))
            elif strategy.int8_allreduce and not use_localsgd:
                red = bucketed_quantized_all_reduce(grads, "dp", mesh=mesh)
                grads = {n: g / dp.n for n, g in red.items()}
            elif not use_localsgd:
                dp.mean_(list(grads.values()))
            optimizer.functional_update(params, grads, inner)
            if use_localsgd and ct % k_steps == k_steps - 1:
                dp.mean_(list(params.values()))
            lf = loss.detach().float().reshape(1)
            dp.mean_([lf])
        return lf[0].to(loss.dtype), params, {"inner": inner, "dgc_err": err,
                                              "step": ct + 1}

    def init_opt_state(params, device=None):
        """(params, opt state) on `device` (None: the first card): the
        step counter, the optimizer's slots and the dgc residuals."""
        dev = resolve_device(device)
        params = {n: _to_device(p, dev).detach().clone()
                  for n, p in params.items()}
        inner = optimizer.functional_init(params)
        err = {n: (torch.zeros_like(p) if use_dgc else
                   torch.zeros((), dtype=p.dtype, device=dev))
               for n, p in params.items()}
        return params, {"inner": inner, "dgc_err": err, "step": 0}

    step.compile_for = lambda params, batch, opt_state=None: step
    step.init_opt_state = init_opt_state
    step.gather_params = lambda params: params
    step.mesh = mesh
    return step, mesh


def applied_mechanisms(strategy):
    """The active flags and the mechanism each lowers to, in the
    reference's names (`_get_applied_meta_list`)."""
    if strategy is None:
        return []
    table = (("amp", "AMPOptimizer->bf16_compute_policy"),
             ("recompute", "RecomputeOptimizer->torch.utils.checkpoint"),
             ("sharding", "ShardingOptimizer->zero_param_sharding"),
             ("gradient_merge", "GradientMergeOptimizer->microbatch_scan"),
             ("pipeline", "PipelineOptimizer->pp_mesh_axis_gpipe"),
             ("localsgd", "LocalSGDOptimizer->periodic_psum_average"),
             ("dgc", "DGCMomentumOptimizer->topk_grad_compression"),
             ("int8_allreduce",
              "Int8AllReduce->quantized_reduce_scatter_all_gather"),
             ("lamb", "LambOptimizer->lamb_rule"),
             ("lars", "LarsOptimizer->lars_rule"))
    return [m for flag, m in table if getattr(strategy, flag, False)]


__all__ = ["wrap_optimizer", "apply_strategy", "build_hybrid_train_step",
           "applied_mechanisms"]
