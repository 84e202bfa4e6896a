"""Mixture-of-Experts with expert parallelism over the `ep` mesh axis.

The port of `paddle_tpu/parallel/moe.py`: top-2 gating with a static
capacity, capacity-bounded dispatch as one einsum pair, experts split
over `ep` (each rank holds E/ep of them). The reference leaves the
all-to-all to GSPMD; here it is explicit:

  * every rank computes the gating of all T tokens (the gate is
    replicated; capacity positions are global, so each (expert, slot)
    holds exactly one token);
  * each rank dispatches its T/ep tokens (`comm.scatter_to`) into
    [E, C, D] and an all-to-all over `ep` sends expert e's rows to the
    rank that holds e, which sums what the ranks sent (one token a slot:
    exact);
  * the local experts run; their [E/ep, C, D] outputs are gathered over
    ep (`comm.gather_from`) and every rank combines all T tokens.

The experts' axis is `ep_axis` (default "ep") of the mesh — e.g.
`Mesh({"ep": 4}, range(4))`, or "dp" of a `make_mesh` mesh. A mesh
without that axis, or with one rank on it, runs the whole layer on every
rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import comm
from .mesh import local_slice, resolve_mesh


def top2_gating(logits, capacity, key=None, second_policy="all"):
    """Switch/GShard-style top-2 gating with static capacity.

    logits: [T, E]. Returns (combine [T, E, C], dispatch bool [T, E, C],
    aux)."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    g1_idx = probs.argmax(-1)
    g1_prob = probs.amax(-1)
    probs_wo1 = probs * (1 - F.one_hot(g1_idx, e).to(probs.dtype))
    g2_idx = probs_wo1.argmax(-1)
    g2_prob = probs_wo1.amax(-1)

    # load-balancing auxiliary loss (GShard)
    me = probs.mean(0)
    ce = F.one_hot(g1_idx, e).to(probs.dtype).mean(0)
    aux = (me * ce).sum() * e

    oh1 = F.one_hot(g1_idx, e)
    pos1 = (oh1.cumsum(0) * oh1 - 1).amax(-1)
    # second choices queue after all first choices
    count1 = oh1.sum(0)
    oh2 = F.one_hot(g2_idx, e)
    pos2 = (oh2.cumsum(0) * oh2 - 1).amax(-1) + count1[g2_idx]

    keep1 = pos1 < capacity
    keep2 = pos2 < capacity
    denom = torch.clamp_min(g1_prob + g2_prob, 1e-9)
    w1 = torch.where(keep1, g1_prob / denom, torch.zeros_like(g1_prob))
    w2 = torch.where(keep2, g2_prob / denom, torch.zeros_like(g2_prob))

    def scatter(idx, pos, w, keep):
        e_oh = F.one_hot(idx, e).to(logits.dtype)
        c_oh = F.one_hot(torch.where(keep, pos, torch.zeros_like(pos)),
                         capacity).to(logits.dtype)
        return w[:, None, None] * e_oh[:, :, None] * c_oh[:, None, :]

    combine = scatter(g1_idx, pos1, w1, keep1) + \
        scatter(g2_idx, pos2, w2, keep2)
    return combine, combine > 0, aux


def _experts(params, expert_in):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, params["w1"])
               + params["b1"][:, None, :], approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, params["w2"]) \
        + params["b2"][:, None, :]


def moe_layer_apply(params, x, capacity_factor=1.25, mesh=None,
                    ep_axis="ep"):
    """MoE FFN: params {"gate": [D, E], "w1": [E_local, D, H], "b1":
    [E_local, H], "w2": [E_local, H, D], "b2": [E_local, D]} (the local
    experts when `ep_axis` of the mesh splits them), x [T, D] the same on
    every rank. Returns ([T, D], aux_loss) on every rank."""
    t, d = x.shape
    e = params["gate"].shape[1]
    capacity = max(1, int(capacity_factor * t / e))
    logits = x @ params["gate"]
    combine, dispatch, aux = top2_gating(logits, capacity)
    mesh = resolve_mesh(mesh)
    if ep_axis not in mesh.shape or mesh.size(ep_axis) == 1:
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        return torch.einsum("tec,ecd->td", combine,
                            _experts(params, expert_in)), aux
    n = mesh.size(ep_axis)
    if t % n or e % n:
        raise ValueError(f"moe over {n} ranks needs tokens ({t}) and "
                         f"experts ({e}) divisible by {n}")
    # this rank's tokens into every expert's slots, then expert rows home
    x_mine = comm.scatter_to(x, ep_axis, 0, mesh)
    disp_mine = comm.scatter_to(dispatch.to(x.dtype), ep_axis, 0, mesh)
    part = torch.einsum("tec,td->ecd", disp_mine, x_mine)
    expert_in = comm.all_to_all(part, ep_axis, 0, 0, mesh)
    c = expert_in.shape[1]
    expert_in = expert_in.reshape(n, e // n, c, d).sum(0)
    out_local = _experts(params, expert_in)
    expert_out = comm.gather_from(out_local, ep_axis, 0, mesh)
    return torch.einsum("tec,ecd->td", combine, expert_out), aux


def init_moe_params(generator, d_model, d_hidden, num_experts,
                    dtype=torch.float32, device=None):
    """He-normal experts and gate from a torch.Generator (the reference
    draws from a jax key; tests carry its arrays across instead), on
    `device` (None: the first card; "cpu" on request)."""
    device = resolve_device(device)
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_hidden) ** 0.5

    def nrm(*shape, std):
        return (torch.randn(*shape, generator=generator,
                            device=generator.device) * std).to(
            dtype=dtype, device=device)

    return {"gate": nrm(d_model, num_experts, std=s1),
            "w1": nrm(num_experts, d_model, d_hidden, std=s1),
            "b1": torch.zeros(num_experts, d_hidden, dtype=dtype,
                              device=device),
            "w2": nrm(num_experts, d_hidden, d_model, std=s2),
            "b2": torch.zeros(num_experts, d_model, dtype=dtype,
                              device=device)}


def moe_shardings(mesh, params, ep_axis="ep"):
    """{name: spec}: the gate replicated, the experts split over ep."""
    spec = {"gate": (), "w1": (ep_axis,), "b1": (ep_axis,),
            "w2": (ep_axis,), "b2": (ep_axis,)}
    return {k: spec[k] for k in params}


def moe_local_params(mesh, params, ep_axis="ep"):
    """This rank's slice of global MoE params by `moe_shardings`."""
    specs = moe_shardings(mesh, params, ep_axis)
    return {k: local_slice(v, specs[k], mesh.coords, mesh.shape)
            for k, v in params.items()}


__all__ = ["top2_gating", "moe_layer_apply", "init_moe_params",
           "moe_shardings", "moe_local_params"]
