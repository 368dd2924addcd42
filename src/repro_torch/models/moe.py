"""Fine-grained Mixture-of-Experts (DeepSeekMoE style).

Counterpart of ``repro/models/moe.py``: n shared experts always active
plus E routed experts with top-k softmax gating, a capacity-limited
scatter / gather dispatch with Mesh-TF positions from a cumsum (no
(T, E, C) one-hot), and the load-balance and router-z aux losses as
metrics.  ``moe_apply`` takes the explicit-collective dispatch
(:func:`moe_apply_shard_map`) exactly when the reference does:
``cfg.moe_dispatch == "shard_map"`` under active sharding rules
(``distributed.sharding.use_rules``); otherwise, as with no rules
active, the scatter dispatch, which takes the reference's six
``logical_constraint``s (the tokens, the one-hot, the gathered entries,
the expert inputs and outputs, the contributions).

The dispatch keeps the reference's semantics to the entry: a float32
router, top-k of the softmax with the gates renormalised, token groups
(``moe_groups``, when T divides and each group holds K tokens or more)
with per-group capacity, positions in k-major order so that the same
entries are dropped, and the expert-major slot layout with every dropped
entry in one dummy slot.  The expert products are batched matmuls in
the activation dtype (no TPU kernel computes them either).  The combine
sums each token's K contributions in the reference's dispatch order
(k = 0 first) by a fixed sequence of adds, not by atomics, so a bf16
output is the same on every run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical_constraint, reshape
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import ParamSpec


def moe_specs(cfg, stacked: int | None) -> dict:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out = {
        "router": ParamSpec(lead + (D, E), lx + ("embed", None), scale=0.1),
        "w_gate": ParamSpec(lead + (E, D, Fe),
                            lx + ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec(lead + (E, D, Fe),
                          lx + ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec(lead + (E, Fe, D),
                            lx + ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        out["shared"] = mlp_mod.mlp_specs("swiglu", D, fs, stacked)
    return out


def _capacity(n_tokens: int, cfg) -> int:
    cap = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.moe_top_k)


# calls of each dispatch through moe_apply (the dry run reports them)
dispatches = {"shard_map": 0, "scatter": 0}


def moe_apply(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> (out [B, S, D], metrics): the shard-map dispatch
    under active rules when the config names it, else the scatter one."""
    from repro_torch.distributed.sharding import active_rules

    if (getattr(cfg, "moe_dispatch", "scatter") == "shard_map"
            and active_rules() is not None):
        dispatches["shard_map"] += 1
        return moe_apply_shard_map(cfg, p, x)
    dispatches["scatter"] += 1
    return moe_apply_scatter(cfg, p, x)


def moe_apply_shard_map(cfg, p: dict, x: torch.Tensor
                        ) -> tuple[torch.Tensor, dict]:
    """The explicit-collective dispatch over the active rules' mesh
    (counterpart of the reference's ``moe_apply_shard_map``): x [B, S, D]
    -> (out [B, S, D], metrics), differentiable.

    Tokens split over the data axes ("pod", "data": G token groups),
    experts over "model".  Each slot runs the reference's per-slot body
    (:func:`_slot_bodies`): route its token group into its own (E, Cl, D)
    capacity slice, all-gather its experts' slices over the data axes,
    run those experts' FFNs, all-gather its token group's slice from
    every expert owner over "model", combine its tokens' K picks, and
    ``pmean`` the three metrics over every slot.

    Two callers:

    * plain tensors, whole on every rank (a single-process mesh or a
      process mesh): each slot takes its blocks through
      ``collectives.slot_inputs`` and the token groups' outputs are
      exchanged, so every rank returns the whole output, and backward
      gives the whole gradients on every rank, bit for bit those of the
      single-process mesh;
    * DTensors (a program under the rules on a process mesh with one
      slot a rank): a ``local_map`` region, x Shard over the data axes
      and the expert weights ``Shard(0)`` over "model", the reference's
      ``in_specs``; the gradients of inputs a rank holds replicated come
      back ``Partial`` (the transpose of the reference's unmapped axes),
      and the output's cotangent is divided over "model", on whose
      members the output is replicated, as ``shard_map``'s transpose
      divides it.

    Where ``T % G`` or ``E % |model|`` the reference runs its scatter
    dispatch, and so does this.
    """
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import active_rules, is_dtensor

    mesh = active_rules().mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    G = 1
    for a in dp_axes:
        G *= mesh.shape[a]
    n_model = mesh.shape.get("model", 1)
    if T % G or E % n_model:
        if is_dtensor(x):
            return _scatter_whole(cfg, p, x)
        return moe_apply_scatter(cfg, p, x)
    dims = _Dims(dp_axes, G, n_model, max(-(-_capacity(T, cfg) // G), K),
                 E // n_model, T // G)
    # token groups whole on each data shard: the reference's in_spec
    xt = reshape(logical_constraint(x, ("batch", None, None)), (T, D))
    if is_dtensor(x):
        out, st = _shard_map_dtensor(cfg, p, xt, mesh, dims)
    else:
        out, st = _shard_map_plain(cfg, p, xt, mesh, dims, col)
    if cfg.n_shared_experts:
        out = out + mlp_mod.mlp_apply("swiglu", p["shared"], xt)
    metrics = {"moe_lb_loss": st[0], "moe_z_loss": st[1],
               "moe_drop_frac": st[2]}
    return reshape(out, (B, S, D)), metrics


def _scatter_whole(cfg, p: dict, x):
    """The scatter dispatch on DTensors whose shapes do not tile the mesh:
    every input whole on each rank and the dispatch run there, its
    output replicated."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import region
    from repro_torch.models.qhead import tree_leaves

    keys = sorted(p)
    leaves = [tree_leaves(p[k]) for k in keys]
    rep = (Replicate(),) * x.device_mesh.ndim

    def whole(xl, *flat):
        it = iter(flat)
        local = {k: _rebuild(p[k], it) for k in keys}
        out, m = moe_apply_scatter(cfg, local, xl)
        return out, m["moe_lb_loss"], m["moe_z_loss"], m["moe_drop_frac"]

    args = [x, *(t for ls in leaves for t in ls)]
    out, lb, z, drop = region(whole, x.device_mesh, args, [rep] * len(args),
                              [rep] * 4)
    return out, {"moe_lb_loss": lb, "moe_z_loss": z, "moe_drop_frac": drop}


def _rebuild(node, it):
    """``node``'s nested dicts with the next leaves of ``it``, in
    ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    return next(it)


class _Dims(NamedTuple):
    dp_axes: tuple   # the token axes ("pod", "data") the mesh has
    G: int           # token groups
    n_model: int     # expert owners
    Cl: int          # capacity of one expert in one token group
    E_loc: int       # experts an owner holds
    Tl: int          # tokens a group holds


def _token_group(mesh, slot: int, dp_axes) -> int:
    c = mesh.coords(slot)
    g = 0
    for a in dp_axes:
        g = g * mesh.shape[a] + c[a]
    return g


def _slot_bodies(cfg, mesh, dims: _Dims, slots, xts, routers, wgs, wus,
                 wds):
    """The reference's per-slot body, for the slots this process holds
    (``slots``, with each one's token group ``xts`` [Tl, D], router and
    E_loc experts' weights): each slot's combined output [Tl, D] and
    metrics [3], before any reduction over slots."""
    from repro_torch.distributed import collectives as col

    E, K, D = cfg.n_experts, cfg.moe_top_k, xts[0].shape[-1]
    Cl, E_loc, Tl = dims.Cl, dims.E_loc, dims.Tl
    dt = xts[0].dtype
    routed, mine, stats = [], [], []
    for slot, xt, router in zip(slots, xts, routers):
        dev = xt.device
        me = mesh.coords(slot).get("model", 0)
        logits, probs, gate_vals, expert_ids = route(cfg, xt, router)
        flat_e = expert_ids.T.reshape(Tl * K)            # k-major
        eq = F.one_hot(flat_e, E)
        pos = torch.gather(torch.cumsum(eq, 0) - eq, 1, flat_e[:, None])[:, 0]
        keep = pos < Cl
        slot_of = torch.where(keep, flat_e * Cl + pos,
                              torch.full_like(pos, E * Cl))
        token_of = torch.arange(Tl, device=dev).repeat(K)
        buf = torch.zeros((E * Cl + 1, D), dtype=dt, device=dev).index_copy(
            0, slot_of, torch.where(keep[:, None], xt[token_of], 0))
        buf = buf[:-1].reshape(E, Cl, D)
        mine.append(buf[me * E_loc:(me + 1) * E_loc].contiguous())
        routed.append((keep, slot_of, gate_vals))
        ce = F.one_hot(expert_ids, E).sum(1).to(torch.float32).mean(0)
        stats.append(torch.stack([
            E * torch.sum(probs.mean(0) * ce) / K,
            torch.mean(torch.logsumexp(logits, -1) ** 2),
            1.0 - keep.to(torch.float32).mean()]))

    # my experts' slices from every token group: (E_loc, G * Cl, D)
    gathered = (col.all_gather_groups(mesh, mine, dims.dp_axes, dim=1)
                if dims.dp_axes else mine)
    sliced = []
    for slot, xin, wg, wu, wd in zip(slots, gathered, wgs, wus, wds):
        g = _token_group(mesh, slot, dims.dp_axes)
        h = torch.bmm(xin, wg.to(dt))
        u = torch.bmm(xin, wu.to(dt))
        eo = torch.bmm(F.silu(h) * u, wd.to(dt))
        sliced.append(eo.reshape(E_loc, dims.G, Cl, D)[:, g].contiguous())
    # my token group's slice from every expert owner: (E, Cl, D)
    every = (col.all_gather_groups(mesh, sliced, ("model",), dim=0)
             if "model" in mesh.axis_names else sliced)

    outs = []
    for (keep, slot_of, gate_vals), eo_all in zip(routed, every):
        picked = eo_all.reshape(E * Cl, D)[torch.clamp(slot_of,
                                                       max=E * Cl - 1)]
        contrib = torch.where(keep[:, None],
                              picked * gate_vals.T.reshape(-1)[:, None].to(dt),
                              0).reshape(K, Tl, D)
        out = contrib[0]
        for k in range(1, K):
            out = out + contrib[k]
        outs.append(out)
    return outs, stats


def _shard_map_plain(cfg, p, xt, mesh, dims: _Dims, col):
    """The dispatch on plain tensors whole on every rank: (out [T, D],
    metrics [3]), both whole on every rank."""
    E_loc, Tl = dims.E_loc, dims.Tl
    slots = list(mesh.local_slots)

    def tokens(s):
        return (0, _token_group(mesh, s, dims.dp_axes) * Tl, Tl)

    def experts(s):
        return (0, mesh.coords(s).get("model", 0) * E_loc, E_loc)

    ins = [col.slot_inputs(mesh, xt, tokens),
           col.slot_inputs(mesh, p["router"]),
           *(col.slot_inputs(mesh, p[w], experts)
             for w in ("w_gate", "w_up", "w_down"))]
    ins = [[t.to(mesh.devices.flat[s]) for s, t in zip(slots, ts)]
           for ts in ins]
    outs, stats = _slot_bodies(cfg, mesh, dims, slots, *ins)
    # each token group's output from its model-0 slot (its twins over
    # "model" hold the same)
    out = col.gather_shards(mesh, outs, dims.dp_axes)
    st = col.pmean(mesh, stats, mesh.axis_names, (3,), torch.float32)
    return out, st


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; backward multiplies the gradient by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _shard_map_dtensor(cfg, p, xt, mesh, dims: _Dims):
    """The dispatch as a ``local_map`` region over the rules' DeviceMesh
    (one slot a rank): (out [T, D] Shard over the data axes, metrics [3]
    replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = mesh.device_mesh()
    names = mesh.axis_names
    tok = tuple(Shard(0) if a in dims.dp_axes else Replicate()
                for a in names)
    tok_grad = tuple(Shard(0) if a in dims.dp_axes else Partial()
                     for a in names)
    rep = (Replicate(),) * len(names)
    part = (Partial(),) * len(names)
    expert = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    expert_grad = tuple(Shard(0) if a == "model" else Partial()
                        for a in names)
    slot = mesh.local_slots[0]

    def body(xl, router, wg, wu, wd):
        from repro_torch.distributed import collectives as col

        outs, stats = _slot_bodies(cfg, mesh, dims, [slot], [xl], [router],
                                   [wg], [wu], [wd])
        out = outs[0]
        if dims.n_model > 1 and out.requires_grad:
            out = _ScaleGrad.apply(out, 1.0 / dims.n_model)
        return out, col.pmean(mesh, stats, names, (3,), torch.float32)

    return local_map(body, out_placements=(tok, rep),
                     in_placements=(tok, rep, expert, expert, expert),
                     in_grad_placements=(tok_grad, part, expert_grad,
                                         expert_grad, expert_grad),
                     device_mesh=dmesh, redistribute_inputs=True)(
        xt, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def route(cfg, xt: torch.Tensor, router: torch.Tensor):
    """The router over tokens xt [T, D]: float32 logits [T, E], their
    softmax, and the top-K experts' renormalised gates and ids [T, K]."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return logits, probs, gate_vals, expert_ids


def dispatch(cfg, expert_ids: torch.Tensor):
    """Capacity-limited slots of the T x K dispatch entries, in the
    reference's (group, k, token) order: ``(slot, keep, token_of, G, Cg)``
    with ``slot`` E * G * Cg (the dummy) where an entry is dropped."""
    T, K = expert_ids.shape
    E = cfg.n_experts
    C = _capacity(T, cfg)
    G = cfg.moe_groups if (cfg.moe_groups and T % cfg.moe_groups == 0
                           and T >= cfg.moe_groups * K) else 1
    Tg = T // G
    Cg = max(-(-C // G), K)
    dev = expert_ids.device
    flat_e = expert_ids.reshape(G, Tg, K).transpose(1, 2).reshape(G, K * Tg)
    eq = logical_constraint(F.one_hot(flat_e, E),
                            ("tokens", None, None))          # (G, KTg, E)
    pos_in_e = torch.cumsum(eq, dim=1) - eq                  # local prefix
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = pos < Cg
    g_idx = torch.arange(G, device=dev)[:, None]
    slot = torch.where(keep, flat_e * (G * Cg) + g_idx * Cg + pos,
                       torch.full_like(pos, E * G * Cg))
    token_of = (g_idx * Tg + torch.arange(Tg, device=dev).repeat(K)[None])
    return slot.reshape(-1), keep.reshape(-1), token_of.reshape(-1), G, Cg


def moe_apply_scatter(cfg, p: dict, x: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> (out [B, S, D], metrics ``moe_lb_loss``,
    ``moe_z_loss``, ``moe_drop_frac``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    dt = x.dtype
    xt = logical_constraint(x.reshape(T, D), ("tokens", None))
    logits, probs, gate_vals, expert_ids = route(cfg, xt, p["router"])
    slot, keep, token_of, G, Cg = dispatch(cfg, expert_ids)
    n_slots = E * G * Cg

    # each kept entry has a slot of its own; the dropped ones (zeros) share
    # the dummy slot, cut off after
    gathered = logical_constraint(torch.where(keep[:, None], xt[token_of], 0),
                                  ("tokens", None))
    xin = torch.zeros((n_slots + 1, D), dtype=dt, device=x.device)
    xin = xin.index_copy(0, slot, gathered)
    expert_in = logical_constraint(xin[:-1].reshape(E, G * Cg, D),
                                   ("experts", None, None))

    h = torch.bmm(expert_in, p["w_gate"].to(dt))
    u = torch.bmm(expert_in, p["w_up"].to(dt))
    eo = logical_constraint(torch.bmm(F.silu(h) * u, p["w_down"].to(dt)),
                            ("experts", None, None))

    flat_gate = gate_vals.reshape(G, T // G, K).transpose(1, 2).reshape(-1)
    picked = eo.reshape(n_slots, D)[torch.clamp(slot, max=n_slots - 1)]
    contrib = logical_constraint(
        torch.where(keep[:, None], picked * flat_gate[:, None].to(dt), 0),
        ("tokens", None)).reshape(G, K, T // G, D)
    # the reference's scatter-add from zeros, in its order: k = 0 first
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    out = out.reshape(T, D)

    if cfg.n_shared_experts:
        out = out + mlp_mod.mlp_apply("swiglu", p["shared"], xt)

    me = probs.mean(dim=0)                                    # router mass
    ce = F.one_hot(expert_ids, E).sum(1).to(torch.float32).mean(0)  # picks
    metrics = {
        "moe_lb_loss": E * torch.sum(me * ce) / K,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_drop_frac": 1.0 - keep.to(torch.float32).mean()}
    return out.reshape(B, S, D), metrics
