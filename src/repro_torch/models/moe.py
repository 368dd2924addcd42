"""Fine-grained Mixture-of-Experts (DeepSeekMoE style).

Counterpart of ``repro/models/moe.py``: n shared experts always active
plus E routed experts with top-k softmax gating, a capacity-limited
scatter / gather dispatch with Mesh-TF positions from a cumsum (no
(T, E, C) one-hot), and the load-balance and router-z aux losses as
metrics.  The reference takes its ``shard_map`` dispatch only under an
active mesh, which one card has not, so ``moe_apply`` always takes the
scatter dispatch here, as the reference does without a mesh; the
explicit-collective dispatch waits for the mesh (ROADMAP A14).

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

import torch
import torch.nn.functional as F

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


def moe_apply(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> (out [B, S, D], metrics): the scatter dispatch (see
    the module docstring for the reference's mesh-only route)."""
    return moe_apply_scatter(cfg, p, x)


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
    eq = F.one_hot(flat_e, E)                                # (G, KTg, E)
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
    xt = x.reshape(T, D)
    logits, probs, gate_vals, expert_ids = route(cfg, xt, p["router"])
    slot, keep, token_of, G, Cg = dispatch(cfg, expert_ids)
    n_slots = E * G * Cg

    # each kept entry has a slot of its own; the dropped ones (zeros) share
    # the dummy slot, cut off after
    gathered = torch.where(keep[:, None], xt[token_of], 0)
    xin = torch.zeros((n_slots + 1, D), dtype=dt, device=x.device)
    xin = xin.index_copy(0, slot, gathered)
    expert_in = xin[:-1].reshape(E, G * Cg, D)

    h = torch.bmm(expert_in, p["w_gate"].to(dt))
    u = torch.bmm(expert_in, p["w_up"].to(dt))
    eo = torch.bmm(F.silu(h) * u, p["w_down"].to(dt))

    flat_gate = gate_vals.reshape(G, T // G, K).transpose(1, 2).reshape(-1)
    picked = eo.reshape(n_slots, D)[torch.clamp(slot, max=n_slots - 1)]
    contrib = torch.where(keep[:, None], picked * flat_gate[:, None].to(dt),
                          0).reshape(G, K, T // G, D)
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
