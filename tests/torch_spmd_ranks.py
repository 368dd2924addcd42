"""What each rank of ``tests/test_torch_auto_spmd.py`` runs.

The ranks are spawned processes (``repro_torch.launch.mesh.run_ranks``):
this module imports only torch, numpy and the port, so a rank never
loads jax or the reference.  ``spmd_checks`` runs every check of one
spawn on a ("data", "model") process mesh over the ranks (1 x 2 on two
ranks, 2 x 2 on four) and returns numpy trees; the test holds them
against the reference and the single-process mesh in the pytest process.
"""
import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamW

ARCH = "stablelm-1.6b"
DENSE_KW = dict(dtype="float32")
LR = 1e-3


def tensors(tree, grad=False):
    if isinstance(tree, dict):
        return {k: tensors(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _placements(tree):
    return [tuple(t.placements) for t in tree_leaves(tree) if t is not None]


def dense_checks(mesh, inputs):
    """The reduced dense model under each preset's rules on ``mesh``: one
    sharded train step (loss, grad norm, the updated params and first
    moments, whole, and whether every leaf kept its placements), then a
    prefill and ``len(steps)`` decode steps (each step's logits,
    whole)."""
    cfg = get_reduced_config(ARCH, **DENSE_KW)
    model = Model.from_config(cfg)
    out = {}
    for preset in ("tp", "serve"):
        rules = shd.ShardingRules(mesh, shd.RULE_PRESETS[preset])
        opt = AdamW(LR)
        params = tensors(inputs["params"])
        state = tts.TrainState(step=torch.zeros((), dtype=torch.int32),
                               params=params, opt_state=opt.init(params))
        placed = tts.shard_train_state(state, model, opt, rules)
        before = _placements(placed)
        step = tts.make_sharded_train_step(model, opt, rules)
        new, met = step(placed, tts.shard_batch(tensors(inputs["batch"]),
                                                rules))
        res = {"loss": met["loss"].full_tensor(),
               "grad_norm": met["grad_norm"].full_tensor(),
               "params": shd.full_tree(new.params),
               "m": shd.full_tree(new.opt_state.m),
               "kept_placements": _placements(new) == before}
        with shd.use_rules(rules), implicit_replication():
            p = shd.distribute_tree(tensors(inputs["params"]),
                                    model.param_axes())
            toks = shd.distribute(torch.from_numpy(inputs["prompt"]),
                                  ("batch", None))
            logits, cache = model.prefill(p, {"tokens": toks},
                                          inputs["max_len"])
            seen = [logits.full_tensor()]
            for t in inputs["steps"]:
                tok = shd.distribute(torch.from_numpy(t), ("batch", None))
                logits, cache = model.decode_step(p, tok, cache)
                seen.append(logits.full_tensor())
        res["logits"] = seen
        out[preset] = res
    return out


def moe_grads(mesh, cfg, params, x, weight):
    """``moe_apply`` under rules over ``mesh`` (plain tensors whole on
    every rank: the shard-map dispatch), and the gradients of ``sum(out
    * weight) + 0.01 lb + 1e-3 z`` with respect to x and every param, in
    ``tree_leaves`` order."""
    p = tensors(params, grad=True)
    xt = tensors(x, grad=True)
    with shd.use_rules(shd.ShardingRules(mesh, shd.TRAIN_RULES)):
        out, m = tmoe.moe_apply(cfg, p, xt)
        loss = ((out * torch.from_numpy(weight)).sum()
                + 0.01 * m["moe_lb_loss"] + 1e-3 * m["moe_z_loss"])
        grads = torch.autograd.grad(loss, [xt] + tree_leaves(p))
    return {"out": out.detach(), "metrics": {k: v.detach()
                                             for k, v in m.items()},
            "grads": [g.detach() for g in grads]}


def spmd_checks(rank, world, device, inputs):
    """Every check of one spawn of ``world`` ranks (the module
    docstring)."""
    shape = (world // 2, 2)
    mesh = make_process_mesh(shape, ("data", "model"), backend="gloo",
                             device=device)
    out = {"dense": dense_checks(mesh, inputs["dense"])}
    if world == 4:
        out["moe"] = moe_grads(mesh, *inputs["moe"])
    return out
