"""The fine-grained MoE (deepseek-moe-16b, reduced) against the JAX
reference, and the in-place parameter init.

``moe_apply_scatter`` alone on numpy-seeded inputs and params: one token
group (G = 1), several (G > 1: T divisible by ``moe_groups`` and T >= G
K), dropped entries (``moe_drop_frac`` > 0), the decode size, and bf16;
then the reduced arch as a whole (``test_torch_lm_window.py``'s checks:
forward, prefill and 4 decode steps against the reference's
``decode_step``, the loss with its aux terms, one train step).  The
reference runs jitted, without a mesh, so it takes its scatter dispatch
as the port does.

Routing is discrete: a last-place difference in a router logit could
flip a top-k pick or a capacity drop and move a token's output by O(1).
So the float32 tests first hold the expert ids and the keep mask equal
to the reference's, exactly (the seeded probabilities have no ties),
then the values: outputs within 2e-5 (atol and rtol; the packages sum
the expert products in other orders), the aux metrics within rtol 1e-5
/ atol 1e-6 (XLA's mean of the keep mask reads -3e-8 where no entry is
dropped), gradients rtol 1e-4 / atol 1e-6 of each leaf's largest
|grad|.  bf16:
the ids and keep mask exact (the router is float32 in both, on the same
bf16 activations), the output within 2% of its largest |value| (bf16
rounding at other places, as ``tests/test_torch_lm.py``).

Init: the in-place scaling gives the old expression's params bit for
bit, every leaf of each reduced arch, float32 and bf16 params.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced_config
from repro_torch.models import common
from repro_torch.models import moe as tmoe
from repro_torch.models.model_api import Model
from repro_torch.models.qhead import tree_leaves
from test_torch_lm_window import (check_forward, check_loss_and_train_step,
                                  check_param_tree, check_prefill_decode,
                                  close)

ARCH = "deepseek-moe-16b"
TOL = 2e-5
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-6

# name -> (B, S, config overrides, expected G, drops expected)
MOE_CASES = {
    "one-group": (2, 5, {}, 1, None),
    "32-groups": (2, 64, {}, 32, None),
    "4-groups": (2, 12, {"moe_groups": 4}, 4, None),
    "drops": (2, 24, {"capacity_factor": 0.5, "moe_groups": 4}, 4, True),
    "decode-size": (3, 1, {}, 1, False),
    "no-shared": (2, 16, {"n_shared_experts": 0}, 1, None),
}


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs(dtype="float32", **over):
    return (jreduced(ARCH, dtype=dtype, **over),
            get_reduced_config(ARCH, dtype=dtype, **over))


def _moe_params(jcfg, seed):
    """The MoE's leaves from a numpy seed: fan-in-scaled normals (the
    router's times its 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(sp):
        return (rng.standard_normal(sp.shape) * sp.scale
                / math.sqrt(sp.shape[-2])).astype(np.float32)

    specs = jmoe.moe_specs(jcfg, None)
    return {n: ({m: leaf(s) for m, s in sp.items()} if isinstance(sp, dict)
                else leaf(sp)) for n, sp in specs.items()}


def _torch(p):
    return {n: (_torch(w) if isinstance(w, dict)
                else torch.from_numpy(w.copy())) for n, w in p.items()}


def _jax_dispatch(jcfg, xt, router):
    """The reference's routing and capacity positions, its own jnp lines
    (``moe_apply_scatter``), for the ids and the keep mask it keeps
    internal."""
    T = xt.shape[0]
    E, K = jcfg.n_experts, jcfg.moe_top_k
    C = jmoe._capacity(T, jcfg)
    G = jcfg.moe_groups if (jcfg.moe_groups and T % jcfg.moe_groups == 0
                            and T >= jcfg.moe_groups * K) else 1
    Tg, Cg = T // G, max(-(-C // G), K)
    probs = jax.nn.softmax(xt.astype(jnp.float32)
                           @ router.astype(jnp.float32), axis=-1)
    _, expert_ids = jax.lax.top_k(probs, K)
    flat_e = expert_ids.reshape(G, Tg, K).transpose(0, 2, 1).reshape(
        G, K * Tg)
    eq = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(eq, axis=1) - eq,
                              flat_e[..., None], axis=2)[..., 0]
    return expert_ids, (pos < Cg).reshape(-1), G


def _run_case(case, dtype="float32", seed=0):
    b, s, over, g_want, drops = MOE_CASES[case]
    jcfg, tcfg = _cfgs(dtype, **over)
    p = _moe_params(jcfg, seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "float32"
                                else torch.bfloat16)
    want, jmet = jax.jit(lambda p, x: jmoe.moe_apply_scatter(jcfg, p, x))(
        p, jx)
    tp = _torch(p)
    got, met = tmoe.moe_apply_scatter(tcfg, tp, tx)

    jids, jkeep, G = _jax_dispatch(jcfg, jx.reshape(b * s, -1), p["router"])
    _, _, _, ids = tmoe.route(tcfg, tx.reshape(b * s, -1), tp["router"])
    _, keep, _, tG, _ = tmoe.dispatch(tcfg, ids)
    assert G == tG == g_want
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if drops is not None:
        assert (float(met["moe_drop_frac"]) > 0) == drops
    return got, want, met, jmet


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_scatter_matches_reference(case):
    got, want, met, jmet = _run_case(case)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got, want, TOL, TOL)
    assert set(met) == set(jmet) == {"moe_lb_loss", "moe_z_loss",
                                     "moe_drop_frac"}
    for k in jmet:
        close(met[k], jmet[k], METRIC_ATOL, METRIC_RTOL, msg=k)


@pytest.mark.parametrize("case", ["one-group", "drops"])
def test_moe_scatter_in_bfloat16_matches_reference(case):
    got, want, met, jmet = _run_case(case, "bfloat16", seed=4)
    assert got.dtype == torch.bfloat16
    close(got, want, 0.02 * float(np.abs(np.asarray(want, np.float32)).max()))
    close(met["moe_drop_frac"], jmet["moe_drop_frac"], METRIC_ATOL,
          METRIC_RTOL)


def test_moe_gradients_match_reference():
    """Through the gates, the expert weights, the shared expert and the
    router's aux losses: out . w + 0.01 lb + 1e-3 z, as lm_loss adds
    them."""
    b, s, over = 2, 24, {"capacity_factor": 0.5, "moe_groups": 4}
    jcfg, tcfg = _cfgs(**over)
    p = _moe_params(jcfg, 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, m = jmoe.moe_apply_scatter(jcfg, p, x)
        return (jnp.sum(out * w) + 0.01 * m["moe_lb_loss"]
                + 1e-3 * m["moe_z_loss"])

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(p, x)
    tp = _torch(p)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, m = tmoe.moe_apply_scatter(tcfg, tp, tx)
    loss = ((out * torch.from_numpy(w)).sum() + 0.01 * m["moe_lb_loss"]
            + 1e-3 * m["moe_z_loss"])
    close(loss, jl, 0.0, 1e-5)
    grads = torch.autograd.grad(loss, leaves + [tx])
    for g, want in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        want = np.asarray(want)
        close(g, want, GRAD_ATOL_OF_MAX * float(np.abs(want).max()),
              GRAD_RTOL)


def test_moe_combine_is_deterministic_in_dispatch_order():
    """The K contributions of a token are summed k = 0 first by plain
    adds: the same bits on every call, and the order the reference's
    scatter-add from zeros takes."""
    jcfg, tcfg = _cfgs("bfloat16")
    tp = _torch(_moe_params(jcfg, 8))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    a, _ = tmoe.moe_apply_scatter(tcfg, tp, x)
    b, _ = tmoe.moe_apply_scatter(tcfg, tp, x)
    assert torch.equal(a, b)


def test_moe_apply_takes_the_scatter_dispatch():
    """The configs name the reference's shard_map dispatch, which needs a
    mesh; one card has none, and ``moe_apply`` is the scatter."""
    jcfg, tcfg = _cfgs()
    assert tcfg.moe_dispatch == "shard_map"
    tp = _torch(_moe_params(jcfg, 10))
    x = torch.randn(2, 8, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    a, ma = tmoe.moe_apply(tcfg, tp, x)
    b, mb = tmoe.moe_apply_scatter(tcfg, tp, x)
    assert torch.equal(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma)


def test_moe_param_tree_equals_reference():
    check_param_tree(ARCH)


def test_moe_forward_matches_reference():
    check_forward(ARCH)


def test_moe_prefill_and_decode_match_reference():
    check_prefill_decode(ARCH)


def test_moe_loss_and_train_step_match_reference():
    check_loss_and_train_step(ARCH)


def test_moe_per_sequence_loss_matches_reference():
    """The LM replay's priorities (``launch.train.per_sequence_loss``)
    for an MoE, against the reference's."""
    from repro.launch import train as jlaunch
    from repro.models.model_api import Model as JModel
    from repro_torch import interop
    from repro_torch.launch import train as tlaunch
    jcfg, tcfg = _cfgs()
    jm, tm = JModel.from_config(jcfg), Model.from_config(tcfg)
    jp = jm.init_params(jax.random.key(2))
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (3, 17)).astype(np.int32)
    mask = np.ones((3, 16), np.float32)
    mask[1, -5:] = 0.0
    jb = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jb.items()}
    want = jax.jit(lambda p, b: jlaunch.per_sequence_loss(jm, p, b))(jp, jb)
    close(tlaunch.per_sequence_loss(tm, tparams, tb), want, 1e-5, 1e-5)


def _old_init_leaf(gen, spec, device):
    """``common._init_leaf`` before the repair: the draw, then ``(x *
    std).to(dtype)``, which held every leaf twice."""
    if spec.init in ("zeros", "ones"):
        return common._init_leaf(gen, spec, device)
    std = (spec.scale if spec.init == "embed" else spec.scale / math.sqrt(
        max(spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1], 1)))
    x = torch.randn(spec.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (x * std).to(spec.dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", ARCH,
                                  "deepseek-v2-lite-16b", "stablelm-1.6b"])
def test_init_in_place_equals_the_old_expression(arch, param_dtype):
    model = Model.from_config(get_reduced_config(arch,
                                                 param_dtype=param_dtype))
    new = model.init_params(torch.Generator().manual_seed(5), device="cpu")
    gen = torch.Generator().manual_seed(5)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return _old_init_leaf(gen, node, torch.device("cpu"))

    old = build(model.param_specs())
    a, b = tree_leaves(new), tree_leaves(old)
    assert len(a) == len(b) and len(a) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
