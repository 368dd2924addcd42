"""What each rank of ``tests/test_torch_process_mesh.py`` runs.

The ranks are spawned processes (``repro_torch.launch.mesh.run_ranks``):
this module imports only torch, numpy and the port, so a rank never
loads jax or the reference.  ``all_checks`` runs every check of one
spawn on a process mesh over the ranks and returns their results as
numpy trees; the test holds them against the reference and the
single-process mesh in the pytest process.
"""
import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.core.amper import AmperConfig
from repro_torch.core.sharded import ShardedAmperSampler
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import moe as tmoe
from repro_torch.rl import dqn as td

N, BATCH, SHARDS = 2048, 64, 4
CFG = dict(capacity=N, m=20, lam_fr=2.0, v_max=8.0, csp_capacity=600)
FR_MODES = ("broadcast", "kernel", "fused", "interval", "window")
DRAW_KEYS, EMPTY_KEYS, MEMBER_KEYS = (4, 5), (6,), (4, 5)
RING, RING_ADD, RING_STEPS, RING_BATCH = 512, 48, 12, 32
DQN_KW = dict(env="cartpole", sampler="amper-fr-sharded", agent="dqn",
              n_step=1, num_envs=4, replay_size=256, batch=16, hidden=32,
              learn_start=8, target_sync=10)
DQN_STEPS = 30


def tensors(tree):
    """numpy leaves -> tensors, through dicts, lists and named tuples."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tensors(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors(v) for v in tree)
    return tree


def draw_checks(mesh, pq, valid, prios, idx, upd):
    """The sharded AMPER-fr draw in every mode (and on an empty table),
    its membership, the sharded PER draw, ``update`` and the traffic of
    one draw, on ``mesh`` with the dense inputs given."""
    out = {}
    pq, valid = torch.from_numpy(np.array(pq)), torch.from_numpy(
        np.array(valid))
    for mode in FR_MODES:
        ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode=mode), mesh,
                                 axis_names=("data",))
        st = ts.from_dense(pq, valid)
        empty = ts.from_dense(pq, torch.zeros_like(valid))
        mesh.traffic = {"all_gather": 0, "psum": 0}
        draws = [ts.sample(st, prng.key(k), BATCH) for k in DRAW_KEYS]
        traffic = dict(mesh.traffic)
        draws += [ts.sample(empty, prng.key(k), BATCH) for k in EMPTY_KEYS]
        out[mode] = {"draws": draws, "traffic": traffic,
                     "held": [t.shape[0] for t in st.pq],
                     "membership": [ts.membership(st, prng.key(k))
                                    for k in MEMBER_KEYS]}
    ts = ShardedAmperSampler(AmperConfig(**CFG), mesh, axis_names=("data",))
    st = ts.update(ts.init(), torch.from_numpy(idx), torch.from_numpy(upd))
    dense = ts.to_dense(st)
    out["update"] = {"pq": dense.pq, "valid": dense.valid,
                     "priorities": ts.priorities(st), "total": ts.total(st)}
    per = tsamplers.make_sampler("per-sharded", N, mesh=mesh, device="cpu",
                                 axis_names=("data",))
    pst = per.from_dense(torch.from_numpy(prios))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    out["per"] = {"draws": [per.sample(pst, prng.key(k), 128)
                            for k in (0, 1, 2)],
                  "traffic": dict(mesh.traffic)}
    return out


def sparse_draws(mesh, pq, valid):
    """The fused draw over the "data" shards of a 2 x 2 ("data", "model")
    ``mesh``: on 4 ranks, ranks 1 and 3 hold no shard and still join
    every collective."""
    ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode="fused"), mesh,
                             axis_names=("data",))
    st = ts.from_dense(torch.from_numpy(np.array(pq)),
                       torch.from_numpy(np.array(valid)))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    return {"draws": [ts.sample(st, prng.key(k), BATCH) for k in DRAW_KEYS],
            "held": len(st.pq), "dense": ts.to_dense(st).pq,
            "traffic": dict(mesh.traffic)}


def ring_buffer(mesh, device="cpu"):
    kw = dict(m=20, lam_fr=2.0, v_max=4.0, min_csp=16, axis_names=("data",))
    ts = tsamplers.make_sampler("amper-fr-sharded", RING, mesh=mesh,
                                fr_mode="fused", device=device, **kw)
    return trb.ReplayBuffer(RING, ts, alpha=1.0)


def storage_checks(mesh, rows, tds):
    """The ring of ``RING`` rows over ``mesh``: ``RING_STEPS`` writes of
    ``RING_ADD`` rows (past a wrap), each followed by a draw of
    ``RING_BATCH`` and a priority update; each step's sample, and the
    rows this process holds, its dense view and the sampler table."""
    tb = ring_buffer(mesh)
    ex = {"obs": torch.zeros(3), "reward": torch.tensor(0.0)}
    st = tb.init(ex)
    samples = []
    for step in range(RING_STEPS):
        st = tb.add_batch(st, tensors(rows[step]))
        idx, batch, w = tb.sample(st, prng.key(step), RING_BATCH)
        samples.append({"idx": idx, "batch": batch, "w": w})
        st = tb.update_priorities(st, idx, torch.from_numpy(tds[step]))
    dense = tb.dense(st)
    return {"samples": samples, "held": st.storage,
            "rows": (tb.row_lo, tb.row_hi), "dense": dense.storage,
            "pq": tb.sampler.to_dense(st.sampler_state).pq,
            "max_priority": st.max_priority}


def dqn_steps(mesh, init_state):
    """``DQN_STEPS`` agent steps from ``init_state`` (a port state with
    numpy leaves, its sampler state dense), on the process mesh."""
    cfg = td.DQNConfig(**DQN_KW, amper_fr_mode="fused")
    dq = td.make_dqn(cfg, device="cpu", mesh=mesh)
    st = tensors(init_state)
    rb = dq.replay
    buf = rb.partition(st.buffer)
    buf = buf._replace(sampler_state=rb.sampler.from_dense(
        *(torch.cat(f) for f in buf.sampler_state)))
    st = st._replace(buffer=buf)
    keys = prng.split(prng.fold_in(prng.key(3), 1), DQN_STEPS)
    idx, tds, loss = [], [], []
    for i in range(DQN_STEPS):
        st, m = dq.agent_step(st, keys[i])
        idx.append(m["idx"])
        tds.append(m["td"])
        loss.append(m["loss"])
    refused = None
    try:
        dq.runner(st, prng.key(0), 4, capture=True)
    except ValueError as e:
        refused = str(e)
    dense = rb.dense(st.buffer)
    return {"idx": idx, "td": tds, "loss": loss, "params": st.params,
            "opt_m": st.opt_m, "storage": dense.storage,
            "held_rows": st.buffer.storage["obs"].shape[0],
            "pq": rb.sampler.to_dense(st.buffer.sampler_state).pq,
            "returns": st.last_returns, "capture_refused": refused}


CKPT_KW = dict(DQN_KW, replay_size=128, learn_start=4)
CKPT_STEPS, CKPT_EVERY = 24, 8


def dqn_ckpt(mesh, directory):
    """``train_ckpt`` of ``CKPT_STEPS`` steps on ``mesh`` saving every
    ``CKPT_EVERY`` into ``directory`` (rank 0 writes), then ``load_ckpt``
    of the last save: the final params and dense ring, and the restored
    state's."""
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = td.DQNConfig(**CKPT_KW, amper_fr_mode="fused")
    dq = td.make_dqn(cfg, device="cpu", mesh=mesh)
    mgr = CheckpointManager(directory, save_interval=CKPT_EVERY)
    st, _, done = dq.train_ckpt(prng.key(5), CKPT_STEPS, mgr)
    back = dq.load_ckpt(directory, CKPT_STEPS)
    rb = dq.replay
    return {"done": done, "params": st.params,
            "storage": rb.dense(st.buffer).storage,
            "pq": rb.sampler.to_dense(st.buffer.sampler_state).pq,
            "restored_params": back.params,
            "restored_storage": rb.dense(back.buffer).storage,
            "restored_pq": rb.sampler.to_dense(back.buffer.sampler_state).pq}


def pod_checks(mesh, grads):
    """``psum_int8_mean`` and ``grad_fn_with_pod_sync`` (both
    ``compress``) over the ("pod",) ``mesh``: ``grads`` holds one tree a
    pod; each pod's gradient is its slice of the batch."""
    mine = [grads[p] for p in mesh.local_shards(("pod",))]
    direct = col.psum_int8_mean([tensors(g) for g in mine], mesh, "pod")
    batch = {k: torch.from_numpy(np.stack([g[k] for g in grads]))
             for k in grads[0]}

    def grad_fn(params, b):
        return {k: v[0] for k, v in b.items()}

    out = {"direct": direct}
    for compress in (True, False):
        fn = col.grad_fn_with_pod_sync(grad_fn, mesh, compress=compress)
        out[f"compress={compress}"] = fn(None, batch)
    return out


def moe_checks(mesh, cfg, params, xs):
    """``moe_apply`` under rules over the 2 x 2 ``mesh`` on each input."""
    p = tensors(params)
    with shd.use_rules(shd.ShardingRules(mesh, shd.TRAIN_RULES)):
        return [tmoe.moe_apply(cfg, p, torch.from_numpy(x)) for x in xs]


def all_checks(rank, world, device, inputs):
    """Every check of one spawn of ``world`` ranks (see the module
    docstring); ``inputs`` holds the dense inputs, made from seeds in the
    pytest process."""
    out = {"rank": rank}
    replay = make_process_mesh((SHARDS,), ("data",), backend="gloo",
                               device=device)
    out["draws"] = draw_checks(replay, *inputs["table"])
    out["storage"] = storage_checks(replay, *inputs["ring"])
    if world == 2:
        two = make_process_mesh((2,), ("data",), backend="gloo",
                                device=device)
        out["dqn"] = dqn_steps(two, inputs["dqn_state"])
        out["ckpt"] = dqn_ckpt(two, inputs["ckpt_dir"])
    pods = make_process_mesh((world,), ("pod",), backend="gloo",
                             device=device)
    out["pod"] = pod_checks(pods, inputs["grads"])
    moe = make_process_mesh((2, 2), ("data", "model"), backend="gloo",
                            device=device)
    out["moe"] = {name: moe_checks(moe, cfg, inputs["moe_params"], xs)
                  for name, (cfg, xs) in inputs["moe"].items()}
    out["sparse"] = sparse_draws(moe, *inputs["table"][:2])
    return out


def raises_on_one_rank(rank, world, device):
    """Rank 1 raises while the others wait in a collective."""
    mesh = make_process_mesh((world,), ("data",), backend="gloo",
                             device=device)
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    col.psum(mesh, [torch.ones(3)], ("data",), (3,), torch.float32)
    return rank
