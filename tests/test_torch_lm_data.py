"""The LM replay data pipeline (``train/data.py``) against the reference.

Both packages get the same corpus and the same per-sequence losses (from
a numpy seed, each sequence's loss a function of the sequence, so that a
sequence drawn twice in one batch carries one loss, as it does in
training).  The draws take the same keys (``fold_in(key(0), step)``).
Everything is compared bit for bit: the draws, the batches, the loss
EMA, the ``seen`` counts and the sampler's table, for all four samplers.
The priority ``clip(ema, 0, v_max) ** alpha`` is glibc's ``powf`` as XLA
calls it (``xla_float.powf``).  AMPER-k's jitted draw can disagree with
the reference's own functions (ROADMAP C9: XLA recomputes the group
representatives per fusion and rounds them differently); where it does,
the port is held to those functions composed with each representative
computed once (``test_torch_dqn._amper_k_draw_one_rep``), and both
packages go on from the port's draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models.model_api import Model as JModel
from repro.train import data as jdata
from repro_torch import interop, prng
from repro_torch.configs import get_reduced_config
from repro_torch.launch.train import per_sequence_loss
from repro_torch.models.model_api import Model
from repro_torch.train import data as tdata
from repro_torch.xla_float import powf
from test_torch_dqn import _amper_k_draw_one_rep

N_SEQS, SEQ, VOCAB, BATCH, STEPS = 64, 9, 50, 24, 8
SAMPLERS = ["uniform", "per", "amper-fr", "amper-k"]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _bits(x) -> np.ndarray:
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_state(t: tdata.ReplayDataState, j: jdata.ReplayDataState):
    got = interop.lm_train_state_to_numpy(t)
    want = jax.tree.map(np.asarray, j)
    assert type(got.sampler_state).__name__ == type(
        want.sampler_state).__name__
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_corpus_equals_reference():
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tdata.corpus_tokens(N_SEQS, SEQ, VOCAB, seed),
            jdata.corpus_tokens(N_SEQS, SEQ, VOCAB, seed))


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sample_and_update_bit_exact(sampler):
    tokens = jdata.corpus_tokens(N_SEQS, SEQ, VOCAB, seed=1)
    jd = jdata.PrioritizedSeqData(tokens, BATCH, sampler=sampler)
    td = tdata.PrioritizedSeqData(tokens, BATCH, sampler=sampler,
                                  device="cpu")
    jst, tst = jd.init(), td.init()
    _same_state(tst, jst)
    rng = np.random.default_rng(5)
    repeats = 0
    for step in range(STEPS):
        jkey = jax.random.fold_in(jax.random.key(0), step)
        jidx, jb = jd.sample(jst, jkey)
        tidx, tb = td.sample(tst, prng.fold_in(prng.key(0), step))
        assert tidx.dtype == torch.int32
        if sampler == "amper-k" and not np.array_equal(tidx.numpy(), jidx):
            want = _amper_k_draw_one_rep(jd.sampler.cfg, jst.sampler_state,
                                         jkey, BATCH)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(want))
            jidx = jnp.asarray(tidx.numpy())
            seq = tokens[np.asarray(jidx)]
            jb = dict(jb, tokens=seq[:, :-1], targets=seq[:, 1:])
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for k in jb:
            np.testing.assert_array_equal(_bits(tb[k]), _bits(jb[k]))
        # one loss a sequence: below, at and above v_max (12), some tiny
        per_seq = rng.choice([rng.uniform(0, 3), rng.uniform(3, 15), 12.0,
                              1e-3], N_SEQS).astype(np.float32)
        loss = per_seq[np.asarray(jidx)]
        repeats += BATCH - len(np.unique(np.asarray(jidx)))
        jst = jd.update(jst, jidx, jnp.asarray(loss))
        tst = td.update(tst, tidx, torch.from_numpy(loss))
        _same_state(tst, jst)
    assert repeats > 0  # the draws repeated rows, and seen counted each
    assert int(tst.seen.sum()) == BATCH * STEPS


def test_update_counts_every_repeat():
    tokens = jdata.corpus_tokens(N_SEQS, SEQ, VOCAB, seed=2)
    jd = jdata.PrioritizedSeqData(tokens, 6, sampler="amper-fr")
    td = tdata.PrioritizedSeqData(tokens, 6, sampler="amper-fr",
                                  device="cpu")
    jst, tst = jd.init(), td.init()
    idx = np.int32([3, 7, 3, 3, 60, 7])
    for loss in ([2.0, 5.0, 2.0, 2.0, 0.5, 5.0], [1.0, 20.0, 1.0, 1.0,
                                                  4.0, 20.0]):
        loss = np.float32(loss)
        jst = jd.update(jst, jnp.asarray(idx), jnp.asarray(loss))
        tst = td.update(tst, torch.from_numpy(idx), torch.from_numpy(loss))
        _same_state(tst, jst)
    assert tst.seen[[3, 7, 60, 0]].tolist() == [6, 4, 2, 0]
    assert float(tst.loss_ema[3]) == 1.5 and float(tst.loss_ema[7]) == 12.5


@pytest.mark.parametrize("alpha", [0.6, 0.5, 0.7, 1.0])
def test_powf_equals_xla_pow(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    x = np.concatenate([
        rng.uniform(0, 12, 300_000), rng.uniform(0, 1e-3, 20_000),
        np.float32([0.0, 12.0, 1.0, 1e-38, 1e-45, 3e-39, np.inf, np.nan]),
        rng.uniform(1, 1e6, 20_000)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda e: e ** alpha)(x))
    got = powf(torch.from_numpy(x), alpha).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repeated_rows_give_identical_sequence_losses(dtype):
    """A sequence drawn twice carries one loss: the per-sequence loss of
    two identical rows is bitwise identical, so the EMA's scatter takes
    the same value from either copy."""
    cfg = get_reduced_config("stablelm-1.6b", dtype=dtype)
    model = Model.from_config(cfg)
    params = model.init_params(torch.Generator().manual_seed(4),
                               device="cpu")
    tokens = torch.from_numpy(jdata.corpus_tokens(8, 33, cfg.vocab_size, 4))
    rows = tokens[[0, 5, 0, 2, 5, 0]]
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:],
             "loss_mask": torch.ones(6, 32)}
    loss = per_sequence_loss(model, params, batch)
    b = _bits(loss)
    assert b[0] == b[2] == b[5] and b[1] == b[4]


def test_sequence_loss_matches_reference():
    """``per_sequence_loss`` (the flash kernel's route, its plain version
    here) against the reference's on its params, float32."""
    from repro.launch import train as jtrain
    jcfg = jreduced("stablelm-1.6b", dtype="float32")
    jparams = JModel.from_config(jcfg).init_params(jax.random.key(6))
    tokens = jdata.corpus_tokens(4, 41, jcfg.vocab_size, 6)
    jb = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
          "loss_mask": np.ones((4, 40), np.float32)}
    want = jax.jit(lambda p, b: jtrain.per_sequence_loss(
        JModel.from_config(jcfg), p, b))(jparams, jb)
    tparams = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         "cpu")
    got = per_sequence_loss(
        Model.from_config(get_reduced_config("stablelm-1.6b",
                                             dtype="float32")),
        tparams, {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in jb.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
