"""The port's training launcher (``python -m repro_torch.launch.train``)
against the reference's, on the CPU at the reduced size.

* Both launchers resume from one step-0 checkpoint (the reference's
  initial state, written in the shared format) and take 5 steps: the
  logged losses agree within 1% (the reduced config computes in
  bfloat16, and the packages round at different places); the draws are
  equal at every step (the losses, about 33, clip at ``v_max`` 12, so
  the priorities are equal too), and a reference data pipeline fed the
  port's per-sequence losses draws the port's indices at every step.
  The final checkpoints agree: the replay tables and counts exactly,
  the params within the learning rates the steps applied (an Adam step
  moves a weight by about its lr whatever the gradient's size, so a
  near-zero gradient whose sign rounds otherwise moves it the other
  way).
Kill and resume, and a reference checkpoint resumed in the port, are in
``test_torch_launch_resume.py``.
"""
import json
import os
import re
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.launch import train as jlaunch
from repro.models.model_api import Model as JModel
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train import train_step as jts
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import cosine_schedule as jcosine
from repro_torch.launch import train as tlaunch

ARCH = "stablelm-1.6b"
ARGS = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq-len", "32",
        "--n-seqs", "64", "--sampler", "amper-fr", "--log-every", "1",
        "--ckpt-every", "100"]
LR = 3e-4


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(autouse=True)
def sigterm_restored():
    """Both launchers install a SIGTERM hook; the worker gets its own
    handler back."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss ([-\d.naninf]+)", out)}


def _ckpt(directory, step):
    return np.load(os.path.join(directory, f"step_{step:010d}.ckpt"))


def _names(npz):
    return json.loads(bytes(npz["__manifest__"]).decode())["names"]


def _assert_ckpts_agree(a_dir, b_dir, step, lr_sum):
    a, b = _ckpt(a_dir, step), _ckpt(b_dir, step)
    names = _names(a)
    assert names == _names(b)
    for i, name in enumerate(names):
        x, y = a[f"d{i}"], b[f"d{i}"]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if "params" in name:
            np.testing.assert_allclose(x, y, rtol=0, atol=2 * lr_sum,
                                       err_msg=name)
        elif name.endswith(("sampler_state/pq", "sampler_state/valid",
                            "seen")) or name in ("0/step",
                                                 "0/opt_state/count"):
            np.testing.assert_array_equal(x, y, err_msg=name)
        elif name.endswith("loss_ema"):
            np.testing.assert_allclose(x, y, rtol=1e-2, err_msg=name)


def _lr_sum(first, last):
    return sum(LR * s / 20 for s in range(first + 1, last + 1))


def _reference_initial_state(directory):
    """The reference launcher's initial (TrainState, ReplayDataState),
    saved at step 0."""
    cfg = jreduced(ARCH)
    model = JModel.from_config(cfg)
    opt = JAdamW(jcosine(LR, 20, 5))
    tokens = jdata.corpus_tokens(64, 33, cfg.vocab_size, seed=0)
    data = jdata.PrioritizedSeqData(tokens, 4, sampler="amper-fr")
    state = jts.init_train_state(model, opt, jax.random.key(0))
    jck.save_incremental(directory, 0, (state, data.init()))
    return data


def test_launcher_matches_reference_from_one_state(tmp_path, capsys):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    jd = _reference_initial_state(a)
    shutil.copytree(a, b)
    assert jlaunch.main(ARGS + ["--steps", "5", "--ckpt-dir", a]) == 0
    ref_out = capsys.readouterr().out
    steps = []
    assert tlaunch.main(ARGS + ["--steps", "5", "--ckpt-dir", b,
                                "--device", "cpu"],
                        on_step=steps.append) == 0
    port_out = capsys.readouterr().out
    assert "resumed from step 0" in ref_out and "resumed from step 0" in \
        port_out
    want, got = _losses(ref_out), _losses(port_out)
    assert sorted(got) == sorted(want) == list(range(5))
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=1e-2), s
    # the reference's pipeline, fed the port's per-sequence losses, draws
    # the port's indices at every step
    jst = jck.restore(a, 0, jax.eval_shape(lambda: (
        jts.init_train_state(JModel.from_config(jreduced(ARCH)),
                             JAdamW(1e-3), jax.random.key(0)),
        jd.init())))[1]
    for rec in steps:
        key = jax.random.fold_in(jax.random.key(0), rec["step"])
        idx, _ = jd.sample(jst, key)
        np.testing.assert_array_equal(np.asarray(idx), rec["idx"].numpy())
        jst = jd.update(jst, idx, jax.numpy.asarray(rec["seq_loss"].numpy()))
    _assert_ckpts_agree(a, b, 5, _lr_sum(0, 5))


def test_cli_runs_on_cpu_and_refuses_cuda_without_a_card(capsys,
                                                          monkeypatch):
    assert tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                         "--n-seqs", "16", "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: 2 steps" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--reduced", "--steps", "1"])
