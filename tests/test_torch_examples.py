"""The examples' twins on the CPU (``examples/torch_*.py``).

* ``torch_quickstart.py``: its means against the reference library calls
  ``examples/quickstart.py`` makes at the same N and key: the buffer and
  AMPER rows equal, the PER row within ``PER_TOL`` (the port's and XLA's
  float32 cumulative sums round differently, so a strata boundary can
  move a drawn row); the replay cycle's sampled rewards equal too.
* ``torch_dqn_cartpole.py``, ``torch_lm_train.py`` and
  ``torch_serve_decode.py`` run reduced with ``--device cpu``, as the
  reference's drivers run on the CPU, and finish.
* Each twin defaults to the card (it refuses to start without one) and
  imports neither jax nor the reference.
"""
import ast
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("torch_quickstart", "torch_dqn_cartpole", "torch_lm_train",
         "torch_serve_decode")
# max |PER mean - the reference's|: a few of the 4,096 draws may land in
# the neighbouring stratum's row (mean priority 0.67, spread ~0.3)
PER_TOL = 1e-3


def twin(name: str):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_quickstart() -> dict:
    """The reference library calls of ``examples/quickstart.py``, with the
    means taken exactly (float64 over float32 multiples of 2^-23)."""
    from repro.core.amper import AmperConfig, AmperSampler
    from repro.core.per import CumsumPER
    from repro.core.replay_buffer import ReplayBuffer

    n = 10_000
    with jax.threefry_partitionable(True):
        key = jax.random.key(0)
        prios = jax.random.uniform(key, (n,))
        p = np.asarray(prios).astype(np.float64)
        per = CumsumPER(n)
        per_state = per.update(per.init(), jnp.arange(n), prios)
        out = {"buffer": p.mean(),
               "PER": p[np.asarray(per.sample(per_state, key, 4096))].mean()}
        cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=1.0,
                          csp_capacity=1500, knn_mode="bisect")
        for variant in ("fr", "k"):
            amp = AmperSampler(cfg, variant)
            st = amp.update(amp.init(), jnp.arange(n), prios)
            idx = jax.jit(lambda k, a=amp, s=st: a.sample(s, k, 4096))(key)
            out["AMPER-" + variant] = p[np.asarray(idx)].mean()
        rb = ReplayBuffer(1024, AmperSampler(
            cfg._replace(capacity=1024, csp_capacity=256), "fr"))
        state = rb.init({"obs": jnp.zeros(4), "action": jnp.int32(0),
                         "reward": jnp.float32(0.0)})
        add = jax.jit(rb.add)
        for i in range(256):
            state = add(state, {"obs": jnp.full(4, i, jnp.float32),
                                "action": jnp.int32(i % 2),
                                "reward": jnp.float32(i)})
        idx, batch, _ = rb.sample(state, key, 64)
        state = rb.update_priorities(state, idx, batch["reward"] / 256.0)
        out["replay_reward"] = np.asarray(batch["reward"]).astype(
            np.float64).mean()
        out["max_priority"] = float(state.max_priority)
    return out


def test_quickstart_means_equal_the_reference(capsys):
    got = twin("torch_quickstart").main(["--device", "cpu"])
    want = reference_quickstart()
    for name in ("buffer", "AMPER-fr", "AMPER-k", "replay_reward",
                 "max_priority"):
        assert got[name] == want[name], name
    assert abs(got["PER"] - want["PER"]) <= PER_TOL
    out = capsys.readouterr().out
    assert "AMPER-fr" in out and "replay cycle ok" in out


def test_dqn_cartpole_twin_runs_reduced(capsys):
    rows = twin("torch_dqn_cartpole").main(
        ["--device", "cpu", "--steps", "230", "--num-envs", "2",
         "--replay", "400"])
    assert [r["sampler"] for r in rows] == ["uniform", "per-sumtree",
                                           "amper-k", "amper-fr"]
    for r in rows:
        assert all(math.isfinite(r[k]) for k in ("train", "test", "sec",
                                                 "frames_per_s"))
        assert r["sec"] > 0 and not r["captured"]  # no graph on the CPU
    assert "frames/s" in capsys.readouterr().out


def test_lm_train_twin_runs_reduced(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    mod = twin("torch_lm_train")
    assert mod.main(["--device", "cpu", "--steps", "3",
                     "--ckpt-dir", str(ckpt)]) == 0
    assert os.listdir(ckpt)
    assert "done: 3 steps" in capsys.readouterr().out
    # a relaunch resumes from the checkpoint and has nothing left to run
    assert mod.main(["--device", "cpu", "--steps", "3",
                     "--ckpt-dir", str(ckpt)]) == 0
    assert "resumed from step 3" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b"])
def test_serve_decode_twin_runs_reduced(arch, capsys):
    assert twin("torch_serve_decode").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2",
         "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"torch_quickstart": [],
            "torch_dqn_cartpole": ["--steps", "10"],
            "torch_lm_train": ["--steps", "1", "--ckpt-dir", str(tmp_path)],
            "torch_serve_decode": ["--gen", "2"]}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin(name).main(argv)


@pytest.mark.parametrize("name", TWINS + ("torch_async_dqn",))
def test_twin_imports_neither_jax_nor_the_reference(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
