"""The port's training launcher killed and resumed, on the CPU at the
reduced size.

* Kill and resume: 3 steps, stop, resume to 6 equals 6 uninterrupted
  steps, every stored array bit for bit.
* The port resumes from a checkpoint the reference's launcher wrote, and
  ends where the reference's resumed run ends, within the tolerances
  ``test_torch_launch_train.py`` states.
"""
import shutil

import numpy as np
import torch

from repro.launch import train as jlaunch
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tck
# the autouse fixtures run here too: the threefry layout and SIGTERM
from test_torch_launch_train import (ARGS, _assert_ckpts_agree, _ckpt,  # noqa: F401
                                     _lr_sum, partitionable, sigterm_restored)


def test_kill_and_resume_is_bitwise(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    dev = ["--device", "cpu"]
    assert tlaunch.main(ARGS + dev + ["--steps", "6", "--ckpt-dir", a]) == 0
    assert tlaunch.main(ARGS + dev + ["--steps", "3", "--ckpt-dir", b]) == 0
    assert tlaunch.main(ARGS + dev + ["--steps", "6", "--ckpt-dir", b]) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    x, y = _ckpt(a, 6), _ckpt(b, 6)
    assert set(x.files) == set(y.files)
    for f in x.files:
        np.testing.assert_array_equal(x[f], y[f], err_msg=f)


def test_port_resumes_a_reference_checkpoint(tmp_path, capsys):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    assert jlaunch.main(ARGS + ["--steps", "3", "--ckpt-dir", a]) == 0
    shutil.copytree(a, b)
    assert jlaunch.main(ARGS + ["--steps", "5", "--ckpt-dir", a]) == 0
    capsys.readouterr()
    assert tlaunch.main(ARGS + ["--steps", "5", "--ckpt-dir", b,
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 5 steps" in out
    state = tck.restore(b, 5, _port_target())
    assert int(state[0].step) == 5 and int(state[0].opt_state.count) == 5
    _assert_ckpts_agree(a, b, 5, _lr_sum(3, 5))


def _port_target():
    args = tlaunch.parse_args(ARGS + ["--device", "cpu"])
    _, _, _, _, state, data_state = tlaunch.build(args, torch.device("cpu"))
    return state, data_state
