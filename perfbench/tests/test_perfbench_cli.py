"""The command refuses, printing no result: without a CUDA device (the
tests' CPU), and in a directory that holds only the benchmark."""
import os
import shutil
import subprocess
import sys

from perfbench_testkit import ROOT


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "dqn-cartpole.captured", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
