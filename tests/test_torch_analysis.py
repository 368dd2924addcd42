"""The port's analysis layer against the reference's.

* Offline lockdep: logs the port's recorder wrote (a clean one, one
  with a lock-order cycle, one with an unparseable line, an empty one)
  give the same findings through ``repro_torch.analysis.locks`` and
  ``repro.analysis.locks``; ``cycle_findings`` agree too.
* ``--dead-modules`` over ``repro_torch`` places each module both
  packages have in the section the reference's report over ``repro``
  places it, but for the modules named in ``DIFFERENCES``, each with the
  reason (a module the port lacks, or an import the port adds).
* ``python -m repro_torch.analysis``: the reference's exit codes (0
  clean, 1 findings, 2 usage); the reference's lint and its other trace
  rules are not ported, and their flags exit 2 naming ROADMAP A16.
* ``--launch-budget`` without CUDA skips with its reason (exit 2),
  never passes.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import deadcode as jdead
from repro.analysis import locks as jlocks
from repro_torch.analysis import Finding, cli, deadcode, launches, locks
from repro_torch.analysis.findings import Baseline, findings_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# Modules both packages have that the two reports place otherwise, and
# why (the section the port's report gives them).
# The launch modules (dryrun, hlo_analysis, mesh, serve, train) sit in
# the fabric in both reports: launch/dryrun.py is a root in both packages
# and imports launch/mesh.py and launch/hlo_analysis.py (A17.10), so no
# entry names them.
DIFFERENCES = {
    # the port's sharded sampler and the serving path route through the
    # port's collectives and plain kernel versions; the reference's
    # shard_map sampler and Pallas wrappers import neither
    "distributed.collectives": "fabric",
    "kernels.ref": "fabric",
}


def _record(path, pairs):
    """Acquire each (outer, inner) pair of tracked locks with the port's
    recorder logging to ``path``."""
    made = {}
    rec = locks.enable(str(path))
    try:
        for outer, inner in pairs:
            a = made.setdefault(outer, locks.make_lock(outer))
            b = made.setdefault(inner, locks.make_lock(inner))
            with a:
                with b:
                    pass
    finally:
        locks.disable()
    return rec


def _keys(findings):
    return [(f.rule, f.path, f.line, f.message, f.col) for f in findings]


@pytest.mark.parametrize("pairs,n_cycles", [
    ([("q.work", "runtime.replay_state")], 0),
    ([("a", "b"), ("b", "c"), ("c", "a"), ("q.work", "b")], 1),
    ([("a", "b"), ("b", "a")], 1)], ids=["clean", "cycle-of-3", "cycle-of-2"])
def test_check_log_equals_reference(tmp_path, pairs, n_cycles):
    log = tmp_path / "locks.jsonl"
    rec = _record(log, pairs)
    got, want = locks.check_log(str(log)), jlocks.check_log(str(log))
    assert _keys(got) == _keys(want)
    assert len(got) == n_cycles == len(rec.cycles())
    assert _keys(locks.cycle_findings(rec.cycles(), "x")) == _keys(
        jlocks.cycle_findings(jlocks.find_cycles(rec.edges()), "x"))


def test_check_log_unparseable_and_empty_equal_reference(tmp_path):
    log = tmp_path / "locks.jsonl"
    _record(log, [("a", "b"), ("b", "a")])
    with open(log, "a") as f:
        f.write("{not json\n\n")
    got, want = locks.check_log(str(log)), jlocks.check_log(str(log))
    assert _keys(got) == _keys(want)
    assert [f.message for f in got if f.line] == [
        "unparseable lockdep log line"]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert locks.check_log(str(empty)) == [] == jlocks.check_log(str(empty))


def test_findings_model_matches_reference():
    from repro.analysis import findings as jf

    f = Finding(rule="LOCK-ORDER", path="<x>", line=3, message="m")
    assert f.render() == jf.Finding(**f.__dict__).render()
    assert findings_json([f]) == jf.findings_json([jf.Finding(**f.__dict__)])
    assert Baseline.from_findings([f]).filter([f]) == []


def test_dead_modules_sections_match_reference():
    ref = jdead.dead_module_report(SRC, repo_root=ROOT)
    got = deadcode.dead_module_report(SRC, repo_root=ROOT)

    def sections(report, prefix):
        out = {}
        for sec in ("unreferenced", "outside_fabric"):
            for m in report[sec]:
                out[m[len(prefix):]] = sec
        return out

    ref_mods = {m[len("repro."):] for m in jdead.repro_modules(SRC)
                if m.startswith("repro.")}
    port_mods = {m[len("repro_torch."):]
                 for m in deadcode.package_modules(SRC)
                 if m.startswith("repro_torch.")}
    rs, ts = sections(ref, "repro."), sections(got, "repro_torch.")
    shared = ref_mods & port_mods
    assert "core.hwmodel" in shared and "runtime.service" in shared
    assert {"launch.dryrun", "launch.hlo_analysis", "launch.mesh"} <= shared
    for m in sorted(shared):
        want = DIFFERENCES.get(m, rs.get(m, "fabric"))
        assert ts.get(m, "fabric") == want, m
    assert {"repro_torch.runtime.service",
            "repro_torch.analysis.cli"} <= set(got["roots"])
    assert got["modules"] == len(port_mods) + 1  # + the package itself


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": SRC})


def test_cli_exit_codes(tmp_path):
    clean, cyc = tmp_path / "clean.jsonl", tmp_path / "cycle.jsonl"
    _record(clean, [("a", "b")])
    _record(cyc, [("a", "b"), ("b", "a")])
    assert cli.main(["--lock-log", str(clean)]) == 0
    assert cli.main(["--lock-log", str(cyc)]) == 1
    assert cli.main(["--lock-log", str(tmp_path / "missing.jsonl")]) == 2
    base = tmp_path / "base.json"
    Baseline.from_findings(locks.check_log(str(cyc))).save(str(base))
    assert cli.main(["--lock-log", str(cyc), "--baseline", str(base)]) == 0
    assert cli.main([]) == 2
    for args in (["src"], ["--no-trace"], ["--bench", "BENCH_sampling.json"]):
        assert cli.main(args) == 2, args
    out = _cli("src", "--no-trace")
    assert out.returncode == 2 and "A16" in out.stderr
    for args in (["--bogus"], ["--format", "prom", "--lock-log", str(cyc)],
                 ["--write-baseline", "x.json"]):
        assert _cli(*args).returncode == 2, args
    out = _cli("--dead-modules")
    assert out.returncode == 0 and "repro_torch.runtime.service" in out.stdout
    out = _cli("--lock-log", str(cyc), "--format", "json")
    assert out.returncode == 1
    payload = json.loads(out.stdout)
    assert payload["counts"] == {"LOCK-ORDER": 1}


def test_launch_budget_skips_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's launch_budget "
                    "phase runs the check there")
    findings, counts, skipped = launches.check_launch_budget()
    assert findings == [] and counts == {} and "CUDA" in skipped
    assert cli.main(["--launch-budget"]) == 2
    assert "launch budget skipped" in capsys.readouterr().err
    assert set(launches.BUDGETS) == {"amper-fr-fused draw",
                                     "captured agent step"}
