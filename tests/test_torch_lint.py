"""The port's AST lint (``repro_torch.analysis.lint``) and its CLI.

* Each torch fixture (``tests/fixtures/lint_torch/``) is flagged on
  exactly its lines marked ``# BUG`` with its rule, and the CLI exits 1
  naming it; the clean fixture, the twin of every flagged pattern, lints
  clean.
* ``# repro: noqa[RULE]`` suppresses the named rule on its line only.
* The shipped tree (``src/repro_torch``, the port's tests, its examples,
  ``chip_smoke.py``) is clean against ``analysis-baseline-torch.json``
  with the trace rules on, and still clean under the reference's lint.
* The CLI's exit codes and its json, prom, ``--out`` and
  ``--write-baseline`` paths; ``--bench`` refused with its own reason.
* Parity: on the reference's framework-free fixtures (``wallclock.py``,
  ``clean.py``) the port's lint and the reference's ``run_lint`` give the
  same (rule, line, col) findings.
"""
import glob
import json
import os
import re

import pytest

from repro.analysis.lint import run_lint as ref_run_lint
from repro_torch.analysis import ALL_RULES, cli, lint
from repro_torch.analysis.findings import (Baseline, Finding, apply_noqa,
                                           noqa_rules_for_line)
from repro_torch.obs.exporters import parse_prometheus

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "lint_torch")
REF_FIX = os.path.join(HERE, "fixtures", "lint")
BASELINE = os.path.join(ROOT, "analysis-baseline-torch.json")

FIXTURE_RULES = [
    ("key_reuse.py", "PRNG-REUSE"),
    ("wallclock.py", "WALL-CLOCK"),
    ("host_sync.py", "HOST-SYNC"),
    ("traced_branch.py", "TRACED-BRANCH"),
]


def _bug_lines(path):
    with open(path) as f:
        return [i for i, line in enumerate(f, 1) if "# BUG" in line]


def shipped_paths():
    """What the gate lints: the port, its tests, examples and smoke."""
    return ([os.path.join(ROOT, "src", "repro_torch")]
            + sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
            + sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
            + [os.path.join(ROOT, "chip_smoke.py")])


@pytest.mark.parametrize("fixture,rule", FIXTURE_RULES)
def test_fixture_flags_exactly_its_bug_lines(fixture, rule):
    path = os.path.join(FIX, fixture)
    findings = lint.run_lint([path])
    assert {f.rule for f in findings} == {rule}
    assert sorted({f.line for f in findings}) == _bug_lines(path)


@pytest.mark.parametrize("fixture,rule", FIXTURE_RULES)
def test_cli_exits_one_on_fixture(fixture, rule, capsys):
    assert cli.main([os.path.join(FIX, fixture), "--no-trace"]) == 1
    assert f" {rule} " in capsys.readouterr().out


@pytest.mark.parametrize("kind,pattern", [
    (".item()", r"\.item\(\)"), (".tolist()", r"\.tolist\(\)"),
    (".cpu()", r"\.cpu\(\)"), (".numpy()", r"\.numpy\(\)"),
    (".to('cpu')", r"\.to\('cpu'\)"), ("float()", r"float\(\) on"),
    ("np.asarray", r"np\.asarray"), ("synchronize", r"synchronize"),
    ("torch.tensor(device=)", r"torch\.tensor\(\.\.\., device"),
    ("int() nested in a graphed callable", r"int\(\) on")])
def test_each_host_sync_kind_is_flagged(kind, pattern):
    findings = lint.run_lint([os.path.join(FIX, "host_sync.py")])
    assert any(re.search(pattern, f.message) for f in findings), kind


def test_clean_fixture_passes():
    """The twins of every flagged pattern (fold_in loops, a key re-bound
    by its split, perf_counter, timestamps, a noqa'd replay, early-return
    arms, host syncs outside capture, structural branches in a captured
    body) lint clean, and the CLI exits 0."""
    path = os.path.join(FIX, "clean.py")
    assert lint.run_lint([path]) == []
    assert cli.main([path, "--no-trace"]) == 0


def test_parse_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n    pass\n")
    findings = lint.run_lint([str(bad)])
    assert [f.rule for f in findings] == ["PARSE-ERROR"]
    assert cli.main([str(bad), "--no-trace"]) == 1


def test_fixture_directories_are_skipped(tmp_path):
    (tmp_path / "fixtures").mkdir()
    (tmp_path / "fixtures" / "bad.py").write_text(
        "import time\nd = time.time() - 1\n")
    (tmp_path / "ok.py").write_text("x = 1\n")
    assert [os.path.basename(p) for p in lint.iter_python_files(
        [str(tmp_path)])] == ["ok.py"]
    assert lint.run_lint([str(tmp_path)]) == []


@pytest.mark.parametrize("path,names", [
    ("src/repro_torch/rl/dqn.py", {"_body"}),
    ("src/repro_torch/analysis/launches.py", {"sample"}),
    ("tests/fixtures/lint_torch/host_sync.py", {"step", "graphed"})])
def test_captured_bodies_are_found(path, names):
    """The capture sites the rule reads: the trainer's runner captures
    ``self._body()``, the launch budget ``amp.sample(...)``."""
    import ast

    with open(os.path.join(ROOT, path)) as f:
        mod = lint._ModuleInfo(ast.parse(f.read()), path)
    assert names <= mod.captured_names


# --- suppressions -----------------------------------------------------------

def test_noqa_parsing():
    assert noqa_rules_for_line("x = 1") is None
    assert noqa_rules_for_line("x = f(k)  # repro: noqa") == set()
    assert noqa_rules_for_line(
        "x = f(k)  # repro: noqa[PRNG-REUSE, host-sync] reason"
    ) == {"PRNG-REUSE", "HOST-SYNC"}


@pytest.mark.parametrize("comment,kept", [
    ("", 1), ("  # repro: noqa", 0), ("  # repro: noqa[PRNG-REUSE]", 0),
    ("  # repro: noqa[WALL-CLOCK]", 1)])
def test_noqa_suppresses_only_its_rule(comment, kept):
    src = ("from repro_torch import prng\n\n\ndef f(key):\n"
           "    a = prng.uniform(key)\n"
           f"    return a, prng.normal(key){comment}\n")
    assert len(lint.lint_source(src, "x.py")) == kept
    f = Finding("PRNG-REUSE", "x.py", 6, "m")
    assert len(apply_noqa([f], src.splitlines())) == kept


# --- the shipped tree -------------------------------------------------------

def test_shipped_tree_is_clean_with_committed_baseline(capsys):
    """The gate: the port, its tests, its examples and the smoke, with
    the trace rules on, against the committed baseline."""
    assert cli.main(shipped_paths() + ["--baseline", BASELINE]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_port_files_pass_the_reference_lint():
    """The ground rule: the port's examples and the smoke still pass
    ``python -m repro.analysis`` (its own test covers ``src`` and
    ``tests``)."""
    paths = (sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
             + [os.path.join(ROOT, "chip_smoke.py")])
    assert ref_run_lint(paths) == []


@pytest.mark.parametrize("fixture", ["wallclock.py", "clean.py",
                                     "donation.py"])
def test_parity_with_the_reference_lint(fixture):
    """The reference's fixtures, read and not edited: WALL-CLOCK is
    carried over as it is, clean stays clean, and DONATED-USE has no
    torch meaning, so the port emits nothing on the donation fixture."""
    path = os.path.join(REF_FIX, fixture)
    ref = {(f.rule, f.line, f.col) for f in ref_run_lint([path])}
    got = {(f.rule, f.line, f.col) for f in lint.run_lint([path])}
    if fixture == "donation.py":
        assert {r for r, _, _ in ref} == {"DONATED-USE"} and got == set()
        assert "DONATED-USE" not in ALL_RULES
    else:
        assert got == ref
        assert (fixture == "clean.py") == (got == set())


# --- CLI outputs --------------------------------------------------------------

def test_cli_findings_json_artifact(tmp_path, capsys):
    out = tmp_path / "findings.json"
    rc = cli.main([os.path.join(FIX, "key_reuse.py"), "--no-trace",
                   "--out", str(out), "--format", "json"])
    assert rc == 1
    payload = json.loads(out.read_text())
    assert payload == json.loads(capsys.readouterr().out)
    assert payload["total"] == 4 and payload["counts"] == {"PRNG-REUSE": 4}
    assert payload["findings"][0]["path"].endswith("key_reuse.py")


def test_cli_write_baseline_then_clean(tmp_path):
    bl = tmp_path / "bl.json"
    fixture = os.path.join(FIX, "wallclock.py")
    assert cli.main([fixture, "--no-trace", "--write-baseline", str(bl)]) == 0
    assert sum(Baseline.load(str(bl)).entries.values()) == 3
    assert cli.main([fixture, "--no-trace", "--baseline", str(bl)]) == 0
    # the baseline covers what it recorded, not a new instance
    both = [fixture, os.path.join(FIX, "key_reuse.py")]
    assert cli.main(both + ["--no-trace", "--baseline", str(bl)]) == 1


def test_cli_prom_counts_and_stable_series(capsys):
    assert cli.main([os.path.join(FIX, "traced_branch.py"), "--no-trace",
                     "--format", "prom"]) == 1
    metrics = parse_prometheus(capsys.readouterr().out)
    assert metrics["repro_analysis_findings_traced_branch_total"] == 2.0
    assert cli.main([os.path.join(FIX, "clean.py"), "--no-trace",
                     "--format", "prom"]) == 0
    clean = parse_prometheus(capsys.readouterr().out)
    for rule in ALL_RULES:
        name = "repro_analysis_findings_" + rule.lower().replace("-", "_")
        assert clean[name + "_total"] == 0.0


def test_cli_usage_errors(tmp_path, capsys):
    assert cli.main([]) == 2
    assert cli.main(["--no-trace"]) == 2
    assert cli.main(["--bench", "BENCH_sampling.json"]) == 2
    err = capsys.readouterr().err
    assert "launches.py" in err and "not ported" not in err
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert cli.main([os.path.join(FIX, "clean.py"), "--no-trace",
                     "--baseline", str(bad)]) == 2
