"""What the benchmark may import and read: no module of it imports JAX,
its libraries or the JAX package (top-level names compared whole: the
port ``repro_torch`` is not ``repro``), the plain reference imports
nothing of the port either, and nothing names the JAX package's
benchmarks or the bring-up smoke."""
import ast

import pytest
from perfbench_testkit import ROOT

BASE = ROOT / "perfbench"
FILES = sorted(p for p in BASE.rglob("*.py") if "__pycache__" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _strings(path):
    """String constants that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BASE)))
def test_no_jax(path):
    found = set(_imports(path))
    assert not found & BANNED, found & BANNED
    if "reference" in path.relative_to(BASE).parts:
        assert "repro_torch" not in found
    if "tests" in path.relative_to(BASE).parts:
        return  # the tests run no cell
    for s in _strings(path):
        assert "chip_smoke" not in s and "BENCH_" not in s
        assert not s.startswith("benchmarks")


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core.amper", "reprox", "torch"], []),
    (["repro.core.amper", "repro_torch"], ["repro"]),
    (["jax._src.random", "jaxlib", "flax.linen", "numpy"],
     ["flax", "jax", "jaxlib"]),
])
def test_banned_modules_compare_whole_names(names, found):
    from perfbench.harness.main import banned_modules

    assert banned_modules(names) == found
