"""Unreferenced-module report (``--dead-modules``).

Counterpart of ``repro/analysis/deadcode.py`` over the port's package.
Walks the static import graph of the ``repro_torch`` package and
reports, in two sections, modules that nothing reaches:

* **unreferenced** — not reachable from the library's executable entry
  points *nor* from any ``tests/`` / ``benchmarks/`` / ``examples/``
  file: nothing in the repo would notice their deletion.
* **outside_fabric** — unreachable from the entry points (the replay
  fabric never imports them) but kept alive by tests, benchmarks or
  examples; candidates for demotion or doc-only status.

Entry points are every module with an ``if __name__ == "__main__"``
guard plus the fabric roots (the replay service and the analysis CLI;
the reference's third root, ``launch/train``, has no port yet).  Only
imports of ``repro_torch`` count: a test that imports both packages
keeps alive only the port's modules it names.  This is a *report*,
never a gate: it prints, it does not fail the build.
"""
from __future__ import annotations

import ast
import os

PACKAGE = "repro_torch"
FABRIC_ROOTS = (
    "repro_torch.runtime.service",
    "repro_torch.analysis.cli",
)


def package_modules(src_root: str) -> dict[str, str]:
    """Map dotted module name -> file path for everything under
    ``src_root/repro_torch`` (packages map their ``__init__.py``)."""
    out: dict[str, str] = {}
    pkg_root = os.path.join(src_root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, src_root)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out[".".join(parts)] = path
    return out


def _resolve(modules: dict[str, str], dotted: str, names) -> set[str]:
    """Edges for ``from dotted import names`` / ``import dotted``."""
    edges: set[str] = set()
    if dotted in modules:
        edges.add(dotted)
    for n in names:
        child = f"{dotted}.{n}"
        if child in modules:
            edges.add(child)
    # ``import repro_torch.a.b`` also imports the intermediate packages.
    parts = dotted.split(".")
    for i in range(1, len(parts)):
        parent = ".".join(parts[:i])
        if parent in modules:
            edges.add(parent)
    return edges


def _ours(dotted: str) -> bool:
    return dotted == PACKAGE or dotted.startswith(PACKAGE + ".")


def module_imports(path: str, name: str,
                   modules: dict[str, str]) -> set[str]:
    """Modules of the package statically imported by ``path``.

    Handles absolute and relative forms; imports of a *symbol* from a
    package resolve to the submodule when one exists by that name, else
    to the package itself.
    """
    with open(path, encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            return set()
    is_pkg = os.path.basename(path) == "__init__.py"
    pkg = name if is_pkg else name.rsplit(".", 1)[0] if "." in name else ""
    edges: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _ours(alias.name):
                    edges |= _resolve(modules, alias.name, ())
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: from .x import y
                base_parts = pkg.split(".") if pkg else []
                up = node.level - 1
                if up and base_parts:
                    base_parts = base_parts[:-up] if up < len(base_parts) \
                        else []
                dotted = ".".join(base_parts + (
                    node.module.split(".") if node.module else []))
            else:
                dotted = node.module or ""
            if _ours(dotted):
                edges |= _resolve(modules, dotted,
                                  [a.name for a in node.names])
    edges.discard(name)
    return edges


def _has_main_guard(path: str) -> bool:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return "__main__" in src and any(
        isinstance(n, ast.If) and "__main__" in ast.dump(n.test)
        for n in ast.parse(src).body)


def _closure(graph: dict[str, set[str]], roots) -> set[str]:
    seen: set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(graph.get(m, ()))
    return seen


def dead_module_report(src_root: str = "src",
                       extra_scan=("tests", "benchmarks", "examples"),
                       repo_root: str = ".") -> dict:
    """The two-section report (see module docstring)."""
    modules = package_modules(src_root)
    graph = {name: module_imports(path, name, modules)
             for name, path in modules.items()}

    roots = set(FABRIC_ROOTS) & set(modules)
    for name, path in modules.items():
        if name.endswith("__main__") or _has_main_guard(path):
            roots.add(name)
    fabric = _closure(graph, roots)

    external_refs: set[str] = set()
    for d in extra_scan:
        top = os.path.join(repo_root, d)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [x for x in dirnames if x != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    external_refs |= module_imports(
                        os.path.join(dirpath, fn), "", modules)
    externally_alive = _closure(graph, external_refs)

    unreferenced = sorted(set(modules) - fabric - externally_alive)
    outside_fabric = sorted((set(modules) - fabric) & externally_alive)
    return {
        "roots": sorted(roots),
        "modules": len(modules),
        "unreferenced": unreferenced,
        "outside_fabric": outside_fabric,
    }


def render_report(report: dict) -> str:
    lines = [
        f"dead-modules report ({report['modules']} modules, "
        f"roots: {', '.join(report['roots'])})",
        "",
        "## unreferenced (nothing in src/tests/benchmarks/examples "
        "imports these)",
    ]
    lines += [f"  {m}" for m in report["unreferenced"]]
    if not report["unreferenced"]:
        lines.append("  (none)")
    lines += [
        "",
        "## outside the replay fabric (reached only from tests/"
        "benchmarks/examples)",
    ]
    lines += [f"  {m}" for m in report["outside_fabric"]]
    if not report["outside_fabric"]:
        lines.append("  (none)")
    lines.append("")
    lines.append("report only — nothing is deleted by this tool.")
    return "\n".join(lines)
