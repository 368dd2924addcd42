"""AST lint rules for the port's hazard classes.

Counterpart of ``repro/analysis/lint.py``, with each rule as it means
something in PyTorch:

* ``PRNG-REUSE`` — a key consumed by two of :mod:`repro_torch.prng`'s
  drawing calls (``split``, ``bits``, ``uniform``, ``randint``,
  ``bernoulli``, ``normal``) without an intervening split or
  reassignment: the port's keys are jax.random's, so a reused key
  repeats the reference's correlated-draw bug.  ``fold_in`` and
  ``key_data`` derive and never consume.  ``jax.random`` calls (in the
  port's tests) stay the reference lint's job.
* ``WALL-CLOCK`` — ``time.time()`` in duration arithmetic or compared as
  a deadline, as in the reference; reading it as a timestamp is fine.
* ``HOST-SYNC`` — a host synchronization inside a *captured* body:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``float()`` / ``int()`` / ``bool()`` of a tensor parameter,
  ``np.asarray`` / ``np.array``, ``torch.cuda.synchronize`` or
  ``torch.tensor(..., device=...)``.  Under CUDA graph capture these
  fail, or freeze a host value into every replay.
* ``TRACED-BRANCH`` — a Python ``if`` / ``while`` on a tensor parameter
  inside a captured body (an implicit ``bool(tensor)``: a sync, and a
  branch the graph freezes), a method call on one included
  (``x.sum() > 0``).  ``is None``, attribute reads (``.shape``,
  ``.dtype``, ``.device``), metadata methods (``.dim()``, ``.size()``,
  ``.numel()``), ``len()`` and ``isinstance`` are structural and not
  flagged.
* ``PARSE-ERROR`` — a file that does not parse.

The reference's ``DONATED-USE`` is not emitted: PyTorch has no buffer
donation, so no call invalidates its argument.

A body is *captured* when it is a function called directly inside a
``with torch.cuda.graph(...)`` block of the same module (``f(...)`` or
``obj.f(...)`` names the module's defs called ``f``), a function passed
to ``torch.cuda.make_graphed_callables``, or a def nested in either.

The analysis is the reference's flow-light design: straight-line
dataflow per function scope, both arms of an ``if`` explored and merged
conservatively (an arm that cannot fall through contributes nothing),
loop bodies executed twice (so a consume in iteration 1 flags the reuse
in iteration 2), the captured context inherited lexically.  False
positives take ``# repro: noqa[RULE]`` (:mod:`repro_torch.analysis.
findings`); directories named ``fixtures`` are skipped.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from repro_torch.analysis.findings import Finding, apply_noqa

# repro_torch.prng callables whose first positional argument is a key
# they CONSUME (drawing twice from one key repeats the stream); fold_in
# and key_data derive and may be applied to one key again and again.
_KEY_CONSUMERS = frozenset({
    "split", "bits", "uniform", "randint", "bernoulli", "normal"})

_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_SYNC_NP = frozenset({"asarray", "array"})
_STATIC_TEST_CALLS = frozenset({
    "len", "isinstance", "getattr", "hasattr", "type", "callable"})
# tensor methods that read metadata, not values
_STRUCTURAL_METHODS = frozenset({
    "dim", "ndimension", "size", "numel", "nelement", "stride",
    "is_contiguous", "element_size", "get_device", "data_ptr"})


def _dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain as ``a.b.c`` (None if not one)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(node: ast.AST) -> str | None:
    """The called name of ``f`` or ``obj.f``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_port_prng(func_value: ast.AST) -> bool:
    """Does this expression look like the ``repro_torch.prng`` module?"""
    if isinstance(func_value, ast.Name):
        return func_value.id == "prng"
    if isinstance(func_value, ast.Attribute):
        return func_value.attr == "prng"
    return False


def _is_time_time(node: ast.AST, bare_time_fn: bool) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "time":
        return isinstance(f.value, ast.Name) and f.value.id == "time"
    return bare_time_fn and isinstance(f, ast.Name) and f.id == "time"


def _is_graph_block(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)`` (or ``cuda.graph`` / ``graph``)."""
    ctx = item.context_expr
    if not isinstance(ctx, ast.Call):
        return False
    name = _dotted(ctx.func) or ""
    return name == "graph" or name.endswith("cuda.graph")


@dataclass
class _FlowState:
    """Per-scope dataflow facts."""

    consumed: dict = field(default_factory=dict)   # key name -> consumer fn
    timestamps: set = field(default_factory=set)   # names from time.time()

    def copy(self) -> "_FlowState":
        return _FlowState(dict(self.consumed), set(self.timestamps))

    def merge(self, other: "_FlowState") -> None:
        """Conservative join after exclusive branches."""
        self.consumed.update(other.consumed)
        self.timestamps |= other.timestamps

    def kill(self, name: str) -> None:
        self.consumed.pop(name, None)
        self.timestamps.discard(name)


class _ModuleInfo:
    """Module-wide facts the per-scope passes need."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        # ``from time import time`` makes bare ``time()`` the wall clock.
        self.bare_time_fn = any(
            isinstance(n, ast.ImportFrom) and n.module == "time"
            and any(a.name == "time" for a in n.names)
            for n in ast.walk(tree))
        # Names of the functions a CUDA graph captures in this module.
        self.captured_names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_block(i) for i in node.items):
                for stmt in node.body:
                    for call in _calls_in(stmt):
                        name = _leaf(call.func)
                        if name is not None:
                            self.captured_names.add(name)
            elif isinstance(node, ast.Call) and _leaf(
                    node.func) == "make_graphed_callables" and node.args:
                target = node.args[0]
                elts = (target.elts if isinstance(target, (ast.Tuple,
                                                           ast.List))
                        else [target])
                for e in elts:
                    name = _leaf(e)
                    if name is not None:
                        self.captured_names.add(name)


def _calls_in(node: ast.AST):
    """Every call under ``node``, not descending into nested scopes."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.Lambda)):
        return
    if isinstance(node, ast.Call):
        yield node
    for child in ast.iter_child_nodes(node):
        yield from _calls_in(child)


class _ScopeLinter:
    """Runs all dataflow rules over one function (or module) scope."""

    def __init__(self, mod: _ModuleInfo, findings: list[Finding],
                 captured: bool, params: set[str]):
        self.mod = mod
        self.findings = findings
        self.captured = captured
        self.params = params

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.mod.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message))

    # --- statements ---------------------------------------------------- #

    def exec_block(self, stmts, state: _FlowState) -> None:
        for s in stmts:
            self.exec_stmt(s, state)

    def exec_stmt(self, stmt: ast.stmt, state: _FlowState) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # analyzed as their own scope by the module driver
        if isinstance(stmt, ast.Assign):
            self.visit_expr(stmt.value, state)
            names = [n for t in stmt.targets for n in _target_names(t)]
            for n in names:
                state.kill(n)
            if _is_time_time(stmt.value, self.mod.bare_time_fn):
                state.timestamps.update(names)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                self.visit_expr(stmt.value, state)
            for n in _target_names(stmt.target):
                state.kill(n)
                if stmt.value is not None and _is_time_time(
                        stmt.value, self.mod.bare_time_fn):
                    state.timestamps.add(n)
        elif isinstance(stmt, ast.If):
            self.visit_expr(stmt.test, state)
            self._check_traced_branch(stmt, "if")
            s_body, s_else = state.copy(), state.copy()
            self.exec_block(stmt.body, s_body)
            self.exec_block(stmt.orelse, s_else)
            # An arm that cannot fall through (return/raise/...) does not
            # contribute to the post-if state.
            live = [s for s, blk in ((s_body, stmt.body),
                                     (s_else, stmt.orelse))
                    if not _terminates(blk)]
            if not live:
                live = [s_body]  # both terminate: post-state unreachable
            first, *rest = live
            state.consumed, state.timestamps = (first.consumed,
                                                first.timestamps)
            for s in rest:
                state.merge(s)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.visit_expr(stmt.iter, state)
            for _ in range(2):  # second pass exposes cross-iteration reuse
                for n in _target_names(stmt.target):
                    state.kill(n)
                self.exec_block(stmt.body, state)
            self.exec_block(stmt.orelse, state)
        elif isinstance(stmt, ast.While):
            self.visit_expr(stmt.test, state)
            self._check_traced_branch(stmt, "while")
            for _ in range(2):
                self.exec_block(stmt.body, state)
                self.visit_expr(stmt.test, state)
            self.exec_block(stmt.orelse, state)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.visit_expr(item.context_expr, state)
                if item.optional_vars is not None:
                    for n in _target_names(item.optional_vars):
                        state.kill(n)
            self.exec_block(stmt.body, state)
        elif isinstance(stmt, ast.Try):
            self.exec_block(stmt.body, state)
            for h in stmt.handlers:
                s_h = state.copy()
                self.exec_block(h.body, s_h)
                state.merge(s_h)
            self.exec_block(stmt.orelse, state)
            self.exec_block(stmt.finalbody, state)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                for n in _target_names(t):
                    state.kill(n)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.visit_expr(child, state)

    # --- expressions ---------------------------------------------------- #

    def visit_expr(self, node: ast.AST, state: _FlowState) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # separate scope
        if isinstance(node, ast.Call):
            self._visit_call(node, state)
            return
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            self._check_wallclock_arith(node, state)
        elif isinstance(node, ast.Compare):
            for side in [node.left] + node.comparators:
                if self._is_timestamp(side, state):
                    self._emit(
                        "WALL-CLOCK", node,
                        "time.time() result compared as a deadline; use "
                        "time.monotonic()/perf_counter() for elapsed-time "
                        "logic")
                    break
        elif isinstance(node, ast.Name):
            return
        for child in ast.iter_child_nodes(node):
            self.visit_expr(child, state)

    def _visit_call(self, node: ast.Call, state: _FlowState) -> None:
        # Arguments are evaluated (read) before the call consumes them.
        self.visit_expr(node.func, state)
        for a in node.args:
            self.visit_expr(a, state)
        for kw in node.keywords:
            self.visit_expr(kw.value, state)

        f = node.func
        # PRNG-REUSE: prng.<consumer>(key, ...)
        if (isinstance(f, ast.Attribute) and _is_port_prng(f.value)
                and f.attr in _KEY_CONSUMERS and node.args):
            key_arg = node.args[0]
            if isinstance(key_arg, ast.Name):
                name = key_arg.id
                if name in state.consumed:
                    self._emit(
                        "PRNG-REUSE", node,
                        f"key '{name}' already consumed by prng."
                        f"{state.consumed[name]}; split it (or fold_in "
                        f"distinct data) before drawing again")
                state.consumed[name] = f.attr
        if self.captured:
            self._check_host_sync(node)

    # --- rule bodies ---------------------------------------------------- #

    def _is_timestamp(self, node: ast.AST, state: _FlowState) -> bool:
        return (_is_time_time(node, self.mod.bare_time_fn)
                or (isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load) and node.id in state.timestamps))

    def _check_wallclock_arith(self, node: ast.BinOp,
                               state: _FlowState) -> None:
        if self._is_timestamp(node.left, state) or self._is_timestamp(
                node.right, state):
            self._emit(
                "WALL-CLOCK", node,
                "time.time() used in duration arithmetic; use "
                "time.perf_counter() (NTP steps/smearing corrupt "
                "wall-clock deltas)")

    def _check_host_sync(self, node: ast.Call) -> None:
        f = node.func
        name = _dotted(f) or ""
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_SYNC_METHODS:
                self._emit("HOST-SYNC", node,
                           f".{f.attr}() inside a captured body copies to "
                           f"the host: it fails under CUDA graph capture "
                           f"or freezes the value into every replay")
                return
            if f.attr == "to" and _names_cpu(node):
                self._emit("HOST-SYNC", node,
                           ".to('cpu') inside a captured body copies to "
                           "the host; keep the value on the card")
                return
            if (f.attr in _HOST_SYNC_NP and isinstance(f.value, ast.Name)
                    and f.value.id in {"np", "numpy", "onp"}):
                self._emit("HOST-SYNC", node,
                           f"np.{f.attr} inside a captured body pulls a "
                           f"tensor to the host; use torch ops")
                return
            if name.endswith("cuda.synchronize"):
                self._emit("HOST-SYNC", node,
                           "torch.cuda.synchronize inside a captured body "
                           "is a host sync (illegal during capture)")
                return
            if name.endswith("torch.tensor") and any(
                    kw.arg == "device" for kw in node.keywords):
                self._emit("HOST-SYNC", node,
                           "torch.tensor(..., device=...) inside a captured "
                           "body copies a host value to the card: a replay "
                           "reuses the captured copy")
                return
        if (isinstance(f, ast.Name) and f.id in {"float", "int", "bool"}
                and node.args):
            if any(isinstance(n, ast.Name) and n.id in self.params
                   and isinstance(n.ctx, ast.Load)
                   for n in ast.walk(node.args[0])):
                self._emit(
                    "HOST-SYNC", node,
                    f"{f.id}() on a tensor parameter inside a captured "
                    f"body syncs with the host and freezes the value into "
                    f"every replay; keep it as a tensor")

    def _check_traced_branch(self, stmt, kw: str) -> None:
        if not self.captured:
            return
        if self._test_mentions_param(stmt.test):
            self._emit(
                "TRACED-BRANCH", stmt,
                f"Python '{kw}' branches on a tensor parameter inside a "
                f"captured body (an implicit host sync, and a branch the "
                f"graph freezes); use torch.where or decide on the host")

    def _test_mentions_param(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            return False  # x.shape / x.dtype / x.device: structural
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in _STATIC_TEST_CALLS:
                return False
            if isinstance(f, ast.Attribute):
                # x.sum() reads the tensor; x.dim() / x.size() its shape
                if f.attr in _STRUCTURAL_METHODS:
                    return False
                parts = [f.value] + node.args + [k.value
                                                 for k in node.keywords]
                return any(self._test_mentions_param(c) for c in parts)
            return any(self._test_mentions_param(c)
                       for c in ast.iter_child_nodes(node))
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False  # `x is None`: structural
        if isinstance(node, ast.Name):
            return node.id in self.params
        return any(self._test_mentions_param(c)
                   for c in ast.iter_child_nodes(node))


def _names_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")`` or ``.to(torch.device("cpu"))``."""
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and _leaf(a.func) == "device" and a.args
                and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


def _terminates(block: list[ast.stmt]) -> bool:
    """True when the block cannot fall through to the statement after
    the enclosing ``if`` (last statement unconditionally leaves it)."""
    if not block:
        return False
    last = block[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
        return True
    if isinstance(last, ast.If):
        return bool(_terminates(last.body) and last.orelse
                    and _terminates(last.orelse))
    return False


def _target_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _target_names(e)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _param_names(node) -> set[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return {n for n in names if n != "self"}
    return set()


def lint_source(source: str, path: str) -> list[Finding]:
    """Run every AST rule over one file's source; noqa already applied."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="PARSE-ERROR", path=path,
                        line=e.lineno or 1, col=e.offset or 0,
                        message=f"file does not parse: {e.msg}")]
    mod = _ModuleInfo(tree, path)
    findings: list[Finding] = []

    # Every function-like scope, tagged captured or not; a def nested in
    # a captured def runs under the capture too (lexical inheritance).
    scopes: list[tuple[list, bool, set[str]]] = [(tree.body, False, set())]

    def collect(node, captured_ctx: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                captured = (captured_ctx
                            or child.name in mod.captured_names)
                scopes.append((child.body, captured, _param_names(child)))
                collect(child, captured)
            elif isinstance(child, ast.Lambda):
                scopes.append(([ast.Expr(value=child.body)], captured_ctx,
                               _param_names(child)))
                collect(child, captured_ctx)
            else:
                collect(child, captured_ctx)

    collect(tree, False)
    for body, captured, params in scopes:
        _ScopeLinter(mod, findings, captured, params).exec_block(
            body, _FlowState())

    # Loop bodies run twice: dedupe identical findings from one site.
    seen, unique = set(), []
    for f in findings:
        k = (f.rule, f.line, f.col, f.message)
        if k not in seen:
            seen.add(k)
            unique.append(f)
    return apply_noqa(unique, source.splitlines())


def lint_file(path: str, root: str | None = None) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    rel = os.path.relpath(path, root) if root else path
    return lint_source(source, rel)


def iter_python_files(paths, *, exclude_parts=("fixtures",)):
    """Yield .py files under ``paths``; directories named in
    ``exclude_parts`` (lint fixtures: deliberate violations) are
    skipped."""
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in exclude_parts and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def run_lint(paths, root: str | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(paths):
        findings.extend(lint_file(path, root=root))
    return findings
