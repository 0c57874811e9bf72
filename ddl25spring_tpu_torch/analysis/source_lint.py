"""Source linter: AST rules over the port's own Python; the counterpart of
the JAX package's ``analysis/source_lint.py``.

========  ========  ====================================================
rule      severity  pitfall
========  ========  ====================================================
S101      warn      ``os.environ`` / ``os.getenv`` read inside a function
                    of a module whose code builds the steps, kernels,
                    graphs or programs (``parallel/``, ``ops/``,
                    ``models/``, ``benchmarks.py``, ``ft/``, ``serve/``,
                    ``obs/sentinels.py``, ``perfscope.py``,
                    ``timeline.py``, ``memscope.py``): what the program
                    does then depends on ambient process state; read the
                    setting through ``utils.config.env_flag`` (or its
                    siblings) at an entry point and pass it in
S102      --        reserved.  In JAX it flags a ``jax.jit`` without a
                    donation decision.  A torch step updates its
                    parameters and optimizer state in place: there is
                    no fresh output buffer to alias and no compile-time
                    donation to decide, so the rule has no counterpart
                    and its id stays unused
S103      error     raw numpy (``np.*``) called lexically inside a ``with
                    torch.cuda.graph(...)`` block, or inside a function
                    nested in one: the host computation runs once, at
                    capture, and every replay reuses its result as a
                    constant (JAX: numpy inside a traced function
                    constant-folds at trace time)
========  ========  ====================================================

Waivers come from the shared file (``analysis/waivers.toml``), keyed on
``path`` + ``symbol``.  The walker is syntactic: it resolves nothing across
modules, so it lints the whole package in well under a second.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from ddl25spring_tpu_torch.analysis.rules import Finding

PACKAGE = "ddl25spring_tpu_torch"

# the modules whose code builds what runs on the card: an env read inside
# one of them forks the step, graph or program on ambient process state
_TRACED_CODE_DIRS = tuple(f"{PACKAGE}/{p}" for p in (
    "parallel/", "ops/", "models/", "benchmarks.py", "ft/", "serve/",
    "obs/sentinels.py", "obs/perfscope.py", "obs/timeline.py", "obs/memscope.py",
))

RESERVED = {"S102": "a jax.jit without a donation decision: torch updates in place, "
                    "so no counterpart"}


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.graph`` -> "torch.cuda.graph" for Name/Attribute chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` / ``cuda.graph(...)``, any import spelling."""
    return isinstance(expr, ast.Call) and _dotted(expr.func).endswith("cuda.graph")


def _in_scope(relpath: str, scopes: tuple[str, ...]) -> bool:
    rp = relpath.replace(os.sep, "/")
    return any(rp.startswith(s) or rp == s for s in scopes)


class _Walker(ast.NodeVisitor):
    def __init__(self, relpath: str, numpy_aliases: set[str]):
        self.relpath = relpath
        self.numpy_aliases = numpy_aliases
        self.findings: list[Finding] = []
        self.stack: list[str] = []   # enclosing function names
        self.capture = 0             # enclosing torch.cuda.graph blocks

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        captured = any(_is_capture(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        self.capture += captured
        for stmt in node.body:
            self.visit(stmt)
        self.capture -= captured

    def _emit(self, **kw):
        self.findings.append(Finding(source=f"{self.relpath}:{kw.pop('lineno')}",
                                     op=self.qualname, **kw))

    def visit_Call(self, node):
        fn = _dotted(node.func)
        if fn == "os.getenv":
            self._s101(node.lineno, "os.getenv")
        base = fn.split(".", 1)[0]
        if base in self.numpy_aliases and "." in fn and self.capture:
            self._emit(
                rule="S103", severity="error", lineno=node.lineno,
                message=(f"raw numpy call {fn}(...) inside a torch.cuda.graph capture: "
                         "it runs once on the host at capture and every replay reuses "
                         "its result as a constant"),
                fix_hint="compute it with torch ops on the card inside the capture, or "
                         "hoist it out and copy the result into a static input tensor",
            )
        self.generic_visit(node)

    def _s101(self, lineno: int, what: str):
        if not self.stack or not _in_scope(self.relpath, _TRACED_CODE_DIRS):
            return  # a module-level read at import time is the boundary
        self._emit(
            rule="S101", severity="warn", lineno=lineno,
            message=(f"{what} read inside {self.qualname}() of a module that builds steps "
                     "or programs: what it builds now depends on ambient process state"),
            fix_hint=("read the variable through ddl25spring_tpu_torch.utils.config."
                      "env_flag (or env_int/env_str) at the entry point and pass the "
                      "value in"),
        )

    def visit_Attribute(self, node):
        # os.environ.get / os.environ[...] / bare os.environ, exactly once
        if _dotted(node) == "os.environ":
            self._s101(node.lineno, "os.environ")
        else:
            self.generic_visit(node)


def _numpy_aliases(tree: ast.Module) -> set[str]:
    """The names the module binds to numpy (``import numpy as np``)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


def _unparsable(relpath: str, e: SyntaxError) -> Finding:
    return Finding(rule="S000", severity="error", op=relpath,
                   source=f"{relpath}:{e.lineno or 0}",
                   message=f"file does not parse: {e.msg}", fix_hint="fix the syntax error")


def lint_source(text: str, relpath: str) -> list[Finding]:
    """The S-rules over one file's source, ``relpath`` relative to the root."""
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError as e:
        return [_unparsable(relpath, e)]
    w = _Walker(relpath.replace(os.sep, "/"), _numpy_aliases(tree))
    w.visit(tree)
    return w.findings


def lint_paths(paths: Iterable[str], root: str | None = None) -> list[Finding]:
    """Lint files given absolute or root-relative; findings carry
    root-relative sources, so waiver ``path`` globs hold anywhere."""
    root = os.path.abspath(root or os.getcwd())
    out: list[Finding] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        with open(ap) as f:
            out.extend(lint_source(f.read(), os.path.relpath(ap, root)))
    return out


def package_files(root: str) -> list[str]:
    """The source set the check lints: every module of the port's package."""
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, PACKAGE)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames if f.endswith(".py"))
    return sorted(out)


def lint_repo(root: str | None = None) -> list[Finding]:
    root = os.path.abspath(root or os.getcwd())
    return lint_paths(package_files(root), root)
