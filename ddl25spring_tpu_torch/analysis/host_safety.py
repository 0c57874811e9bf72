"""graft-race over the port: host-side concurrency and signal-safety rules
(S201-S205); the counterpart of the JAX package's
``analysis/host_safety.py``.

The rules judge host machinery that no device trace sees: threads, signal
and excepthook handlers, atexit and flight-recorder shutdown hooks, the
locks they take, and the host mirrors of device state.  The pass walks the
modules of the port that own such machinery (``obs/``, ``ft/``, ``serve/``,
``bench.py``, ``utils/checkpoint.py`` with its writer thread and
``parallel/launch.py`` with its atexit hook), builds an execution-context
inventory and judges five rules over it:

========  ========  ====================================================
rule      severity  hazard
========  ========  ====================================================
S201      error     shared mutable attribute written from >=2 execution
                    contexts with no common lock held at every write
S202      error     lock-order inversion: a cycle in the static lock
                    acquisition graph (lexical nesting + calls made
                    while holding)
S203      error     signal-handler-unsafe operation: non-reentrant lock
                    acquisition (or ``input()``) reachable from a
                    signal/excepthook path
S204      error     host<->device mirror drift: a :data:`MIRRORS`
                    contract method assigns the device page pool from one
                    of its device programs without touching any host-side
                    mirror in the same method (a mirror settled
                    elsewhere takes a reasoned waiver)
S205      warn      unbounded blocking call (``join()``/``wait()``/
                    queue ``get()`` without a timeout) on a shutdown or
                    crash-dump path
========  ========  ====================================================

The pass is syntactic plus a conservative call graph: ``self.x`` resolves
to the enclosing class, module singletons (``flight = FlightRecorder()``)
and ``from m import flight`` resolve across the files in scope, and what
cannot be resolved is dropped, not guessed.  Execution contexts propagate
from caller to callee to a fixed point; lock protection the other way (a
callee inherits the locks held at every one of its call sites).
``__init__`` writes are exempt from S201: construction happens before
publication.

S204's contract names the port's own serving engine: its page pools
(``pool``, ``draft_pool``) are replaced by the outputs of its device
programs (the decode tick, the prefills, the drafter, the verify, the
truncates and the releases), assigned through tuple targets
(``self.pool, new_tok, ok = self._tick(...)``), and its host mirrors are the
page accounting the admission gate trusts.

Waivers come from the shared ``analysis/waivers.toml`` (path glob and
``symbol`` substring).  The runtime twin of the same invariants is
:mod:`~ddl25spring_tpu_torch.analysis.host_sanitizer` (``DDL25_SANITIZE=1``).
Run: ``python -m ddl25spring_tpu_torch.analysis --host-safety --check``.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Any, Iterable

from ddl25spring_tpu_torch.analysis.rules import Finding

# the files (root-relative) the pass walks: every module of the port that
# owns threads, handlers or host mirrors.  Step and kernel code is the
# device traces' concern.
_HOST_SCOPE = (
    "ddl25spring_tpu_torch/obs/",
    "ddl25spring_tpu_torch/ft/",
    "ddl25spring_tpu_torch/serve/",
    "ddl25spring_tpu_torch/bench.py",
    "ddl25spring_tpu_torch/utils/checkpoint.py",
    "ddl25spring_tpu_torch/parallel/launch.py",
)

# ---------------------------------------------------------------- MIRRORS
#
# The S204 contract: for one class, the attributes that hold device state,
# the device programs whose outputs replace it, and the host attributes that
# mirror its page accounting.  A method that assigns ``self.<state>`` (alone
# or inside a tuple target) from a call of one of ``device_ops`` must also
# write, or call a mutator on, at least one host mirror in the same method:
# split accounting is how a mirror drifts from the device.
MIRRORS: tuple[dict[str, Any], ...] = (
    {
        "path": "ddl25spring_tpu_torch/serve/engine.py",
        "cls": "ServeEngine",
        "device_state": ("pool", "draft_pool"),
        "device_ops": ("_tick", "prefill", "_verify", "draft", "_truncate",
                       "_release", "_draft_prefill", "_draft_truncate",
                       "_draft_release"),
        "host_mirrors": ("_reserved", "_pending_pages", "_release_mask",
                         "_cached_pages", "_adopted_pages", "_pending",
                         "prefix", "peak_pages"),
    },
)

_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "clear", "update", "setdefault",
    "evict", "put", "insert_prefix", "claim",
}
_BLOCKING_NAMES = {"join", "wait", "get"}
_TIMEOUT_KWARGS = {"timeout", "timeout_s", "timeout_ms"}


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _in_scope(relpath: str, scopes: tuple[str, ...] = _HOST_SCOPE) -> bool:
    rp = relpath.replace(os.sep, "/")
    return any(rp.startswith(s) or rp == s for s in scopes)


# ------------------------------------------------------------- inventory


@dataclass
class _Func:
    """One function/method's concurrency-relevant facts."""

    fid: str                 # "relpath::Qual.Name" — globally unique
    relpath: str
    cls: str | None          # innermost enclosing class name
    name: str                # bare name
    qual: str                # dotted qualname within the module
    lineno: int
    # (raw dotted call token, lineno, locks held lexically at the site)
    calls: list[tuple[str, int, frozenset]] = field(default_factory=list)
    # (lock key, lineno, locks held BEFORE this acquisition)
    acquires: list[tuple[str, int, frozenset]] = field(default_factory=list)
    # attr writes: (attr name, lineno, locks held lexically)
    writes: list[tuple[str, int, frozenset]] = field(default_factory=list)
    # unbounded-blocking sites: (description, lineno, bounded?)
    blocking: list[tuple[str, int, bool]] = field(default_factory=list)
    # S204: device mutations (state attr, op name, lineno) + host writes
    device_writes: list[tuple[str, str, int]] = field(default_factory=list)
    host_mirror_writes: set = field(default_factory=set)
    nested: dict = field(default_factory=dict)   # name -> fid


@dataclass
class _Module:
    relpath: str
    classes: dict = field(default_factory=dict)    # cls -> {meth: fid}
    funcs: dict = field(default_factory=dict)      # name -> fid
    # module-level singletons: name -> class token (resolved later)
    instances: dict = field(default_factory=dict)
    # (cls, attr) -> class token, from ``self.attr = Cls(...)``
    attr_instances: dict = field(default_factory=dict)
    # local name -> (module relpath-ish dotted, original name)
    imports: dict = field(default_factory=dict)


@dataclass
class Inventory:
    """The cross-file execution-context inventory graft-race judges."""

    modules: dict = field(default_factory=dict)    # relpath -> _Module
    funcs: dict = field(default_factory=dict)      # fid -> _Func
    # declared locks: key -> {"reentrant": bool, "site": "rel:line"}
    locks: dict = field(default_factory=dict)
    # raw entry registrations: (kind, relpath, cls, owner_fid_or_None,
    #   callback token, lineno).  kind in thread|signal|atexit|shutdown
    entries: list = field(default_factory=list)
    mirrors: tuple = MIRRORS

    def summary(self) -> dict[str, Any]:
        kinds: dict[str, int] = {}
        for kind, *_ in self.entries:
            kinds[kind] = kinds.get(kind, 0) + 1
        return {
            "files": len(self.modules),
            "functions": len(self.funcs),
            "locks": {
                k: ("RLock" if v["reentrant"] else "Lock")
                for k, v in sorted(self.locks.items())
            },
            "entry_points": kinds,
            "mirror_contracts": len(self.mirrors),
        }


class _Walker(ast.NodeVisitor):
    """Pass 1: per-file facts with lexical lock tracking.  Resolution
    across functions/files happens in pass 2 (:func:`_analyze`)."""

    def __init__(self, relpath: str, inv: Inventory,
                 mirrors: tuple = MIRRORS):
        self.relpath = relpath
        self.inv = inv
        self.mod = inv.modules.setdefault(relpath, _Module(relpath))
        self.mirrors = [
            m for m in mirrors
            if relpath.replace(os.sep, "/") == m["path"]
        ]
        self.cls_stack: list[str] = []
        self.fn_stack: list[_Func] = []
        self.held: list[str] = []     # lock keys held lexically

    # ------------------------------------------------------------ helpers

    @property
    def cur(self) -> _Func | None:
        return self.fn_stack[-1] if self.fn_stack else None

    @property
    def cls(self) -> str | None:
        return self.cls_stack[-1] if self.cls_stack else None

    def _lock_key(self, token: str, any_name: bool = False) -> str | None:
        """``self._lock`` -> "rel::Cls._lock"; bare module-level name
        -> "rel::name".  None for anything else.  Unless ``any_name``
        (declaration sites), only names that read as locks qualify —
        ``with self.ckpt:`` or ``with ctx:`` must not register as
        protection."""
        parts = token.split(".")
        if not any_name and not any(
            s in parts[-1].lower() for s in ("lock", "mutex", "mu_")
        ):
            return None
        if parts[0] == "self" and len(parts) == 2 and self.cls:
            return f"{self.relpath}::{self.cls}.{parts[1]}"
        if len(parts) == 1:
            return f"{self.relpath}::{parts[0]}"
        return None

    def _contains_lock_ctor(self, value: ast.AST) -> str | None:
        """'Lock'/'RLock' if the expression constructs one anywhere
        (covers ``wrap_lock("x", threading.RLock())``)."""
        for n in ast.walk(value):
            if isinstance(n, ast.Call):
                last = _dotted(n.func).rsplit(".", 1)[-1]
                if last in ("Lock", "RLock"):
                    return last
        return None

    def _instance_cls_token(self, value: ast.AST) -> str | None:
        """``Cls(...)`` / ``mod.Cls(...)`` -> the ctor token, when it
        looks like a class (CapWord convention)."""
        if isinstance(value, ast.Call):
            token = _dotted(value.func)
            last = token.rsplit(".", 1)[-1]
            if last[:1].isupper() and last not in ("Lock", "RLock"):
                return token
        return None

    def _register_entry(self, kind: str, token: str, lineno: int):
        self.inv.entries.append((
            kind, self.relpath, self.cls,
            self.cur.fid if self.cur else None, token, lineno,
        ))

    # -------------------------------------------------------- definitions

    def visit_ClassDef(self, node):
        self.cls_stack.append(node.name)
        self.mod.classes.setdefault(node.name, {})
        self.generic_visit(node)
        self.cls_stack.pop()

    def visit_FunctionDef(self, node):
        qual = ".".join(
            [*self.cls_stack, *(f.name for f in self.fn_stack), node.name]
        )
        fn = _Func(
            fid=f"{self.relpath}::{qual}", relpath=self.relpath,
            cls=self.cls, name=node.name, qual=qual, lineno=node.lineno,
        )
        self.inv.funcs[fn.fid] = fn
        if self.fn_stack:                      # nested def
            self.fn_stack[-1].nested[node.name] = fn.fid
        elif self.cls:
            self.mod.classes[self.cls][node.name] = fn.fid
        else:
            self.mod.funcs[node.name] = fn.fid
        self.fn_stack.append(fn)
        saved, self.held = self.held, []       # body runs later, unlocked
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Import(self, node):
        for a in node.names:
            self.mod.imports[a.asname or a.name] = (a.name, None)

    def visit_ImportFrom(self, node):
        if node.module:
            for a in node.names:
                self.mod.imports[a.asname or a.name] = (
                    node.module, a.name
                )

    # ----------------------------------------------------------- writes

    def _record_write(self, target: ast.AST, lineno: int,
                      value: ast.AST | None):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write(elt, lineno, value)
            return
        if isinstance(target, ast.Subscript):
            target = target.value
        token = _dotted(target)
        parts = token.split(".")
        if parts[0] != "self" or len(parts) < 2 or self.cur is None:
            return
        attr = parts[1]
        self.cur.writes.append((attr, lineno, frozenset(self.held)))
        for m in self.mirrors:
            if self.cls == m["cls"] and attr in m["host_mirrors"]:
                self.cur.host_mirror_writes.add(attr)

    def _check_device_write(self, targets, value, lineno):
        if value is None or not self.mirrors or self.cur is None:
            return
        ops = {
            _dotted(n.func).rsplit(".", 1)[-1]
            for n in ast.walk(value) if isinstance(n, ast.Call)
        }
        flat = []
        for t in targets:
            flat.extend(
                t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            )
        for m in self.mirrors:
            if self.cls != m["cls"]:
                continue
            hit = ops & set(m["device_ops"])
            if not hit:
                continue
            for t in flat:
                token = _dotted(t)
                parts = token.split(".")
                if (parts[0] == "self" and len(parts) == 2
                        and parts[1] in m["device_state"]):
                    self.cur.device_writes.append(
                        (parts[1], sorted(hit)[0], lineno)
                    )

    def visit_Assign(self, node):
        # declared lock?  (class attr in a method, or module level)
        kind = self._contains_lock_ctor(node.value)
        for t in node.targets:
            token = _dotted(t)
            if kind and token:
                key = self._lock_key(token, any_name=True)
                if key:
                    self.inv.locks[key] = {
                        "reentrant": kind == "RLock",
                        "site": f"{self.relpath}:{node.lineno}",
                    }
            # singleton registries for call resolution
            ctor = self._instance_cls_token(node.value)
            if ctor and token:
                if not self.fn_stack and not self.cls_stack:
                    self.mod.instances[token] = ctor
                elif token.startswith("self.") and self.cls:
                    self.mod.attr_instances[
                        (self.cls, token.split(".")[1])
                    ] = ctor
            # sys.excepthook = fn  — a signal-path entry
            if token == "sys.excepthook":
                self._register_entry(
                    "signal", _dotted(node.value), node.lineno
                )
            self._record_write(t, node.lineno, node.value)
        self._check_device_write(node.targets, node.value, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._record_write(node.target, node.lineno, node.value)
        self.visit(node.value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._record_write(node.target, node.lineno, node.value)
            self._check_device_write(
                [node.target], node.value, node.lineno
            )
            self.visit(node.value)

    # ------------------------------------------------------------- locks

    def _as_lock(self, token: str) -> str | None:
        """A with/acquire target counts as a lock when its name reads
        like one, or when it was already declared as one."""
        key = self._lock_key(token)
        if key:
            return key
        key = self._lock_key(token, any_name=True)
        return key if key in self.inv.locks else None

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                self.visit(expr)       # a call makes a fresh CM, not a lock
                continue
            token = _dotted(expr)
            key = self._as_lock(token) if token else None
            if key and self.cur is not None:
                self.cur.acquires.append(
                    (key, node.lineno, frozenset(self.held))
                )
                self.held.append(key)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    visit_AsyncWith = visit_With

    # ------------------------------------------------------------- calls

    def _blocking_check(self, node: ast.Call, name: str):
        """join()/wait()/get() with neither a positional timeout nor a
        timeout kwarg blocks forever; str.join/dict.get style calls
        carry positional args and read as bounded."""
        kwargs = {k.arg for k in node.keywords}
        bounded = bool(node.args) or bool(kwargs & _TIMEOUT_KWARGS)
        if kwargs and not kwargs - {"block"}:
            bounded = False                     # q.get(block=True)
        self.cur.blocking.append(
            (f"{_dotted(node.func)}()", node.lineno, bounded)
        )

    def visit_Call(self, node):
        token = _dotted(node.func)
        last = token.rsplit(".", 1)[-1]
        kw = {k.arg: k.value for k in node.keywords}
        if self.cur is not None and token:
            self.cur.calls.append(
                (token, node.lineno, frozenset(self.held))
            )
        # --- execution-context registrations ---
        if last == "Thread" and "target" in kw:
            self._register_entry(
                "thread", _dotted(kw["target"]), node.lineno
            )
        elif token == "signal.signal" and len(node.args) == 2:
            self._register_entry(
                "signal", _dotted(node.args[1]), node.lineno
            )
        elif token == "atexit.register" and node.args:
            self._register_entry(
                "atexit", _dotted(node.args[0]), node.lineno
            )
        elif last == "register_shutdown" and node.args:
            # flight shutdown hooks run inside the excepthook/SIGTERM
            # handlers AND the atexit pass — both labels apply
            self._register_entry(
                "shutdown", _dotted(node.args[0]), node.lineno
            )
        # --- blocking + lock.acquire() + mutator writes ---
        if self.cur is not None:
            if last in _BLOCKING_NAMES and isinstance(
                node.func, ast.Attribute
            ):
                self._blocking_check(node, last)
            elif token == "input":
                self.cur.blocking.append(("input()", node.lineno, False))
            if last == "acquire":
                base = token.rsplit(".", 1)[0]
                key = self._as_lock(base) if base else None
                if key:
                    self.cur.acquires.append(
                        (key, node.lineno, frozenset(self.held))
                    )
            parts = token.split(".")
            if (parts[0] == "self" and len(parts) == 3
                    and parts[2] in _MUTATORS):
                self._record_write(
                    ast.parse(f"self.{parts[1]}", mode="eval").body,
                    node.lineno, None,
                )
        self.generic_visit(node)


# ------------------------------------------------------------- resolution


def _module_relpath(dotted: str) -> str:
    """``ddl25spring_tpu_torch.obs.recorder`` -> its root-relative file."""
    return dotted.replace(".", "/") + ".py"


class _Resolver:
    def __init__(self, inv: Inventory):
        self.inv = inv

    def _class_methods(self, mod: _Module, cls_token: str) -> dict | None:
        """Methods of the class a ctor token names, following one
        ``from x import Cls`` hop."""
        last = cls_token.rsplit(".", 1)[-1]
        if last in mod.classes:
            return mod.classes[last]
        imp = mod.imports.get(last)
        if imp:
            target = self.inv.modules.get(_module_relpath(imp[0]))
            if target and (imp[1] or last) in target.classes:
                return target.classes[imp[1] or last]
        return None

    def resolve(self, caller: _Func, token: str) -> str | None:
        """Call token -> fid, or None (conservatively unresolved)."""
        mod = self.inv.modules[caller.relpath]
        parts = token.split(".")
        if len(parts) == 1:
            name = parts[0]
            if name in caller.nested:
                return caller.nested[name]
            if name in mod.funcs:
                return mod.funcs[name]
            if name in mod.classes:
                return mod.classes[name].get("__init__")
            imp = mod.imports.get(name)
            if imp and imp[1]:
                target = self.inv.modules.get(_module_relpath(imp[0]))
                if target:
                    if imp[1] in target.funcs:
                        return target.funcs[imp[1]]
                    meths = target.classes.get(imp[1])
                    if meths:
                        return meths.get("__init__")
            return None
        if parts[0] == "self" and caller.cls:
            if len(parts) == 2:
                return mod.classes.get(caller.cls, {}).get(parts[1])
            if len(parts) == 3:
                ctor = mod.attr_instances.get((caller.cls, parts[1]))
                if ctor:
                    meths = self._class_methods(mod, ctor)
                    if meths:
                        return meths.get(parts[2])
            return None
        if len(parts) == 2:
            base, meth = parts
            ctor = mod.instances.get(base)
            if ctor:
                meths = self._class_methods(mod, ctor)
                if meths:
                    return meths.get(meth)
            imp = mod.imports.get(base)
            if imp and imp[1]:                  # from m import flight
                target = self.inv.modules.get(_module_relpath(imp[0]))
                if target and imp[1] in target.instances:
                    meths = self._class_methods(
                        target, target.instances[imp[1]]
                    )
                    if meths:
                        return meths.get(meth)
        return None


def _analyze(inv: Inventory) -> dict[str, Any]:
    """Pass 2: resolve calls and entries, then compute the three fixed
    points the rules need — execution contexts (caller->callee union),
    inherited locks (callee <- intersection over call sites), and
    transitive lock-acquisition sets."""
    res = _Resolver(inv)
    edges: dict[str, list] = {}        # caller fid -> [(callee, held)]
    callers: dict[str, list] = {}      # callee fid -> [(caller, held)]
    for fn in inv.funcs.values():
        for token, _lineno, held in fn.calls:
            callee = res.resolve(fn, token)
            if callee and callee in inv.funcs:
                edges.setdefault(fn.fid, []).append((callee, held))
                callers.setdefault(callee, []).append((fn.fid, held))

    # entry points: kind -> resolved fids
    entry_ctx: dict[str, set] = {}
    runtime_only: set = set()          # invoked only by the runtime
    for kind, relpath, cls, owner_fid, token, _lineno in inv.entries:
        owner = inv.funcs.get(owner_fid) if owner_fid else None
        fid = None
        if owner is not None:
            fid = res.resolve(owner, token)
        if fid is None:
            mod = inv.modules.get(relpath)
            parts = token.split(".")
            if mod is not None:
                if parts[0] == "self" and cls and len(parts) == 2:
                    fid = mod.classes.get(cls, {}).get(parts[1])
                elif len(parts) == 1:
                    fid = mod.funcs.get(parts[0])
        if fid is None or fid not in inv.funcs:
            continue
        short = inv.funcs[fid].qual
        label = {"thread": f"thread:{short}",
                 "signal": f"signal:{short}",
                 "shutdown": f"signal:{short}",
                 "atexit": f"atexit:{short}"}[kind]
        entry_ctx.setdefault(fid, set()).add(label)
        if kind in ("thread", "signal"):
            # Thread targets and raw signal handlers are invoked by the
            # runtime only; registered hooks (shutdown/atexit) are
            # ordinary methods client code also calls -> they keep a
            # "main" seed via the no-caller rule below.
            runtime_only.add(fid)

    # ---- contexts: union over callers, to a fixed point
    ctx: dict[str, set] = {fid: set() for fid in inv.funcs}
    for fid, labels in entry_ctx.items():
        ctx[fid] |= labels
    for fid in inv.funcs:
        if fid not in runtime_only and not callers.get(fid):
            ctx[fid].add("main")
    changed = True
    while changed:
        changed = False
        for fid, cs in callers.items():
            add = set()
            for caller, _held in cs:
                add |= ctx[caller]
            if not add <= ctx[fid]:
                ctx[fid] |= add
                changed = True
    for fid in inv.funcs:
        if not ctx[fid]:
            ctx[fid] = {"main"}

    # ---- inherited locks: intersection over call sites (entries: none)
    all_keys = set(inv.locks)
    for fn in inv.funcs.values():
        for key, *_ in fn.acquires:
            all_keys.add(key)
    inh: dict[str, set] = {}
    for fid in inv.funcs:
        if fid in entry_ctx or not callers.get(fid):
            inh[fid] = set()
        else:
            inh[fid] = set(all_keys)
    changed = True
    while changed:
        changed = False
        for fid, cs in callers.items():
            if fid in entry_ctx:
                continue
            meet = None
            for caller, held in cs:
                site = inh[caller] | set(held)
                meet = site if meet is None else meet & site
            meet = meet or set()
            if meet != inh[fid]:
                inh[fid] = meet
                changed = True

    # ---- transitive acquires (for cross-function S202 edges)
    acq: dict[str, set] = {
        fid: {k for k, *_ in fn.acquires}
        for fid, fn in inv.funcs.items()
    }
    changed = True
    while changed:
        changed = False
        for fid, es in edges.items():
            for callee, _held in es:
                if not acq[callee] <= acq[fid]:
                    acq[fid] |= acq[callee]
                    changed = True

    return {"edges": edges, "callers": callers, "ctx": ctx,
            "inherited": inh, "trans_acquires": acq}


# ------------------------------------------------------------------ rules


def _emit(findings, rule, severity, relpath, lineno, op, message,
          fix_hint):
    findings.append(Finding(
        rule=rule, severity=severity, message=message,
        source=f"{relpath}:{lineno}", op=op, fix_hint=fix_hint,
    ))


def _rule_s201(inv, info, findings):
    # attr key -> write sites [(fn, lineno, effective locks, ctx set)]
    sites: dict[tuple, list] = {}
    for fn in inv.funcs.values():
        if fn.name == "__init__":
            continue                    # construction happens-before
        eff_base = info["inherited"][fn.fid]
        for attr, lineno, held in fn.writes:
            key = (fn.relpath, fn.cls or "<module>", attr)
            sites.setdefault(key, []).append(
                (fn, lineno, set(held) | eff_base, info["ctx"][fn.fid])
            )
    for (relpath, cls, attr), ws in sorted(sites.items()):
        contexts = set()
        for _fn, _lineno, _locks, cset in ws:
            contexts |= cset
        if len(contexts) < 2:
            continue
        common = None
        for _fn, _lineno, locks, _cset in ws:
            common = set(locks) if common is None else common & locks
        if common:
            continue
        where = ", ".join(
            f"{fn.qual}:{lineno}" for fn, lineno, _l, _c in ws[:4]
        )
        _emit(
            findings, "S201", "error", relpath, ws[0][1],
            f"{cls}.{attr}",
            f"{cls}.{attr} is written from {len(contexts)} execution "
            f"contexts ({', '.join(sorted(contexts))}) at {where} with "
            "no common lock held at every write",
            "guard every write with one shared lock (held at the write "
            "site, not across blocking calls), or confine the "
            "attribute to a single context",
        )


def _rule_s202(inv, info, findings):
    # edge held -> acquired, with a witness site per edge
    edge_witness: dict[tuple, str] = {}

    def add(a, b, site):
        if a != b:
            edge_witness.setdefault((a, b), site)

    res = _Resolver(inv)
    for fn in inv.funcs.values():
        for key, lineno, held in fn.acquires:
            for h in held:
                add(h, key, f"{fn.relpath}:{lineno}")
        for token, lineno, held in fn.calls:
            if not held:
                continue
            callee = res.resolve(fn, token)
            if callee and callee in inv.funcs:
                for k in info["trans_acquires"][callee]:
                    for h in held:
                        add(h, k, f"{fn.relpath}:{lineno}")

    graph: dict[str, set] = {}
    for (a, b) in edge_witness:
        graph.setdefault(a, set()).add(b)
    seen_cycles = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    names = " -> ".join(
                        [*(p.split("::")[-1] for p in path),
                         start.split("::")[-1]]
                    )
                    witness = edge_witness[(path[0], path[1])] if len(
                        path
                    ) > 1 else edge_witness[(start, start)]
                    rel, lineno = witness.rsplit(":", 1)
                    _emit(
                        findings, "S202", "error", rel, int(lineno),
                        names,
                        f"lock-order inversion: {names} — two paths "
                        "acquire these locks in opposite orders, a "
                        "deadlock when the contexts interleave",
                        "pick one global acquisition order (document "
                        "it where the locks are declared) and release "
                        "before calling into the other subsystem",
                    )
                elif nxt not in path:
                    stack.append((nxt, [*path, nxt]))


def _rule_s203(inv, info, findings):
    for fn in inv.funcs.values():
        labels = {c for c in info["ctx"][fn.fid]
                  if c.startswith("signal:")}
        if not labels:
            continue
        via = sorted(labels)[0]
        for key, lineno, _held in fn.acquires:
            decl = inv.locks.get(key)
            if decl is None or decl["reentrant"]:
                continue
            _emit(
                findings, "S203", "error", fn.relpath, lineno, fn.qual,
                f"{fn.qual} acquires non-reentrant lock "
                f"{key.split('::')[-1]} and is reachable from a "
                f"signal/excepthook path ({via}) — if the signal lands "
                "while the main thread holds it, the handler "
                "self-deadlocks",
                "declare the lock threading.RLock() (reentrancy on the "
                "crash path beats strictness), or keep the handler "
                "path lock-free",
            )
        for what, lineno, bounded in fn.blocking:
            if bounded or not what.startswith("input"):
                continue
            _emit(
                findings, "S203", "error", fn.relpath, lineno, fn.qual,
                f"{fn.qual} calls {what} on a signal/excepthook path "
                f"({via}) — blocking I/O inside a handler wedges the "
                "dying process",
                "handlers must only flush bounded state and exit",
            )


def _rule_s204(inv, info, findings):
    del info
    for fn in inv.funcs.values():
        for state, op, lineno in fn.device_writes:
            if fn.host_mirror_writes:
                continue
            contract = next(
                (m for m in inv.mirrors if m["cls"] == fn.cls), None
            )
            mirrors = ", ".join(contract["host_mirrors"]) if contract \
                else "<none>"
            _emit(
                findings, "S204", "error", fn.relpath, lineno, fn.qual,
                f"{fn.qual} mutates device state self.{state} via "
                f"{op}(...) without touching any host mirror "
                f"({mirrors}) in the same method — the host page "
                "accounting silently drifts from the device refcounts",
                "update the host-side twin in the same method, or "
                "waive with the reason the accounting is intentionally "
                "settled elsewhere",
            )


def _rule_s205(inv, info, findings):
    for fn in inv.funcs.values():
        labels = {
            c for c in info["ctx"][fn.fid]
            if c.startswith(("signal:", "atexit:"))
        }
        if not labels:
            continue
        via = sorted(labels)[0]
        for what, lineno, bounded in fn.blocking:
            if bounded or what.startswith("input"):
                continue
            _emit(
                findings, "S205", "warn", fn.relpath, lineno, fn.qual,
                f"{fn.qual} calls {what} with no timeout on a "
                f"shutdown/crash-dump path ({via}) — a wedged worker "
                "out-waits the scheduler's kill grace",
                "pass a timeout and handle the expired case (dump "
                "what is durable, name what is not)",
            )


# -------------------------------------------------------------- public API


def analyze_paths(
    paths: Iterable[str], root: str | None = None,
    mirrors: tuple = MIRRORS,
) -> tuple[Inventory, list[Finding]]:
    """Parse every file, build the cross-file inventory, run the rule
    pack.  Findings carry root-relative sources so waiver path globs
    stay portable."""
    root = os.path.abspath(root or os.getcwd())
    inv = Inventory(mirrors=mirrors)
    findings: list[Finding] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        rel = os.path.relpath(ap, root).replace(os.sep, "/")
        with open(ap) as f:
            text = f.read()
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                rule="S000", severity="error", op=rel,
                source=f"{rel}:{e.lineno or 0}",
                message=f"file does not parse: {e.msg}",
                fix_hint="fix the syntax error",
            ))
            continue
        _Walker(rel, inv, mirrors).visit(tree)
    info = _analyze(inv)
    for rule in (_rule_s201, _rule_s202, _rule_s203, _rule_s204,
                 _rule_s205):
        rule(inv, info, findings)
    findings.sort(key=lambda f: (f.rule, f.source or ""))
    return inv, findings


def lint_source(
    text: str, relpath: str, mirrors: tuple = MIRRORS,
) -> list[Finding]:
    """Single-source convenience (tests): lint one file's text alone
    under the given repo-relative path."""
    inv = Inventory(mirrors=mirrors)
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError as e:
        return [Finding(
            rule="S000", severity="error", op=relpath,
            source=f"{relpath}:{e.lineno or 0}",
            message=f"file does not parse: {e.msg}",
            fix_hint="fix the syntax error",
        )]
    rel = relpath.replace(os.sep, "/")
    _Walker(rel, inv, mirrors).visit(tree)
    info = _analyze(inv)
    findings: list[Finding] = []
    for rule in (_rule_s201, _rule_s202, _rule_s203, _rule_s204,
                 _rule_s205):
        rule(inv, info, findings)
    findings.sort(key=lambda f: (f.rule, f.source or ""))
    return findings


def host_scope_files(root: str) -> list[str]:
    """The files of :data:`_HOST_SCOPE` under ``root``: every module that
    owns threads, handlers or mirrors."""
    root = os.path.abspath(root)
    out: list[str] = []
    for scope in _HOST_SCOPE:
        ap = os.path.join(root, scope)
        if scope.endswith(".py"):
            if os.path.exists(ap):
                out.append(ap)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            out.extend(
                os.path.join(dirpath, f)
                for f in filenames if f.endswith(".py")
            )
    return sorted(out)


def lint_repo(
    root: str | None = None,
) -> tuple[Inventory, list[Finding]]:
    root = os.path.abspath(root or os.getcwd())
    return analyze_paths(host_scope_files(root), root)
