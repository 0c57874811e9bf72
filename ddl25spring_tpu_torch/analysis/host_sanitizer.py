"""Runtime lock-order sanitizer: dynamic confirmation of S202.

A static pass over the source judges what the AST *can* prove; this
module catches what only execution shows.  ``DDL25_SANITIZE=1`` (read
through ``utils.config``) arms it:

- **Lock-order recording.**  :func:`wrap_lock` wraps a declared lock in
  an :class:`OrderCheckedLock` that keeps a per-thread held stack and a
  global first-witness acquisition graph.  Acquiring B while holding A
  records the edge A->B; if a path B->...->A already exists, that is a
  live lock-order inversion (the S202 class) — recorded and raised.
  Re-acquiring a non-reentrant lock on the same thread — a signal
  handler re-entering the critical section it interrupted, which would
  otherwise hang silently — raises immediately with both stacks named.

The JAX package's third check, the serve engine's host/device page
mirror (``check_serve_mirror``), comes with the serving engine.

Zero-cost discipline: with the flag off (the default) ``wrap_lock``
returns the lock unchanged.  The sanitizer is host-side only; nothing
here touches a tensor.
"""

from __future__ import annotations

import threading
from typing import Any

from ddl25spring_tpu_torch.utils.config import env_flag

__all__ = [
    "SanitizerError", "OrderCheckedLock", "wrap_lock", "enabled",
    "violations", "reset",
]


class SanitizerError(AssertionError):
    """A concurrency invariant failed under DDL25_SANITIZE=1."""


def enabled() -> bool:
    return env_flag("DDL25_SANITIZE", False)


# global acquisition-order graph: (held name, acquired name) -> first
# witness "thread=<name>".  Guarded by its own private lock; the
# sanitizer must never deadlock the code it watches.
_graph_lock = threading.Lock()
_edges: dict[tuple[str, str], str] = {}
_violations: list[dict] = []
_tls = threading.local()


def _held_stack() -> list[str]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _path_exists(src: str, dst: str, edges) -> bool:
    seen, stack = set(), [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(b for (a, b) in edges if a == node)
    return False


def violations() -> list[dict]:
    with _graph_lock:
        return [dict(v) for v in _violations]


def reset() -> None:
    """Clear the recorded graph and violations (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _violations.clear()


def _record_violation(kind: str, **info) -> dict:
    v = {"kind": kind, **info}
    with _graph_lock:
        _violations.append(v)
    return v


class OrderCheckedLock:
    """Order-recording proxy around a ``threading.Lock``/``RLock``.

    Context-manager and acquire/release compatible; everything else
    proxies to the wrapped lock.  The proxy's bookkeeping runs BEFORE
    blocking on the inner lock, so a would-be deadlock is reported
    instead of hung."""

    def __init__(self, name: str, inner: Any):
        self.name = name
        self._inner = inner
        self._reentrant = "RLock" in type(inner).__name__

    def _pre_acquire(self) -> None:
        held = _held_stack()
        if not self._reentrant and self.name in held:
            v = _record_violation(
                "self_deadlock", lock=self.name,
                thread=threading.current_thread().name,
                held=list(held),
            )
            raise SanitizerError(
                f"sanitizer: non-reentrant lock {self.name!r} "
                f"re-acquired on thread "
                f"{threading.current_thread().name!r} while already "
                f"held ({v['held']}) — this would self-deadlock (a "
                "signal handler re-entering its own critical section); "
                "declare it RLock or keep the path lock-free"
            )
        me = threading.current_thread().name
        for h in held:
            if h == self.name:
                continue
            with _graph_lock:
                _edges.setdefault((h, self.name), f"thread={me}")
                inverted = _path_exists(self.name, h, list(_edges))
            if inverted:
                _record_violation(
                    "lock_order_inversion", held=h,
                    acquiring=self.name, thread=me,
                )
                raise SanitizerError(
                    f"sanitizer: lock-order inversion — acquiring "
                    f"{self.name!r} while holding {h!r}, but the "
                    f"recorded graph already orders {self.name!r} "
                    f"before {h!r}; two contexts interleaving here "
                    "deadlock"
                )

    def acquire(self, *a, **kw) -> bool:
        self._pre_acquire()
        got = self._inner.acquire(*a, **kw)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, item):
        return getattr(self._inner, item)


def wrap_lock(name: str, lock: Any) -> Any:
    """The declaration-site hook: returns ``lock`` untouched unless
    ``DDL25_SANITIZE=1`` (resolved here, at construction time)."""
    return OrderCheckedLock(name, lock) if enabled() else lock
