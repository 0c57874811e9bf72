"""Host-side span tracer emitting Chrome-trace / Perfetto-loadable JSON.

Nested wall-clock spans recorded on the host and written in the Chrome
Trace Event format — loadable in ``chrome://tracing`` /
https://ui.perfetto.dev without running a profiler.  Each span *also*
enters a ``torch.profiler.record_function`` and, when CUDA is initialised,
an NVTX range, so inside a :func:`~ddl25spring_tpu_torch.utils.tracing.
trace` the same spans appear in the card's trace beside the
kernels they launched.

Format: the JSON Object Format — ``{"traceEvents": [...], ...}`` — with
``"X"`` (complete) duration events carrying ``name``/``cat``/``ph``/
``ts``/``dur``/``pid``/``tid``/``args`` and ``"M"`` metadata events naming
the process/threads.  Timestamps are microseconds on a per-recorder
``perf_counter`` origin; the wall-clock anchor rides in ``otherData``.

Thread-safe: spans may open/close concurrently from loader worker threads
and the main loop; event appends are lock-protected and nesting is
per-thread (Chrome's stack-building uses ``tid``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator

from ddl25spring_tpu_torch.obs import state
from ddl25spring_tpu_torch.utils.tracing import annotate as _annotation


class SpanRecorder:
    """Collects nested host spans; serializes as Chrome trace JSON."""

    def __init__(self, process_name: str = "ddl25spring_tpu_torch"):
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()
        self.process_name = process_name
        self._named_tids: set[int] = set()
        self._emit_meta(
            {
                "name": "process_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": 0,
                "args": {"name": process_name},
            }
        )

    def _emit_meta(self, ev: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _ensure_thread_named(self, tid: int) -> None:
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": tid,
                "args": {"name": threading.current_thread().name},
            }
        )

    @contextmanager
    def span(self, name: str, cat: str = "host", **args: Any) -> Iterator[None]:
        """Record the block as one complete ("X") event; also annotate the
        real profiler timeline when one is active."""
        tid = threading.get_ident()
        ts = self._now_us()
        with _annotation(name):
            try:
                yield
            finally:
                dur = self._now_us() - ts
                with self._lock:
                    self._ensure_thread_named(tid)
                    self._events.append(
                        {
                            "name": name,
                            "cat": cat,
                            "ph": "X",
                            "ts": ts,
                            "dur": dur,
                            "pid": os.getpid(),
                            "tid": tid,
                            **({"args": args} if args else {}),
                        }
                    )

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """A zero-duration marker ("i" instant event, thread scope)."""
        tid = threading.get_ident()
        with self._lock:
            self._ensure_thread_named(tid)
            self._events.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "i",
                    "s": "t",
                    "ts": self._now_us(),
                    "pid": os.getpid(),
                    "tid": tid,
                    **({"args": args} if args else {}),
                }
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome_trace(self) -> dict[str, Any]:
        with self._lock:
            events = list(self._events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "process_name": self.process_name,
                "time_origin_unix_s": self._t0_unix,
            },
        }

    def save(self, path: str) -> str:
        """Write the trace JSON; returns the path (load it in Perfetto)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


_default = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _default


def set_recorder(rec: SpanRecorder) -> SpanRecorder:
    """Install a fresh recorder (e.g. one per run dir); returns the old."""
    global _default
    prev, _default = _default, rec
    return prev


def span(name: str, cat: str = "host", **args: Any):
    """Module-level convenience on the default recorder.  A no-op context
    when telemetry is disabled — call sites need no guard."""
    if not state.enabled():
        return nullcontext()
    return _default.span(name, cat=cat, **args)


def instant(name: str, **args: Any) -> None:
    if state.enabled():
        _default.instant(name, **args)
