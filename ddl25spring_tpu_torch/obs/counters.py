"""Named counters fed from inside train steps, and the static facts of a
step's layout.

The JAX package surfaces values that live inside a compiled step — the
loss, the gradient norm, the MoE router's load balance — through
``jax.debug.callback``.  In the port those values are tensors on the card,
and reading one with ``.item()`` would wait for the card in every step.
:meth:`CounterSet.emit` therefore copies the value into a pinned host slot
without blocking and records a CUDA event; the value is folded into its
named accumulator once the event is done — at the next emit, or at
:meth:`CounterSet.flush` / :meth:`~CounterSet.snapshot` / :meth:`~CounterSet.
save`.  A CPU tensor folds at once.  :meth:`CounterSet.mark` records
``(index, host time)`` when it is called: the pipeline executor marks each
action as it issues it, so the tick cadence is the host's, not the card's.

Zero cost when disabled: the builders decide when they build a step
whether to call any of this (``instrument=None`` follows
:func:`~ddl25spring_tpu_torch.obs.state.enabled`), and ``emit``/``mark``
themselves do nothing unless telemetry is on or ``force`` is given.

Static facts that are known when the step is built — the bytes ZeRO
gathers per step, the pipeline's shape — go through :meth:`add_static`.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any

import torch

from ddl25spring_tpu_torch.obs import state


class CounterSet:
    """Named host-side accumulators fed from the train steps."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scalars: dict[str, dict[str, float]] = {}
        self._series: dict[str, list[tuple[float, float]]] = {}
        self._static: dict[str, Any] = {}
        self._pending: deque = deque()  # (names, pinned host values, event)
        self._t0 = time.perf_counter()

    # ---- host-side ------------------------------------------------------
    def add(self, name: str, value: float) -> None:
        """Fold ``value`` into the named scalar accumulator (host call)."""
        v = float(value)
        if math.isnan(v):
            return
        with self._lock:
            s = self._scalars.setdefault(
                name,
                {"sum": 0.0, "count": 0.0, "min": math.inf, "max": -math.inf},
            )
            s["sum"] += v
            s["count"] += 1
            s["last"] = v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)

    def observe(self, name: str, index: float) -> None:
        """Append ``(index, host wall time)`` to the named series."""
        t = time.perf_counter() - self._t0
        with self._lock:
            self._series.setdefault(name, []).append((float(index), t))

    def add_static(self, name: str, value: Any) -> None:
        """Record a build-time fact (idempotent per name: last write wins —
        rebuilding a step re-records the same value)."""
        with self._lock:
            self._static[name] = value

    # ---- from inside a step ---------------------------------------------
    def emit(self, name: str, value, force: bool = False) -> None:
        """Accumulate ``value`` (a 0-dim tensor or a number) into ``name``.
        Does nothing when telemetry is disabled, unless ``force`` — the
        builders pass it, so an explicit ``instrument=True`` (or the flag
        as it was when the step was built) wins over the flag's state now."""
        if force or state.enabled():
            self.emit_many({name: value}, force=True)

    def emit_many(self, values: dict, force: bool = False) -> None:
        """:meth:`emit` of several values: the card's in one stacked tensor,
        one copy to the host and one event."""
        if not (force or state.enabled()):
            return
        on_card = {}
        for name, v in values.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                on_card[name] = v
            else:
                self.add(name, float(v))
        if not on_card:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"counters.emit of {sorted(on_card)} inside a CUDA graph capture: "
                "an emit copies to the host once per call, which a replay would not "
                "repeat; build the captured step with instrument=False")
        stacked = torch.stack([v.detach().float().reshape(()) for v in on_card.values()])
        host = torch.empty(stacked.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        with self._lock:
            self._pending.append((list(on_card), host, event))
        self.flush(block=False)

    def mark(self, name: str, index, force: bool = False) -> None:
        """Record the host time at which the caller reached ``index`` (e.g.
        the pipeline executor's action counter) into the named series.  Does
        nothing when disabled unless ``force`` (see :meth:`emit`)."""
        if force or state.enabled():
            self.observe(name, float(index))

    def flush(self, block: bool = True) -> None:
        """Fold the values whose copies have reached the host, in emit
        order; with ``block``, wait for all of them."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                names, host, event = self._pending[0]
                if not block and not event.query():
                    return
                self._pending.popleft()
            event.synchronize()
            for name, v in zip(names, host.tolist()):
                self.add(name, v)

    # ---- export ---------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        self.flush()
        with self._lock:
            scalars = {
                n: dict(
                    s,
                    mean=(s["sum"] / s["count"]) if s["count"] else None,
                )
                for n, s in self._scalars.items()
            }
            return {
                "scalars": scalars,
                "series": {n: list(v) for n, v in self._series.items()},
                "static": dict(self._static),
            }

    def save(self, run_dir: str, filename: str = "counters.json") -> str:
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, filename)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def reset(self) -> None:
        with self._lock:
            self._scalars.clear()
            self._series.clear()
            self._static.clear()
            self._pending.clear()
            self._t0 = time.perf_counter()


counters = CounterSet()


def gpipe_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """The GPipe schedule's idle fraction ``(S-1)/(M+S-1)`` (the schedule
    runs ``M+S-1`` ticks of which ``S-1`` are fill/drain per stage) —
    the analytic anchor the measured tick cadence is compared against."""
    s, m = int(num_stages), int(num_microbatches)
    if s <= 1:
        return 0.0
    return (s - 1) / (m + s - 1)
