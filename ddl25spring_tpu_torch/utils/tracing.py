"""Tracing / profiling hooks: the counterpart of the JAX package's
``utils/tracing.py``.

- :func:`trace` — a ``torch.profiler`` run over the CPU and, when
  there is one, the card, writing a Chrome trace (``trace.json``) into
  ``log_dir``: the kernels the block launched, beside the host's ops and
  the :mod:`~ddl25spring_tpu_torch.obs.spans` of the block;
- :func:`annotate` — a named region that shows in that trace
  (``record_function``, and an NVTX range on the card);
- :class:`StepTimer` — steady-state steps/sec with correct asynchronous
  launch handling (waits for the card before each tick, discards warmup).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator

import torch

TRACE_BASENAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: bool | None = None) -> Iterator[Any]:
    """Profile everything inside the block with ``torch.profiler`` (CPU
    activities, and CUDA ones when ``cuda`` — default: a card is there)
    and write the Chrome trace to ``log_dir/trace.json`` when the block
    ends.  Yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_BASENAME))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region (context manager) visible in profiler traces: a
    ``record_function``, and an NVTX range once CUDA is initialised."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def _wait(result: Any) -> None:
    """Wait until the card has produced ``result`` (every tensor in it)."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            torch.cuda.current_stream(result.device).synchronize()
    elif isinstance(result, dict):
        for v in result.values():
            _wait(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _wait(v)


class StepTimer:
    """Throughput meter for train loops.

    ``tick(result)`` waits until ``result`` is ready (so asynchronous
    launches don't fold the next step's work into this step's time) and
    records the interval.  The first ``warmup`` intervals (builds, cuDNN's
    search) are discarded.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None
        self._seen = 0

    def tick(self, result: Any = None) -> None:
        if result is not None:
            _wait(result)
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    def _require_times(self) -> list[float]:
        if not self.times:
            raise ValueError("no timed steps yet (all in warmup?)")
        return self.times

    @property
    def mean_step_s(self) -> float:
        times = self._require_times()
        return sum(times) / len(times)

    def percentile(self, q: float) -> float:
        """q-th percentile (0-100) of the recorded step intervals."""
        times = sorted(self._require_times())
        if len(times) == 1:
            return times[0]
        # linear interpolation between closest ranks (numpy default)
        pos = (len(times) - 1) * q / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(times) - 1)
        return times[lo] + (times[hi] - times[lo]) * (pos - lo)

    @property
    def p50_step_s(self) -> float:
        return self.percentile(50)

    @property
    def p95_step_s(self) -> float:
        return self.percentile(95)

    @property
    def min_step_s(self) -> float:
        return min(self._require_times())

    def steps_per_sec(self) -> float:
        """Steady-state rate from the MEDIAN interval: one GC pause or
        host hiccup in the window must not skew a report line (the mean
        remains available as ``mean_step_s``)."""
        return 1.0 / self.p50_step_s
