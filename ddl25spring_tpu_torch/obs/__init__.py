"""Run telemetry of the PyTorch port: the counterpart of the JAX package's
``obs/`` core, with the same names and file formats.

- :mod:`~ddl25spring_tpu_torch.obs.spans` — host-side nested span tracer
  producing Chrome-trace/Perfetto JSON, each span mirrored into
  ``torch.profiler.record_function`` and an NVTX range so it shows in the
  card's trace (:func:`~ddl25spring_tpu_torch.utils.tracing.trace`);
- :mod:`~ddl25spring_tpu_torch.obs.logger` — append-only JSONL step
  metrics with a run-metadata header (grid, layout, git sha, torch and
  CUDA versions, the card's name and power limit);
- :mod:`~ddl25spring_tpu_torch.obs.counters` — values from inside the
  train steps (losses, gradient norms, the MoE router's load balance,
  the pipeline's tick cadence, ZeRO's collective bytes), copied from the
  card without a sync and folded when they land.

Runtime health:

- :mod:`~ddl25spring_tpu_torch.obs.sentinels` — in-step numerics
  sentinels (loss / gradient global norm / non-finite leaves / update
  ratio computed on the card; policy log/halt/skip on violation; gated
  by ``DDL25_SENTINELS``, the same op sequence as an unguarded step when
  disabled);
- :mod:`~ddl25spring_tpu_torch.obs.recorder` — crash-surviving flight
  recorder (ring buffer of the last N step records, dumped as
  ``flight.json`` on unhandled exception / SIGTERM / atexit);
- :mod:`~ddl25spring_tpu_torch.obs.watchdog` — stall watchdog (fires when
  no step completes within a deadline; dumps all host thread stacks plus
  the flight record);
- :mod:`~ddl25spring_tpu_torch.obs.timeline` — the unified run timeline
  (typed append-only ``timeline.jsonl``), merged with the spans and the
  flight ring into one Perfetto trace by ``tools/trace_export.py``.

Measurement and the run report:

- :mod:`~ddl25spring_tpu_torch.obs.perfscope` — measured perf records of a
  step (barriered p50/p95, the compute-only counterfactual, measured MFU)
  and the JSONL ledger ``tools/perf_report.py`` gates;
- :mod:`~ddl25spring_tpu_torch.obs.memscope` — live bytes and host RSS per
  step or tick, the growth detector, the budget band, the KV pool's optics
  and the ``mem`` record ``tools/mem_report.py`` gates;
- :mod:`~ddl25spring_tpu_torch.obs.goodput` — the run's wall split into
  useful and badput buckets, serving SLO attainment, the ``goodput``
  record ``tools/goodput_report.py`` gates;
- :mod:`~ddl25spring_tpu_torch.obs.report` — ``summarize_run`` /
  ``format_report`` over a run directory, and its CLI
  (``python -m ddl25spring_tpu_torch.obs.report RUN_DIR``).

Everything is gated by one flag read when a step is BUILT
(:mod:`~ddl25spring_tpu_torch.obs.state`): disabled (the default), a
built step runs exactly the operations of an uninstrumented one.  Enable
with ``DDL25_OBS=1`` or ``obs.enable()`` *before* building the step.
"""

from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.obs.counters import (
    CounterSet,
    counters,
    gpipe_bubble_fraction,
)
from ddl25spring_tpu_torch.obs.recorder import FlightRecorder, flight
from ddl25spring_tpu_torch.obs.sentinels import SentinelViolation
from ddl25spring_tpu_torch.obs.watchdog import StallWatchdog, thread_stacks
from ddl25spring_tpu_torch.obs.logger import (
    MetricsLogger,
    iter_jsonl,
    read_jsonl,
    run_metadata,
)
from ddl25spring_tpu_torch.obs.spans import (
    SpanRecorder,
    get_recorder,
    instant,
    set_recorder,
    span,
)
from ddl25spring_tpu_torch.obs.state import enable, enabled, scoped
from ddl25spring_tpu_torch.obs.timeline import Timeline, timeline
from ddl25spring_tpu_torch.obs import goodput, memscope, perfscope  # noqa: E402,F401

__all__ = [
    "CounterSet",
    "FlightRecorder",
    "MetricsLogger",
    "SentinelViolation",
    "SpanRecorder",
    "StallWatchdog",
    "Timeline",
    "timeline",
    "counters",
    "flight",
    "sentinels",
    "thread_stacks",
    "enable",
    "enabled",
    "get_recorder",
    "gpipe_bubble_fraction",
    "instant",
    "iter_jsonl",
    "read_jsonl",
    "run_metadata",
    "scoped",
    "set_recorder",
    "span",
]
