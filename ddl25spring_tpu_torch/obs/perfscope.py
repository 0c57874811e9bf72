"""Steady-state perf measurement and the cross-run regression ledger: the
bench half of the JAX package's ``obs/perfscope.py``.

For a step it produces a **measured perf record**:

(a) *step wall time* -- warmed p50/p95/min over K reps, each rep barriered
    by ``torch.cuda.synchronize`` on the card (the JAX package's
    ``block_until_ready``), so a wall covers exactly one dispatch's work;
(b) *compute-only counterfactual* -- the same step without any
    cross-device traffic: on one card the measured step has none, so it is
    simply timed again; on more ranks the bench's one-card twin
    (:func:`~ddl25spring_tpu_torch.benchmarks.build_compute_counterfactual`).

From these: **exposed-comms time** (step - compute) and **measured MFU**
(FLOPs / (wall x chip peak x chips)), with the peak from
:func:`~ddl25spring_tpu_torch.utils.flops.host_peak_spec` (the data sheet
on a card, the calibrated ``cpu-host`` pseudo-chip on the CPU).  FLOPs come
from :func:`~ddl25spring_tpu_torch.utils.flops.count_flops`, not XLA's
cost analysis.

Not here yet (ROADMAP A12, which brings the ``describe()`` registry and the
trace analyzers): the per-collective micro-costs (``micro`` is ``[]``, so
``overlap_eff`` is None), the roofline projection (``projected_mfu``,
``projected_bound`` and ``projection_err`` are None), and the
registry-driven :func:`measure_strategy` and its CLI.

Records append to :data:`DEFAULT_LEDGER` (``runs/torch_perf_ledger.jsonl``,
the port's own and git-ignored: ``runs/perf_ledger.jsonl`` is the JAX
package's tracked trend file) keyed by (strategy, mesh, host fingerprint)
with the git sha; ``tools/perf_report.py`` renders per-key
trend tables and ``--check`` gates regressions.  Compare trends on ONE host
(the key holds the fingerprint), never across machines.
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Any

DEFAULT_LEDGER = os.path.join("runs", "torch_perf_ledger.jsonl")
PERF_BASENAME = "perf.json"

#: why the analytics half of a record is empty
A12_NOTE = ("no roofline projection or collective micro-costs yet: they need the "
            "describe() registry and the trace analyzers (ROADMAP A12)")


def host_fingerprint(device=None, kind: str | None = None) -> str:
    """Identity of the measuring machine and device -- part of the ledger
    key, so one host's trend never gates another's.  ``kind`` names the
    device without asking torch (a retry parent, which makes no CUDA
    context, takes its child's card name)."""
    if kind is None:
        import torch

        from ddl25spring_tpu_torch.utils.flops import _device

        dev = _device(device)
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{platform.node()}/{os.cpu_count()}cpu/{kind}"


def _pct(xs: list[float], q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _barrier(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ step timing


def measure_step(fn: Any, args: tuple, *, reps: int = 10, warmup: int = 3,
                 rebind: bool = False, return_args: bool = False, device=None):
    """Warmed, barriered wall times of ``reps`` calls of ``fn(*args)``.

    ``rebind=True`` treats ``fn`` as a train step whose first two outputs
    replace ``args[0:2]`` each call (the steady-state loop of a step that
    returns its state).  Each rep ends with ``torch.cuda.synchronize`` when
    ``device`` is a card.  Returns ``{"reps", "warmup", "step_s_p50",
    "step_s_p95", "step_s_min", "times_s"}``; with ``return_args=True``,
    ``(stats, final_args)``."""
    a = tuple(args)

    def call(a):
        out = fn(*a)
        _barrier(device)
        if rebind:
            a = (out[0], out[1]) + a[2:]
        return a

    for _ in range(max(warmup, 1)):  # >= 1: the first call builds
        a = call(a)
    times: list[float] = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        a = call(a)
        times.append(time.perf_counter() - t0)
    stats = {
        "reps": len(times),
        "warmup": warmup,
        "step_s_p50": _pct(times, 50),
        "step_s_p95": _pct(times, 95),
        "step_s_min": min(times),
        "times_s": [round(t, 6) for t in times],
    }
    return (stats, a) if return_args else stats


# --------------------------------------------------------- record building


def build_record(*, strategy: str, mesh_axes: dict[str, int] | None, n_chips: int,
                 step: dict[str, Any], compute: dict[str, Any] | None = None,
                 compute_error: str | None = None, micro: list[dict[str, Any]] | None = None,
                 flops: float | None = None, bytes_accessed: float | None = None,
                 wire_bytes: float | None = None, device: Any = None,
                 extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Assemble one ledger record from the measurements (every derived field
    None-safe: a missing ingredient nulls it, never fakes it).

    - ``exposed_comms_s = max(0, step_p50 - compute_p50)``;
    - ``overlap_eff = 1 - exposed / micro_total`` capped at 1.0, floor-free,
      None without costed collectives (always, until A12's micro-costs);
    - ``measured_mfu = flops / (step_p50 * n_chips * peak)``;
    - the projection fields are None (:data:`A12_NOTE`)."""
    import torch

    from ddl25spring_tpu_torch.obs.logger import git_sha
    from ddl25spring_tpu_torch.utils.flops import CPU_HOST_KIND, _device, host_peak_spec

    step_s = step["step_s_p50"]
    compute_s = compute["step_s_p50"] if compute else None
    exposed = max(0.0, step_s - compute_s) if compute_s is not None else None
    micro = micro or []
    costed = [m["t_total_s"] for m in micro if m.get("t_s") is not None]
    micro_total = sum(costed) if costed else 0.0
    overlap_eff = None
    if exposed is not None and micro_total > 0:
        overlap_eff = min(1.0, 1.0 - exposed / micro_total)

    kind, spec = host_peak_spec(device)
    peak = (spec or {}).get("peak_bf16_flops")
    measured_mfu = None
    if flops and peak and step_s > 0:
        measured_mfu = flops / (step_s * max(n_chips, 1) * peak)

    return {
        "record": "perf",
        "schema": 1,
        "ts": time.time(),
        "strategy": strategy,
        "mesh": mesh_axes,
        "n_chips": n_chips,
        "host": host_fingerprint(device),
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "backend": _device(device).type,
        "chip": kind,
        "peak_flops_per_chip": peak,
        "peak_source": (None if peak is None
                        else "calibrated-host" if kind == CPU_HOST_KIND else "datasheet"),
        "reps": step["reps"],
        "warmup": step["warmup"],
        "step_s_p50": step_s,
        "step_s_p95": step["step_s_p95"],
        "step_s_min": step["step_s_min"],
        "compute_s_p50": compute_s,
        **({"compute_error": compute_error} if compute_error else {}),
        "exposed_comms_s": exposed,
        "micro_total_s": micro_total,
        "overlap_eff": overlap_eff,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "wire_bytes": wire_bytes,
        "measured_mfu": measured_mfu,
        "projected_mfu": None,
        "projected_bound": None,
        "projection_err": None,
        "projection_note": A12_NOTE,
        "micro": micro,
        **(extra or {}),
    }


def perf_cell(record: dict[str, Any]) -> dict[str, Any]:
    """The compact ``telemetry.perf`` cell of a BENCH line (ms where a human
    reads it; the whole record stays in the ledger)."""

    def ms(key):
        v = record.get(key)
        return round(v * 1e3, 4) if v is not None else None

    return {
        "measured_mfu": record.get("measured_mfu"),
        "overlap_eff": record.get("overlap_eff"),
        "static_overlap_bound": record.get("static_overlap_bound"),
        "exposed_comms_ms": ms("exposed_comms_s"),
        "projection_err": record.get("projection_err"),
        "step_ms_p50": ms("step_s_p50"),
        "compute_ms_p50": ms("compute_s_p50"),
        "micro_total_ms": ms("micro_total_s"),
        "chip": record.get("chip"),
        "peak_source": record.get("peak_source"),
    }


def measure_callable(fn: Any, args: tuple, *, strategy: str, reps: int = 10,
                     warmup: int = 3, rebind: bool = False, flops: float | None = None,
                     n_chips: int = 1, device=None) -> dict[str, Any]:
    """Measure an arbitrary step (no mesh, no counterfactual) into a
    ledger-shaped record: the harness for ad-hoc steps and the gate's
    tests."""
    stats = measure_step(fn, args, reps=reps, warmup=warmup, rebind=rebind, device=device)
    return build_record(strategy=strategy, mesh_axes=None, n_chips=n_chips, step=stats,
                        flops=flops, device=device)


# ----------------------------------------------------- strategy measurement


def measure_strategy(name: str, *args: Any, **kwargs: Any):
    """The registry-driven pass (compile a ``describe()`` strategy, time it,
    micro-cost its collective inventory) -- needs the ``describe()``
    registry and the trace analyzers."""
    raise NotImplementedError(f"measure_strategy({name!r}): {A12_NOTE}")


def build_micro_benches(*args: Any, **kwargs: Any):
    """Standalone micro-benches of a collective inventory (A12)."""
    raise NotImplementedError(f"build_micro_benches: {A12_NOTE}")


def time_micro_benches(*args: Any, **kwargs: Any):
    """Timing of :func:`build_micro_benches`' benches (A12)."""
    raise NotImplementedError(f"time_micro_benches: {A12_NOTE}")


def micro_site_records(*args: Any, **kwargs: Any):
    """One measured-cost record per inventory site (A12)."""
    raise NotImplementedError(f"micro_site_records: {A12_NOTE}")


# ------------------------------------------------------- bench-step wiring


def measure_bench_step(step: Any, batch: Any, meta: dict[str, Any], *, reps: int = 8,
                       warmup: int = 2, per_chip_batch: int | None = None,
                       device=None) -> dict[str, Any]:
    """Perfscope over the LIVE bench train step ``step(batch)`` (it updates
    its own parameters and returns the loss): its FLOPs counted on one call
    (:func:`~ddl25spring_tpu_torch.utils.flops.count_flops`), then ``reps``
    barriered calls.

    The compute counterfactual: with one chip the measured step has no
    collective, so timing it again IS the compute-only run; with more, the
    ResNet config is rebuilt on one card at the same per-chip batch
    (:func:`~ddl25spring_tpu_torch.benchmarks.build_compute_counterfactual`)
    and timed the same way.  ``meta`` is the step builder's (``layout``,
    ``n_chips``, ``batch``), with ``mesh_axes`` (default ``{"data":
    n_chips}``)."""
    from ddl25spring_tpu_torch.utils.flops import count_flops

    n_chips = int(meta.get("n_chips") or 1)
    _, flops = count_flops(step, batch)
    flops = float(flops) if flops else None
    _barrier(device)
    step_stats = measure_step(step, (batch,), reps=reps, warmup=warmup, device=device)
    compute_stats = compute_error = None
    try:
        if n_chips == 1:
            compute_stats = measure_step(step, (batch,), reps=reps, warmup=1, device=device)
        else:
            import torch

            from ddl25spring_tpu_torch.benchmarks import build_compute_counterfactual

            pcb = per_chip_batch or int(meta["batch"]) // n_chips
            s1, _, _, _ = build_compute_counterfactual(pcb, device=device)
            dev = torch.device(device) if device is not None else None
            raw1 = (torch.zeros((pcb, 32, 32, 3), dtype=torch.uint8, device=dev),
                    torch.zeros((pcb,), dtype=torch.int64, device=dev))
            compute_stats = measure_step(s1, (raw1,), reps=reps, warmup=warmup, device=device)
    except (RuntimeError, ValueError) as e:  # the counterfactual never costs the step's record
        compute_error = f"{type(e).__name__}: {e}"
    return build_record(
        strategy=f"bench-{meta['layout']}", mesh_axes=meta.get("mesh_axes") or {"data": n_chips},
        n_chips=n_chips,
        step=step_stats, compute=compute_stats, compute_error=compute_error, micro=[],
        flops=flops, wire_bytes=0.0, device=device,
        extra={"batch": int(meta.get("batch", 0)) or None, "static_overlap_bound": None})


# ------------------------------------------------------------------ ledger


def append_ledger(record: dict[str, Any], path: str | None = None) -> str:
    """Append one record to the JSONL ledger (created on first use)."""
    path = path or DEFAULT_LEDGER
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    return path


def read_ledger(path: str | None = None) -> list[dict[str, Any]]:
    """Every parseable ``record: "perf"`` row, in append order.  A torn
    trailing line (killed mid-write) is skipped, never fatal."""
    path = path or DEFAULT_LEDGER
    out: list[dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("record") == "perf":
                out.append(rec)
    return out


def write_run_perf(record: dict[str, Any], run_dir: str) -> str:
    """``<run_dir>/perf.json``, atomically: what the report's performance
    section reads."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, PERF_BASENAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    """The registry CLI (``--strategy dp,...``) waits for A12."""
    raise NotImplementedError(f"python -m ddl25spring_tpu_torch.obs.perfscope: {A12_NOTE}")


if __name__ == "__main__":
    main()
