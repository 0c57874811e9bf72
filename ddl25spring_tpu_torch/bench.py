"""The port's bench entry: the two metrics ``BASELINE.json`` names, on one
JSON line, through the retry driver of the top-level ``bench.py``.

- The headline: ResNet-18/CIFAR-10 samples/s per card through
  ``lab.dp_pp --workload resnet`` (:func:`~ddl25spring_tpu_torch.lab.dp_pp.run_resnet`),
  whose ``report_line`` this line is.
- ``secondary``, in the JAX bench's order (:func:`~ddl25spring_tpu_torch.lab.
  dp_pp.resnet_secondaries`): the same device-resident input one step per
  dispatch (after a K-step primary), the native C++ loader streaming uint8
  batches through pinned buffers (``native-stream-uint8``, beside the
  link's measured ``h2d_mib_per_s``), one fixed device-resident batch, and
  the FedAvg round time of :func:`fedavg_secondary` (``bench.py:563-604``),
  whose failure becomes an error note and never costs the headline.

The ResNet run takes ``lab.dp_pp``'s defaults (batch 1024 per card, SGD lr
0.1, ``--input auto``), as the top-level bench takes its lab's: on one card
K train steps per dispatch, one CUDA graph each, with K by the JAX rule
(``bench.py:1086-1100``: the largest divisor of the epoch's batches up to
16, so 16 at batch 1024; 2 windows, 32 timed steps), and the line's input
reads ``hbm-resident-shuffle-scan16``; ``--scan-steps K`` sets K, and
``--scan-steps 1`` gives the per-step mode (30 timed steps).  The training
flags keep the JAX bench's meanings (``bench.py:621-649``):
``--per-chip-batch``, ``--steps``, ``--warmup``, ``--microbatches``,
``--stages S`` (the ``data x S`` heterogeneous pipeline, its ranks sharing
the card), ``--overlap`` (pure DP, layout ``dp-overlap``), ``--no-fedavg``;
``DDL25_BENCH_NTRAIN`` shrinks the ResNet split on the card and the FedAvg
split, as in JAX.

**The retry driver** (``bench.py:309-560``, ``:756-881``).  A run on the
card (or any run with ``DDL25_CHAOS`` armed) is a parent that never touches
the card: it re-executes ``python -m ddl25spring_tpu_torch.bench`` in fresh
children (``DDL25_BENCH_CHILD=1``, the lineage in ``DDL25_LINEAGE`` /
``DDL25_ATTEMPT``) until one prints a line without ``error``: at most
``--attempts`` children, each bounded by ``--child-timeout`` (its process
group killed past it), 60 s then 120 s apart (none after a preemption,
under armed chaos, or after the last attempt).  Every failed attempt writes
one ``bench_retry_failure`` JSONL record to stderr (:func:`classify_failure`'s
reason, the flight dump, the attempt's goodput facts), and the records ride
the final line's ``telemetry.retry_failures``.  A child first probes the
device (:func:`probe_devices`, bounded by ``--probe-timeout``); no card
prints the ``accelerator unreachable`` error line and never trains on the
CPU.  A CPU run without chaos runs in this process, one attempt.

**Resume.**  ``--save-every N`` checkpoints the primary phase every N
dispatches (the autosave, gated on the loss and the sentinels; armed chaos
turns on ``--save-every 2``) into ``--ckpt-dir`` (default ``<obs-dir>/ckpt``,
else ``runs/bench_ckpt``); after a death with a durable step the next child
gets ``--resume-from``, restores it, and the line's ``telemetry.resume``
names the steps it replayed and ``recovery_wall_s`` (process entry to
restored).  A fresh start wipes the checkpoint directory only when it is
recognisably the port's (its manifest, chaos journal or checkpoint step
directories) and refuses anything else (exit 2).  The resilient primary
lives in a run of one process: ``--stages S > 1`` (a world of ranks) with
``--save-every``, ``--resume-from`` or ``DDL25_CHAOS`` exits 2, and on a
host of several cards (a world of ranks too) the line's ``telemetry.resume``
says ``{"enabled": false}`` and why.  ``--elastic`` trains on a
world of 2 spawned ranks (on the card over gloo, or on the CPU) that answers
``device_loss@k`` / ``capacity_change@k:n`` by reshaping in the run
(:func:`~ddl25spring_tpu_torch.lab.dp_pp.elastic_resnet`).

Run: ``python -m ddl25spring_tpu_torch.bench [--device cuda] [--rounds 10]
[--n-train 60000] [--scan-steps K] [--attempts 3]``.  The last line of the
output is the record, with ``telemetry``:

- ``perf`` (``--perf-reps K``, default 8, 0 turns it off): the measured
  perf record of the live per-batch train step
  (:func:`~ddl25spring_tpu_torch.obs.perfscope.measure_bench_step`), its
  cell on the line, the record appended to ``--perf-ledger`` (default
  ``runs/torch_perf_ledger.jsonl``, git-ignored) for ``tools/perf_report.py``;
- ``goodput``: the run's wall split into buckets (the warm-up, the timed
  calls, checkpoint saves, replayed steps, recovery, the rest), appended as
  a ``record: "goodput"`` row; under the retry driver the lineage's view of
  every attempt (``obs.goodput.merge_lineage``);
- ``mem`` (with ``--obs-dir``): the live bytes sampled after each timed
  call against the first sample's, appended as a ``record: "mem"`` row;
- ``resume``, ``retry_failures``, ``health`` (with the flight dump and the
  failure's reason);
- ``flash_launches`` (top level): the flash-attention kernels this process
  launched or captured while the training bench ran, by kernel (the ResNet
  and FedAvg paths launch none);
- with ``--obs-dir DIR``: ``metrics.jsonl`` (one record per timed call),
  ``counters.json``, ``trace.json``, ``timeline.jsonl``, ``flight.json``,
  ``perf.json``, ``mem.json`` and ``goodput.json`` in DIR, and the phases of
  :func:`~ddl25spring_tpu_torch.obs.report.summarize_run` on the line
  (``python -m ddl25spring_tpu_torch.obs.report DIR`` renders the run).

The telemetry hooks reach a one-process run (one card, or the CPU); a world
of several ranks prints the headline with ``{"enabled": false}`` cells.
``--smoke`` shrinks the training run as the JAX bench's does: batch 64, 8
timed steps after 2 warm-up steps, one step per dispatch, 512 training
rows, no FedAvg, obs dir ``runs/bench_smoke`` (``--device`` stays as
given).

Serving mode (``bench.py:694-745``, ``:939-1000``): ``--serve`` runs the
continuous-batching LLaMA serving bench instead, in this process, one
attempt (:func:`~ddl25spring_tpu_torch.serve.driver.run_serve_bench`): seeded
open-loop traffic through the paged-KV engine, a continuous-vs-static and a
cached-vs-cold prefix A/B on the virtual clock (with ``DDL25_SERVE_SPEC=1``
also the spec-on-vs-off A/B; with an elastic ``DDL25_CHAOS`` the replica
scale-up/down run), ``serve.json`` in
``--obs-dir`` and one ``record: "serve"`` row in ``--perf-ledger``
(default ``runs/torch_perf_ledger.jsonl``); the last line is the BENCH record
with ``telemetry.serve``.  ``--smoke`` serves the tiny fp32 model with the
smoke knobs (obs dir ``runs/serve_smoke``); ``--serve-model ref`` the
full-width LLaMA.  ``python -m ddl25spring_tpu_torch.bench --serve
--serve-model ref --device cuda``.

``--serve-tp N`` (or ``DDL25_SERVE_TP=N``) serves from ``N`` ranks, started
here (:func:`~ddl25spring_tpu_torch.parallel.launch.spawn`) on a ``1 x N``
``model`` mesh: on one card all of them on ``cuda:0`` over gloo, on a host
with ``N`` cards one each over NCCL (``tools/tp_nccl_check.py`` drives that
on 2 cards).  Each rank runs the whole bench on its
shard in lockstep and adds the sharded-vs-single-card A/B
(``--no-serve-tp-ab`` skips it); rank 0 alone writes ``serve.json`` and the
ledger row, and its record is the printed line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

from ddl25spring_tpu_torch.benchmarks import timed_run
from ddl25spring_tpu_torch.data.mnist import load_mnist
from ddl25spring_tpu_torch.fl.horizontal import FedAvgServer
from ddl25spring_tpu_torch.utils.device import resolve_device

# tutorial_1a's solved-homework golden config (lab/series01.ipynb cell 20)
FEDAVG = dict(nr_clients=10, client_fraction=0.1, batch_size=100, nr_local_epochs=1,
              lr=0.01, seed=10)

METRIC = "cifar10_resnet18_dppp_samples_per_sec_per_chip"

# ---------------------------------------------------------------- failures

# an attempt's failure, coarsely (the JAX bench's codes, ``bench.py:72-92``)
REASON_DEVICE = "device_unreachable"
REASON_COMPILE = "compile_error"
REASON_RUNTIME = "runtime_error"
REASON_STALLED = "stalled"
REASON_PREEMPTED = "preempted"

_DEVICE_MARKERS = (
    # the JAX bench's
    "accelerator unreachable", "device init timed out", "unavailable",
    "deadline_exceeded", "failed to connect", "connection", "tunnel",
    "no devices", "backend 'tpu' failed to initialize", "device loss",
    # the card's: no GPU visible, a driver that does not come up, a card held
    # elsewhere, NCCL unable to reach its peers
    "no cuda gpus are available", "cuda driver initialization failed",
    "busy or unavailable", "cudaerrordevicesunavailable", "ncclremoteerror",
    "ncclsystemerror",
)
_COMPILE_MARKERS = (
    "compil", "lowering", "mosaic", "hlo", "xla_internal", "unimplemented",
    # the port's kernels (ops/_build.py): nvcc and ptxas
    "nvcc", "ptxas", "cuda build failed",
)
# SIGTERM as a scheduler's preemption notice (-15 from subprocess, 143 from a
# shell-style wrapper) and SIGKILL as its hard deadline or the OOM killer
_PREEMPT_RCS = (143, -15, 137, -9)


def classify_failure(error: str | None, rc: int | None = None) -> str:
    """An attempt's error string and exit status as a coarse reason code
    (``bench.py:95-113``): ``preempted`` (killed from outside: SIGTERM or
    SIGKILL, the resume path), ``stalled`` (the driver's timeout killed a
    wedged child), ``device_unreachable`` (no card, a driver or NCCL that
    does not come up, a device loss), ``compile_error`` (a kernel's nvcc or
    ptxas build), ``runtime_error`` (everything else, out of memory
    included)."""
    e = (error or "").lower()
    if rc in _PREEMPT_RCS or "preempt" in e or "sigterm" in e:
        return REASON_PREEMPTED
    if "exceeded" in e and "killed" in e:
        return REASON_STALLED
    if any(m in e for m in _DEVICE_MARKERS):
        return REASON_DEVICE
    if any(m in e for m in _COMPILE_MARKERS):
        return REASON_COMPILE
    return REASON_RUNTIME


def probe_devices(timeout_s: float, flight_dir: str | None = None, device: str = "cuda"):
    """The card's bring-up with a timeout (``bench.py:116-172``):
    ``torch.cuda.init()``, ``device_count()`` and one small allocation on a
    daemon thread, joined for ``timeout_s``, inside a
    :class:`~ddl25spring_tpu_torch.obs.StallWatchdog` whose deadline sits
    past the join, so a wedged bring-up leaves a ``flight.json`` naming the
    frame the probe thread is stuck in, and one that succeeds just under the
    wire never records a stall.  Returns ``(devices, error,
    flight_dump_path)``; ``device`` ``"cpu"`` returns the CPU at once.  Like
    any Python thread, the watchdog runs only while the probe's native call
    releases the GIL; a bring-up that spins holding it is reaped by the
    retry parent's ``--child-timeout`` (``stalled``)."""
    import torch

    from ddl25spring_tpu_torch.obs import StallWatchdog, flight

    if torch.device(device).type == "cpu":
        return [torch.device("cpu")], None, None
    out: dict = {}

    def _probe():
        try:
            torch.cuda.init()
            n = torch.cuda.device_count()
            torch.ones(1, device="cuda").add_(1).item()  # one allocation, one launch
            out["devices"] = [torch.device("cuda", i) for i in range(n)]
        except Exception as e:  # noqa: BLE001 -- report, don't hang
            out["error"] = f"{type(e).__name__}: {e}"

    flight.annotate(probe_timeout_s=timeout_s)
    t = threading.Thread(target=_probe, daemon=True, name="device-init-probe")
    margin = 2.0
    wd = StallWatchdog(deadline_s=timeout_s + margin, run_dir=flight_dir,
                       name="device-init-probe", source="self")
    with wd:
        t.start()
        t.join(timeout_s)
        if "devices" in out:
            return out["devices"], None, None
        if "error" not in out:
            # wedged, not raised: wait out the margin so the watchdog dumps
            deadline = time.perf_counter() + margin + 2 * wd.poll_s + 5.0
            while not wd.fired and time.perf_counter() < deadline:
                time.sleep(0.05)
    err = out.get("error", f"device init timed out after {timeout_s:.0f}s")
    return None, err, wd.dump_path


def attach_parent_telemetry(record: dict, failures: list | None, compile_report: dict | None,
                            resume: dict | None = None) -> dict:
    """Merge the retry driver's failure records and recovery summary into a
    bench record's ``telemetry`` (made when the child ran without one), as
    ``bench.py:175-230`` does: ``retry_failures``, ``resume`` merged over the
    child's own cell, and ``health.flight_dump`` (the record's or the last
    failure's) with ``health.reason`` on an error line.  The compile report
    and its lint cell wait for the analysis item (ROADMAP A12b): passing one
    raises ``NotImplementedError``."""
    if compile_report is not None:
        raise NotImplementedError(
            "the bench's compile report and lint cell need the describe() registry and the "
            "HLO linter, which wait for the analysis item (ROADMAP A12b)")
    tel = record.get("telemetry")
    if not isinstance(tel, dict):
        tel = {"enabled": False}
    if failures:
        tel["retry_failures"] = failures
    if resume:
        child = tel.get("resume")
        tel["resume"] = {**(child if isinstance(child, dict) else {}), **resume}
    health = tel.get("health") if isinstance(tel.get("health"), dict) else {}
    dump = record.get("flight_dump") or next(
        (f.get("flight_dump") for f in reversed(failures or []) if f.get("flight_dump")), None)
    if dump and "flight_dump" not in health:
        health["flight_dump"] = dump
    if "error" in record:
        health.setdefault("reason", classify_failure(record["error"]))
    if health:
        tel["health"] = health
    record["telemetry"] = tel
    return record


def _flight_dump_facts(flight_dump: str | None) -> tuple[float | None, int | None]:
    """One read of a dead child's ``flight.json``: ``(dumped_at_unix,
    last_resumable_step)`` (``bench.py:271-300``), so the staleness stamp and
    the step it vouches for come from one dump.  Only the checkpointed
    phase's step records count (``timed_run`` marks them ``resumable``):
    their indices share units with the durable steps, while the secondary
    phases count from 0 one step at a time."""
    if not flight_dump:
        return None, None
    try:
        with open(flight_dump) as f:
            doc = json.load(f)
        steps = [r["step"] for r in doc.get("records", [])
                 if r.get("kind") == "step" and r.get("resumable")
                 and isinstance(r.get("step"), int)]
        return doc.get("dumped_at_unix"), max(steps) if steps else None
    except (OSError, ValueError, KeyError):
        return None, None


def _flight_last_step(flight_dump: str | None) -> int | None:
    """The step half of :func:`_flight_dump_facts` (the resumed child's
    steps replayed)."""
    return _flight_dump_facts(flight_dump)[1]


def last_json_dict_line(stdout: str) -> dict | None:
    """The last line of ``stdout`` that parses as a JSON object (the port's
    copy of the JAX package's ``obs/compile_report.last_json_dict_line``):
    stray printables and JSON that is not an object are skipped."""
    for line in reversed(stdout.strip().splitlines()):
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(parsed, dict):
            return parsed
    return None


def _run_child(cmd: list, env: dict, timeout_s: float) -> tuple[int, str, str]:
    """``(returncode, stdout, stderr)`` of one child in a process group of
    its own; past ``timeout_s`` the whole group (the child's own ranks
    included) is killed and ``subprocess.TimeoutExpired`` raised with what
    the child wrote to stderr."""
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        out, err = p.communicate()
        raise subprocess.TimeoutExpired(cmd, timeout_s, output=out, stderr=err) from None
    return p.returncode, out, err


def _error_line(error: str, **extra) -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "samples/sec/chip", "vs_baseline": 0.0,
            "error": error, **extra}


def run_with_retries(argv, attempts: int, child_timeout_s: float,
                     compile_report: dict | None = None, ckpt_dir: str | None = None,
                     flight_path: str | None = None, ledger_path: str | None = None) -> dict:
    """Run the bench in fresh children until one prints a line without
    ``error`` (``bench.py:309-560``); print the final line and return it.
    Fresh processes: a card whose bring-up failed stays failed in that
    process, and the parent never makes a CUDA context of its own.

    With ``ckpt_dir``, a failed attempt that left a durable checkpoint
    makes the next one a resume (``--resume-from ckpt_dir``).  Each failed
    attempt adds a ``bench_retry_failure`` record (stderr, and the final
    line's ``telemetry.retry_failures``): the lineage id, the attempt, the
    error and :func:`classify_failure`'s reason, the exit status, the wall,
    the backoff that follows, the flight dump, the dead attempt's goodput
    facts priced off that dump now (the next attempt replaces the file),
    the step it had resumed from and the chaos spec.  ``telemetry.resume``
    counts the resumes and the steps lost: the gap between each death's
    last checkpointable step and the durable step the next attempt restarts
    from, a dump already billed for one death (the same stamp) not billed
    again.  After the loop the attempts fold into the lineage's goodput
    (``obs.goodput.merge_lineage``): ``goodput.json`` in the run dir
    rewritten, a ledger row in ``ledger_path`` (default
    ``runs/torch_perf_ledger.jsonl``), ``telemetry.goodput`` on the line."""
    from ddl25spring_tpu_torch.ft.manifest import latest_durable_step
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod

    if compile_report is not None:
        raise NotImplementedError("the compile report waits for ROADMAP A12b")
    backoff = (60.0, 120.0)
    chaos_spec = os.environ.get("DDL25_CHAOS")
    lineage_id = goodput_mod.mint_lineage_id()
    run_dir = os.path.dirname(flight_path) if flight_path else None
    failures: list[dict] = []

    def _finish(record: dict) -> dict:
        """The lineage's goodput on the line, in the run dir and the ledger;
        never at the cost of the line."""
        try:
            final = goodput_mod.read_run_goodput(run_dir) if run_dir else None
            if isinstance(final, dict) and final.get("scope") != "train_attempt":
                final = None  # a stale serve or lineage doc, not this child's
            merged = goodput_mod.merge_lineage(final, failures, lineage_id=lineage_id)
            if merged is None:
                return record
            if run_dir:
                goodput_mod.write_run_goodput(merged, run_dir)
            tel = record.setdefault("telemetry", {"enabled": False})
            if isinstance(tel, dict):
                tel["goodput"] = goodput_mod.goodput_cell(merged)
            if final is not None and merged.get("strategy"):
                from ddl25spring_tpu_torch.obs import perfscope

                # the child's card name: the parent makes no CUDA context
                kind = str(record.get("chip", "unknown")).rsplit(" x", 1)[0]
                perfscope.append_ledger(goodput_mod.ledger_row(
                    merged, strategy=merged["strategy"], mesh=merged.get("mesh"),
                    host=perfscope.host_fingerprint(kind=kind)),
                    ledger_path or perfscope.DEFAULT_LEDGER)
        except Exception as e:  # noqa: BLE001 -- a boundary: goodput never costs the line
            print(f"lineage goodput merge failed: {type(e).__name__}: {e}", file=sys.stderr)
        return record

    def _print(record: dict) -> dict:
        print(json.dumps(record, default=str), flush=True)
        return record

    last: dict = {}
    resume_step = None  # the durable step the NEXT attempt resumes from
    resume_count = steps_lost = 0
    seen_stamp = None
    delay = 0.0
    for i in range(attempts):
        if i and delay:
            time.sleep(delay)
        child_argv = list(argv)
        if resume_step is not None:
            child_argv += ["--resume-from", ckpt_dir]
            resume_count += 1
        env = dict(os.environ, DDL25_BENCH_CHILD="1",
                   **{goodput_mod.ENV_LINEAGE: lineage_id,
                      goodput_mod.ENV_ATTEMPT: str(i + 1)})
        t0 = time.perf_counter()
        rc = None
        try:
            rc, out, err = _run_child(
                [sys.executable, "-m", "ddl25spring_tpu_torch.bench", *child_argv], env,
                child_timeout_s)
        except subprocess.TimeoutExpired as e:
            # the run wedged after the probe: killed, and the next attempt
            sys.stderr.write(e.stderr or "")
            last = _error_line(f"attempt {i + 1}: bench subprocess exceeded "
                               f"{child_timeout_s:.0f}s and was killed")
        else:
            sys.stderr.write(err)
            parsed = last_json_dict_line(out)
            if parsed is not None and "error" not in parsed:
                resume = ({"resumes": resume_count, "total_steps_lost": steps_lost}
                          if resume_count else None)
                return _print(_finish(attach_parent_telemetry(parsed, failures, compile_report,
                                                              resume=resume)))
            last = parsed or _error_line(
                f"attempt {i + 1}: bench subprocess exited rc={rc} with no JSON line"
                + (f" (killed by signal {-rc})" if rc is not None and rc < 0 else ""))
        err_s = str(last.get("error", "unknown"))
        reason = classify_failure(err_s, rc=rc)
        # a SIGTERM'd or SIGKILL'd child prints no line, but its crash path
        # (or an earlier end-of-run dump) left flight.json in the run dir
        flight_dump = last.get("flight_dump") or (
            flight_path if flight_path and os.path.exists(flight_path) else None)
        prev_resume = resume_step
        resume_step = latest_durable_step(ckpt_dir) if ckpt_dir else None
        stamp, died_at = _flight_dump_facts(flight_dump)
        fresh = stamp is None or stamp != seen_stamp
        if stamp is not None and fresh:
            seen_stamp = stamp
        if resume_step is not None and fresh and died_at is not None:
            steps_lost += max(0, died_at - resume_step)
        attempt_goodput = None
        if flight_dump and fresh:
            try:
                with open(flight_dump) as f:
                    attempt_goodput = goodput_mod.failed_attempt_facts(json.load(f), resume_step)
            except (OSError, ValueError):
                attempt_goodput = None
        # no backoff after a preemption (the card was fine) or under armed
        # chaos (every death is simulated; waiting would bill fake recovery)
        delay = ((0.0 if reason == REASON_PREEMPTED or chaos_spec
                  else backoff[min(i, len(backoff) - 1)]) if i + 1 < attempts else 0.0)
        rec = {
            "record": "bench_retry_failure", "lineage_id": lineage_id, "attempt": i + 1,
            "attempts_left": attempts - i - 1, "error": err_s, "reason": reason, "rc": rc,
            "wall_s": round(time.perf_counter() - t0, 3), "backoff_s": delay,
            **({"flight_dump": flight_dump} if flight_dump else {}),
            **({"goodput": attempt_goodput} if attempt_goodput else {}),
            **({"resumed_from_step": prev_resume} if prev_resume is not None else {}),
            **({"chaos": chaos_spec} if chaos_spec else {}),
        }
        failures.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    last.setdefault("error", "unknown")
    last["error"] = f"exhausted {attempts} attempts; last: {last['error']}"
    resume = {"resumes": resume_count, "total_steps_lost": steps_lost} if resume_count else None
    return _print(_finish(attach_parent_telemetry(last, failures, compile_report,
                                                  resume=resume)))


def fedavg_secondary(n_rounds: int = 10, device=None, n_train: int | None = None) -> dict:
    """Timed FedAvg rounds on the tutorial_1a workload: N=10, C=0.1, B=100,
    E=1, lr 0.01, seed 10 (:data:`FEDAVG`) on ``n_train`` synthetic MNIST
    rows (default the full 60,000), one warm-up round, then ``n_rounds``
    timed server rounds (host-side client sampling, the chosen clients'
    local epochs and the weighted average on ``device``) in one window that
    starts and ends with the device idle
    (:func:`~ddl25spring_tpu_torch.benchmarks.timed_run`).  The value is
    the window's mean ms per round, as the JAX package's
    ``fedavg_secondary``; the median round (CUDA events between rounds on
    the card), the test accuracy after all the rounds (outside the window),
    the device and where the global weights live ride beside it."""
    dev = resolve_device(device)
    n_train = n_train or 60_000
    server = FedAvgServer(**FEDAVG, data=load_mnist(n_train=n_train, n_test=10_000),
                          device=dev)
    dt, _, round_s = timed_run(server.round, itertools.count().__next__, n_rounds, 1,
                               device=dev)
    return {
        "metric": "fedavg_round_ms",
        "value": round(dt / n_rounds * 1e3, 2),
        "unit": "ms/round",
        "n_train": n_train,
        "note": "tutorial_1a FedAvg N=10 C=0.1 B=100 E=1; one vmapped "
                "server round incl. host-side sampling",
        "median_ms": round(statistics.median(round_s) * 1e3, 3),
        "rounds": n_rounds,
        "test_accuracy": server.test_accuracy(),
        "device": str(dev),
        "params_device": sorted({str(t.device) for t in server.params.values()}),
    }


def main(argv=None) -> dict:
    """The bench: the training bench (the ResNet headline and its secondary
    lines) through the retry driver on the card, in this process on the CPU;
    with ``--serve``, the serving bench (:func:`serve_main`).  Prints the
    record as the last line and returns it."""
    t_entry = time.perf_counter()  # recovery_wall_s runs from here
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=10, help="FedAvg timed rounds")
    ap.add_argument("--n-train", type=int, default=0,
                    help="FedAvg train rows; 0 = the full 60,000")
    ap.add_argument("--scan-steps", type=int, default=0, metavar="K",
                    help="ResNet train steps per dispatch; 0 = the JAX rule (16 at batch "
                         "1024 on the card, 1 on the CPU); 1 = one step at a time")
    ap.add_argument("--per-chip-batch", type=int, default=None, metavar="B",
                    help="ResNet rows per card and step (default: the lab's, 1024 on the "
                         "card, 4 on the CPU)")
    ap.add_argument("--steps", type=int, default=None,
                    help="ResNet timed steps (default: the lab's 30)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="ResNet warm-up steps, the FLOP-counting one included (default 3)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="microbatches of a pipelined layout (default 2)")
    ap.add_argument("--stages", type=int, default=0, metavar="S",
                    help="the S-stage (2..4) heterogeneous pipeline x DP, its ranks sharing "
                         "the card; 0 or 1 = pure DP")
    ap.add_argument("--overlap", action="store_true",
                    help="backward-overlapped gradient buckets (pure DP, layout dp-overlap)")
    ap.add_argument("--no-fedavg", action="store_true",
                    help="skip the FedAvg round-time secondary line")
    ap.add_argument("--probe-timeout", type=float, default=240.0,
                    help="seconds the card's bring-up may take before the child gives up")
    ap.add_argument("--attempts", type=int, default=3,
                    help="fresh child processes the retry driver may start")
    ap.add_argument("--child-timeout", type=float, default=2400.0,
                    help="wall-clock bound on one child (its process group is killed past it)")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="checkpoint the primary phase every N dispatches (the "
                         "sentinel-gated async autosave); 0 = off, 2 when DDL25_CHAOS is armed")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint directory (default <obs-dir>/ckpt, else runs/bench_ckpt)")
    ap.add_argument("--resume-from", default=None, metavar="CKPT_DIR",
                    help="restore the latest durable step of CKPT_DIR and run the primary "
                         "phase on from it (the retry driver passes it on a relaunch)")
    ap.add_argument("--elastic", action="store_true",
                    help="train on 2 ranks that answer device_loss / capacity_change chaos by "
                         "reshaping in the run (pure DP, one step per dispatch)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="write the run's telemetry here (training: metrics.jsonl, counters, "
                         "trace, timeline, flight, perf, mem and goodput; serving: serve.json "
                         "and the same)")
    ap.add_argument("--perf-ledger", default=None, metavar="JSONL",
                    help="append the run's ledger rows here (perf, mem, goodput; serving: "
                         "serve too), default runs/torch_perf_ledger.jsonl")
    ap.add_argument("--perf-reps", type=int, default=8, metavar="K",
                    help="training: barriered reps of the per-batch step for the measured "
                         "perf record (0 = off)")
    ap.add_argument("--smoke", action="store_true",
                    help="training: batch 64, 8 steps, 2 warm-up, one step per dispatch, "
                         "512 rows, no FedAvg, obs dir runs/bench_smoke; with --serve: the "
                         "tiny fp32 model and the smoke knobs, obs dir runs/serve_smoke")
    ap.add_argument("--serve", action="store_true",
                    help="run the continuous-batching LLaMA serving bench instead of the "
                         "training bench (engine knobs via DDL25_SERVE_*)")
    ap.add_argument("--serve-duration", type=float, default=None, metavar="S",
                    help="traffic trace duration (seconds of arrival clock)")
    ap.add_argument("--serve-rate", type=float, default=None, metavar="RPS",
                    help="peak arrival rate (requests/sec)")
    ap.add_argument("--serve-profile", default=None,
                    choices=("flat", "ramp", "spike", "shared"),
                    help="arrival-rate shape (default ramp; 'shared' = seeded system "
                         "prompts, the radix-prefix-cache workload)")
    ap.add_argument("--serve-seed", type=int, default=None,
                    help="traffic trace seed (one seed replays the identical workload)")
    ap.add_argument("--serve-budget", type=float, default=None, metavar="S",
                    help="wall-clock bound on the ramp phase (default: run to drain)")
    ap.add_argument("--serve-model", default=None, choices=("tiny", "tiny-deep", "ref"),
                    help="model to serve (default: tiny under --smoke, else the "
                         "reference LLaMA constants)")
    ap.add_argument("--serve-tp", type=int, default=None, metavar="N",
                    help="TP-shard the serving engines N ways over N ranks (the pool's heads "
                         "and the blocks' Megatron slices divided per rank; overrides "
                         "DDL25_SERVE_TP); N > 1 also runs the sharded-vs-single-card A/B "
                         "that serve_report --check-tp gates")
    ap.add_argument("--no-serve-tp-ab", action="store_true",
                    help="skip the tp-sharded-vs-single-card A/B phase (it never runs at "
                         "tp=1)")
    ap.add_argument("--no-serve-ab", action="store_true",
                    help="skip the continuous-vs-static A/B phase")
    ap.add_argument("--no-serve-prefix-ab", action="store_true",
                    help="skip the cached-vs-cold prefix-cache A/B phase")
    ap.add_argument("--no-serve-spec-ab", action="store_true",
                    help="skip the spec-on-vs-off A/B phase (runs only with "
                         "DDL25_SERVE_SPEC=1)")
    args = ap.parse_args(argv)
    if args.serve:
        return serve_main(args)
    if args.attempts < 1:
        # 0 would skip the loop and print a line with nothing but an error
        print(f"clamping --attempts {args.attempts} -> 1", file=sys.stderr)
        args.attempts = 1
    if args.smoke:
        args.obs_dir = args.obs_dir or os.path.join("runs", "bench_smoke")
    if args.elastic and args.scan_steps not in (0, 1):
        # the reshape boundary is a dispatch boundary
        print("--elastic forces --scan-steps 1 (a reshape lands between dispatches)",
              file=sys.stderr)
    if args.elastic:
        args.scan_steps = 1
    is_child = os.environ.get("DDL25_BENCH_CHILD") == "1"
    chaos_spec = os.environ.get("DDL25_CHAOS")
    if chaos_spec and not args.save_every:
        args.save_every = 2  # a kill with nothing durable proves nothing
    resilient = bool(args.save_every or args.resume_from)
    if (resilient or chaos_spec) and args.stages > 1 and not args.elastic:
        # the autosave, the chaos hooks and the restore live in a run of one
        # process; a pipeline is a world of ranks that would ignore them
        print("--save-every, --resume-from and DDL25_CHAOS reach a run in one process; "
              f"--stages {args.stages} spawns a world of ranks: drop --stages or the "
              "resilience flags", file=sys.stderr)
        sys.exit(2)
    ckpt_dir = args.ckpt_dir or args.resume_from or (
        os.path.join(args.obs_dir, "ckpt") if args.obs_dir else os.path.join("runs", "bench_ckpt"))
    if args.resume_from and args.ckpt_dir and (
            os.path.abspath(args.resume_from) != os.path.abspath(args.ckpt_dir)):
        # saving into one directory while "resuming" from another would
        # restart from scratch behind the caller's back
        print("--resume-from and --ckpt-dir point at different directories; pass one (the "
              "resume source is also where new checkpoints land)", file=sys.stderr)
        sys.exit(2)
    # fresh-start hygiene, at the top of a run and never in a retry child: a
    # relaunched child keeps the chaos journal (one-shot faults) and the dead
    # attempt's flight dump (the steps it lost)
    if resilient and not args.resume_from and not is_child and os.path.isdir(ckpt_dir):
        if not _is_bench_ckpt_dir(ckpt_dir):
            print(f"refusing to wipe {ckpt_dir}: it does not look like a bench checkpoint "
                  "directory (no manifest.json, chaos journal or checkpoint step "
                  "directories); clear it yourself or pass --resume-from to continue from it",
                  file=sys.stderr)
            sys.exit(2)
        shutil.rmtree(ckpt_dir)
    flight_path = os.path.join(args.obs_dir, "flight.json") if args.obs_dir else None
    if not is_child and not args.resume_from and flight_path and os.path.exists(flight_path):
        os.remove(flight_path)
    # the parent decides from the flag alone: no torch.cuda call, no context
    on_card = args.device.split(":")[0] == "cuda"
    if (on_card or chaos_spec) and not is_child:
        return run_with_retries(argv if argv is not None else sys.argv[1:], args.attempts,
                                args.child_timeout, ckpt_dir=ckpt_dir if resilient else None,
                                flight_path=flight_path, ledger_path=args.perf_ledger)
    return train_main(args, t_entry=t_entry, ckpt_dir=ckpt_dir, resilient=resilient,
                      chaos=bool(chaos_spec), is_child=is_child)


def _is_bench_ckpt_dir(d: str) -> bool:
    """True when ``d`` is empty or recognisably a bench checkpoint directory:
    an autosave manifest, a chaos journal, or nothing but the checkpoint's
    step directories (``<step>``, ``<step>.tmp-dcp``)."""
    from ddl25spring_tpu_torch.ft.chaos import FIRED_BASENAME
    from ddl25spring_tpu_torch.ft.manifest import MANIFEST_BASENAME
    from ddl25spring_tpu_torch.utils.checkpoint import STAGING

    entries = os.listdir(d)
    journal = FIRED_BASENAME.removesuffix(".jsonl")
    return (not entries
            or any(e == MANIFEST_BASENAME or (e.startswith(journal) and e.endswith(".jsonl"))
                   for e in entries)
            or all(os.path.isdir(os.path.join(d, e))
                   and (e.isdigit() or (e.endswith(STAGING) and e[:-len(STAGING)].isdigit()))
                   for e in entries))


def _lineage():
    """This run's place in its lineage: the retry parent's (``DDL25_LINEAGE``
    / ``DDL25_ATTEMPT``) or, with none, a fresh one-attempt lineage of its
    own (``own`` True: it appends its own goodput row)."""
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod

    lineage_id, attempt = goodput_mod.lineage_from_env()
    own = lineage_id is None
    return {"lineage_id": lineage_id or goodput_mod.mint_lineage_id(), "attempt": attempt}, own


def _lab_run(args, device, n_cards: int):
    """The lab's argv and keyword cuts of the training flags
    (``bench.py:621-649, 766-774``), only the flags given."""
    from ddl25spring_tpu_torch.utils.config import env_int

    lab = ["--workload", "resnet", "--device", args.device]
    cuts = {}
    S = args.stages if args.stages > 1 else 1
    per_chip, steps, scan = args.per_chip_batch, args.steps, args.scan_steps
    # DDL25_BENCH_NTRAIN: the train split's rows on the card (the JAX bench's
    # knob, bench.py:1082-1085; the smoke's default 512)
    n_train = env_int("DDL25_BENCH_NTRAIN", 0)
    if args.smoke:
        per_chip, steps = min(per_chip or 64, 64), min(steps or 8, 8)
        scan = scan or 1
        cuts = {"warmup": min(args.warmup or 2, 2), "n_train": n_train or 512}
    else:
        if args.warmup is not None:
            cuts["warmup"] = args.warmup
        if n_train:
            cuts["n_train"] = n_train
    if per_chip:
        dp = max(n_cards // S, 1) if S > 1 else n_cards
        lab += ["--batch", str(per_chip * dp * S)]
    if steps:
        lab += ["--iters", str(steps)]
    if scan:
        lab += ["--scan-steps", str(scan)]
    if args.microbatches:
        lab += ["--microbatches", str(args.microbatches)]
    if S > 1:
        lab += ["--stages", str(S)]
    if args.overlap:
        cuts["overlap"] = True
    return lab, cuts


def train_main(args, t_entry: float | None = None, ckpt_dir: str | None = None,
               resilient: bool = False, chaos: bool = False, is_child: bool = False) -> dict:
    """The training bench in this process (a retry child, or a CPU run): the
    device probe, the ResNet headline with its resilient primary phase, the
    secondary lines and the telemetry; prints the record as the last line
    and returns it."""
    import torch

    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.ft.chaos import DeviceLossError
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod
    from ddl25spring_tpu_torch.obs import memscope, perfscope, sentinels
    from ddl25spring_tpu_torch.obs.timeline import timeline
    from ddl25spring_tpu_torch.utils.flops import chip_peak_flops

    t_main0 = t_entry if t_entry is not None else time.perf_counter()
    flash0 = _flash_launches()
    lineage, own_lineage = _lineage()
    meter = goodput_mod.GoodputMeter(lineage["lineage_id"], lineage["attempt"], t0_perf=t_main0)
    obs.flight.configure(run_dir=args.obs_dir)
    if is_child or resilient or chaos:
        # from here a SIGTERM drains the checkpoint, then dumps flight.json
        obs.flight.install()
    obs.flight.annotate(driver="bench", argv=list(sys.argv[1:]), **lineage)
    ledger = args.perf_ledger or perfscope.DEFAULT_LEDGER
    flight_path = os.path.join(args.obs_dir, "flight.json") if args.obs_dir else None
    # the dead attempt's last checkpointable step, read before anything here
    # can replace its dump
    prev_last = _flight_last_step(flight_path) if args.resume_from else None

    devices, err, probe_dump = probe_devices(args.probe_timeout, flight_dir=args.obs_dir,
                                             device=args.device)
    if devices is None:
        record = _error_line(f"accelerator unreachable: {err}",
                             **({"flight_dump": probe_dump} if probe_dump else {}))
        attach_parent_telemetry(record, None, None)
        print(json.dumps(record), flush=True)
        sys.stderr.flush()
        if "timed out" in str(err):
            # a wedged bring-up can deadlock the interpreter's exit: leave now
            os._exit(0)
        return record
    device = resolve_device(args.device)
    n_cards = len(devices) if device.type == "cuda" else 1
    ft = (dp_pp.ResnetFT(ckpt_dir, save_every=args.save_every, resume=bool(args.resume_from),
                         t_entry=t_main0, prev_last_step=prev_last)
          if resilient or chaos else None)
    if args.elastic:
        return _elastic_main(args, device, ft or dp_pp.ResnetFT(ckpt_dir), lineage,
                             own_lineage, ledger)
    lab, cuts = _lab_run(args, device, n_cards)
    # the hooks, the resilient primary and the secondaries reach a run this
    # process makes alone (the lab spawns a world of ranks on a host of
    # several cards, or for --stages)
    one_process = (device.type != "cuda" or n_cards <= 1) and args.stages <= 1
    obs_dir = args.obs_dir if one_process else None
    logger = None
    if obs_dir:
        # on BEFORE the step is built, so its spans and counters record
        obs.enable()
        obs.set_recorder(obs.SpanRecorder(process_name="bench"))
        obs.counters.reset()
        timeline.configure(run_dir=obs_dir, meta=lineage)
        logger = obs.MetricsLogger(obs_dir, meta=obs.run_metadata(
            mesh={"data": 1}, n_chips=1, **lineage))
    scope = memscope.MemScope(label="train", every=memscope.default_every(device),
                              device=device)
    tel = dp_pp.ResnetTelemetry(logger=logger, goodput=meter,
                                memscope=scope if memscope.enabled() else None, ft=ft,
                                secondaries=True)
    try:
        run = dp_pp.main(lab, telemetry=tel if one_process else None, **cuts)
    except DeviceLossError as e:
        # the error line the retry driver classifies device_unreachable; the
        # saver drained, so the relaunch resumes from its durable step
        dump = None
        try:
            dump = obs.flight.dump(reason="device_loss")
        except OSError:
            pass
        record = _error_line(str(e), **({"flight_dump": dump} if dump else {}))
        print(json.dumps(record), flush=True)
        return record
    rec = json.loads(run["line"])
    r0 = run["ranks"][0]
    telemetry: dict = {"enabled": bool(obs_dir)}
    fedavg = [] if args.smoke or args.no_fedavg else [_fedavg_line(args)]
    live = r0.get("live")
    if live is None:
        why = ("the run handed back no live step: the bench's hooks reach a run this "
               "process makes alone, not a spawned world of ranks")
        for k in ("perf", "mem", "goodput"):
            telemetry[k] = {"enabled": False, "why": why}
        if ft is not None:
            # no checkpoint written, no chaos fired, nothing restored
            telemetry["resume"] = {"enabled": False, "why": why}
            print(f"--save-every/--resume-from/DDL25_CHAOS not applied: {why}",
                  file=sys.stderr)
        rec["telemetry"], rec["secondary"] = telemetry, fedavg
        rec["flash_launches"] = _flash_launches(flash0)
        print(json.dumps(rec), flush=True)
        return rec
    step, fixed, meta = live
    mesh_axes = {"data": meta["n_chips"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec.update(chip=f"{kind} x{meta['n_chips']}", topology=meta["topology"],
               data=r0.get("provenance"), scan_steps=meta.get("scan_steps", 1),
               flops_per_step=r0.get("flops"), h2d_mib_per_s=_round(r0.get("h2d_mib_per_s")),
               peak_bytes_allocated=r0.get("peak_bytes"))

    # the measured perf record of the live per-batch step; a failure rides
    # the line as telemetry.perf.error (the measurement never costs the line)
    perf = None
    if args.perf_reps > 0:
        try:
            perf = perfscope.measure_bench_step(step, fixed, {**meta, "mesh_axes": mesh_axes},
                                                reps=args.perf_reps, device=device)
        except (RuntimeError, ValueError) as e:
            print(f"perfscope measurement failed ({type(e).__name__}: {e})", file=sys.stderr)
            perf = {"error": f"{type(e).__name__}: {e}"}
        if "error" in perf:
            telemetry["perf"] = {"error": perf["error"]}
        else:
            telemetry["perf"] = perfscope.perf_cell(perf)
            telemetry["perf"]["ledger"] = perfscope.append_ledger(perf, ledger)
            if obs_dir:
                perfscope.write_run_perf(perf, obs_dir)

    if logger is not None:
        # the facts known only after the run (summarize_run merges headers)
        logger.log(record="header", layout=meta["layout"], topology=meta["topology"],
                   batch=meta["batch"], num_stages=meta["num_stages"],
                   num_microbatches=meta["num_microbatches"], input_mode=r0["input"],
                   flops_per_step=r0["flops"], peak_flops_per_chip=chip_peak_flops(device),
                   h2d_mib_per_s=r0.get("h2d_mib_per_s"))
        logger.close()
        obs.counters.save(obs_dir)
        telemetry["trace"] = obs.get_recorder().save(os.path.join(obs_dir, "trace.json"))
        timeline.flush()
        telemetry["timeline"] = timeline.path
        from ddl25spring_tpu_torch.obs.report import summarize_run

        s = summarize_run(obs_dir)
        telemetry.update(run_dir=obs_dir, phases={
            name: {k: ph.get(k) for k in ("steps", "step_s_p50", "step_s_p95",
                                          "samples_per_sec_per_chip_p50", "mfu")
                   if ph.get(k) is not None}
            for name, ph in s.get("phases", {}).items()})

    # live bytes against the first sampled step's (the budget anchor)
    telemetry["mem"] = {"enabled": False}
    if memscope.enabled():
        mem = memscope.mem_record(
            strategy=meta["layout"], mesh=mesh_axes, scope_cell=scope.cell(),
            budget=memscope.budget_cell(scope.live_bytes_peak, scope.live_bytes_baseline,
                                        source="first_sample_live_bytes"),
            device=device)
        telemetry["mem"] = memscope.mem_cell(mem)
        telemetry["mem"]["ledger"] = perfscope.append_ledger(mem, ledger)
        if obs_dir:
            telemetry["mem"]["mem_json"] = memscope.write_run_mem(mem, obs_dir)
    if r0.get("resume") is not None:
        telemetry["resume"] = r0["resume"]
    telemetry["health"] = _health(obs, sentinels, dump=bool(obs_dir))
    telemetry["goodput"] = _goodput(meter, obs, meta["layout"], mesh_axes, obs_dir,
                                    own_lineage, ledger, kind)
    rec["telemetry"], rec["secondary"] = telemetry, r0.get("secondary", []) + fedavg
    rec["flash_launches"] = _flash_launches(flash0)
    print(json.dumps(rec, default=str), flush=True)
    return rec


def _flash_launches(since: dict | None = None) -> dict:
    """The flash-attention kernels this process has launched or captured,
    by kernel, less ``since``'s counts."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    now = {n: fa.LAUNCHES[n] + sum(fa.CAPTURED[n].values()) for n in fa.LAUNCHES}
    return {n: c - (since or {}).get(n, 0) for n, c in now.items()}


def _round(x, nd: int = 1):
    return None if x is None else round(x, nd)


def _fedavg_line(args) -> dict:
    """The FedAvg secondary, its failure an error note: it never costs the
    already-measured headline (nor the retry driver's attempts)."""
    try:
        from ddl25spring_tpu_torch.utils.config import env_int

        return fedavg_secondary(args.rounds, args.device,
                                args.n_train or env_int("DDL25_BENCH_NTRAIN", 0) or None)
    except Exception as e:  # noqa: BLE001 -- keep the headline
        return {"metric": "fedavg_round_ms", "value": None, "unit": "ms/round",
                "note": f"failed: {type(e).__name__}: {e}"}


def _health(obs, sentinels, dump: bool) -> dict:
    """The runtime-health cell, with the end-of-run flight dump."""
    snap = obs.flight.snapshot()
    return {
        "sentinels": sentinels.enabled(), "policy": sentinels.policy(),
        "violations": snap["violations"], "stalls": snap["stalls"],
        "flight_records": snap["recorded"],
        **({"flight_dump": obs.flight.dump(reason="end_of_run")} if dump else {}),
    }


def _goodput(meter, obs, strategy: str, mesh_axes: dict, obs_dir, own_lineage: bool,
             ledger: str, kind: str, doc: dict | None = None) -> dict:
    """This attempt's wall split (``doc``, or ``meter``'s): everything never
    measured (imports, the dataset, FedAvg, perfscope) is the ``other``
    residual; ``goodput.json`` in the obs dir, and the ledger row when the
    run is its own lineage."""
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod
    from ddl25spring_tpu_torch.obs import perfscope

    if doc is None:
        for r in obs.flight.last():
            if r.get("kind") == "stall" and isinstance(r.get("idle_s"), (int, float)):
                meter.add_seconds("stall", r["idle_s"])
        doc = meter.finalize(scope="train_attempt", strategy=strategy, mesh=mesh_axes)
    cell = goodput_mod.goodput_cell(doc)
    if obs_dir:
        goodput_mod.write_run_goodput(doc, obs_dir)
    if own_lineage:
        cell["ledger"] = perfscope.append_ledger(goodput_mod.ledger_row(
            doc, strategy=strategy, mesh=mesh_axes, host=perfscope.host_fingerprint(kind=kind)),
            ledger)
    return cell


def _elastic_main(args, device, ft, lineage: dict, own_lineage: bool, ledger: str) -> dict:
    """``--elastic``: the world of 2 ranks (:func:`~ddl25spring_tpu_torch.
    lab.dp_pp.elastic_resnet`), rank 0's facts as the line: samples/s per
    card over card-seconds, the reshapes in ``telemetry.resume``, rank 0's
    goodput, and the FedAvg line; the perf and mem cells are off (a world of
    ranks)."""
    import torch

    from ddl25spring_tpu_torch import benchmarks, obs
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.utils.flops import mfu

    lab, cuts = _lab_run(args, device, 1)
    lab_args = dp_pp.parse_args(lab)
    world = 2  # the lab's per-card rows on each rank, as on 2 cards
    batch = (lab_args.batch or (1024 if device.type == "cuda" else 4)) * world
    job = dp_pp.ResnetJob(world, 1, 1, batch, lab_args.iters or 30, lr=lab_args.lr or 0.1,
                          seed=lab_args.seed, device=device.type, input="hbm",
                          warmup=cuts.get("warmup", dp_pp.WARMUP), n_train=cuts.get("n_train"))
    print(f"resnet18/cifar10 elastic: {world} ranks, pure DP, global batch {batch}, "
          f"{job.iters} steps, one per dispatch, device={device.type}", flush=True)
    r = dp_pp.elastic_resnet(job, ft, world, lineage=lineage)
    tf, frac = mfu(r["flops"], r["card_s"] / r["steps"], 1, device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = json.loads(benchmarks.report_line(r["layout"], r["samples_per_s_per_chip"],
                                            r["input"], frac, tf))
    rec.update(chip=f"{kind} x{r['cards']}", topology=r["topology"], data=r["provenance"],
               scan_steps=1, flops_per_step=r["flops"])
    telemetry: dict = {"enabled": False}
    why = "an elastic run is a world of ranks: the bench's perf and mem hooks reach one process"
    telemetry["perf"] = {"enabled": False, "why": why}
    telemetry["mem"] = {"enabled": False, "why": why}
    if r.get("resume") is not None:
        telemetry["resume"] = r["resume"]
    telemetry["health"] = _health(obs, sentinels, dump=bool(args.obs_dir))
    telemetry["goodput"] = _goodput(None, obs, r["layout"], {"data": world}, args.obs_dir,
                                    own_lineage, ledger, kind, doc=r["goodput"])
    fedavg = [] if args.smoke or args.no_fedavg else [_fedavg_line(args)]
    rec["telemetry"], rec["secondary"] = telemetry, fedavg
    print(json.dumps(rec, default=str), flush=True)
    return rec


def serve_main(args) -> dict:
    """The serving bench: prints the BENCH record with ``telemetry.serve`` as
    the last line and returns it.  At ``tp > 1`` it starts the ranks, and the
    record is rank 0's."""
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.config import env_int

    if args.smoke:
        args.obs_dir = args.obs_dir or os.path.join("runs", "serve_smoke")
    tp = args.serve_tp if args.serve_tp is not None else env_int("DDL25_SERVE_TP", 1)
    if tp > 1:
        # the ranks take this process's DDL25_* knobs as they are now (a rank
        # forks from a server that may have started under other ones)
        env = {k: v for k, v in os.environ.items() if k.startswith("DDL25_")}
        rec = next(r for r in spawn(_serve_rank, tp, vars(args), tp, env, timeout=3600)
                   if r is not None)
    else:
        rec = _serve_record(args, None)
    print(json.dumps(rec, default=str), flush=True)
    return rec


def _serve_rank(rdv, args: dict, tp: int, env: dict):
    """One rank of ``bench --serve --serve-tp N``: takes the launcher's
    ``DDL25_*`` environment ``env``, joins the ``1 x N`` model mesh and runs
    the bench on its shard; rank 0 returns the record, the others None."""
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    for k in [k for k in os.environ if k.startswith("DDL25_")]:
        del os.environ[k]
    os.environ.update(env)
    with init_mesh(rdv, 1, model=tp, device=args["device"]) as mesh:
        rec = _serve_record(argparse.Namespace(**args), mesh, primary=mesh.rank == 0)
    return rec if rdv.rank == 0 else None


def _serve_record(args, mesh, primary: bool = True) -> dict:
    """Run the serving bench (on ``mesh`` when sharded) and build the BENCH
    record; only the ``primary`` rank writes the obs dir and the ledger."""
    import torch

    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod
    from ddl25spring_tpu_torch.obs import memscope, perfscope, sentinels
    from ddl25spring_tpu_torch.obs.timeline import timeline
    from ddl25spring_tpu_torch.serve.driver import run_serve_bench, serve_cell
    from ddl25spring_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device) if mesh is None else mesh.device
    obs_dir = args.obs_dir if primary else None
    lineage, _ = _lineage()
    if obs_dir:
        # before the engines build, so the serve spans and the request
        # timeline record
        obs.enable()
        obs.set_recorder(obs.SpanRecorder(process_name="serve"))
        timeline.configure(run_dir=obs_dir)
    record = run_serve_bench(
        smoke=args.smoke, model=args.serve_model, obs_dir=obs_dir,
        duration_s=args.serve_duration, rate_rps=args.serve_rate,
        profile=args.serve_profile, seed=args.serve_seed, budget_s=args.serve_budget,
        ledger_path=(args.perf_ledger or perfscope.DEFAULT_LEDGER) if primary else None,
        skip_ab=args.no_serve_ab, skip_prefix_ab=args.no_serve_prefix_ab,
        skip_spec_ab=args.no_serve_spec_ab, skip_tp_ab=args.no_serve_tp_ab,
        serve_tp=args.serve_tp, mesh=mesh, device=dev, lineage=lineage,
    )
    sentinels.flush()
    snap = obs.flight.snapshot()
    telemetry: dict = {
        "enabled": bool(obs_dir),
        "serve": serve_cell(record),
        # the SLO-denominated serving goodput the driver computed
        "goodput": {**lineage, **goodput_mod.goodput_cell(record.get("goodput"))},
        "mem": memscope.mem_cell(record["mem"]) if record.get("mem") else {"enabled": False},
    }
    for cell in ("mem", "goodput"):
        if record.get(f"{cell}_json"):
            telemetry[cell][f"{cell}_json"] = record[f"{cell}_json"]
    health = {
        "sentinels": sentinels.enabled(),
        "policy": sentinels.policy(),
        "violations": snap["violations"],
        "stalls": snap["stalls"],
        "flight_records": snap["recorded"],
    }
    if obs_dir:
        health["flight_dump"] = obs.flight.dump(
            os.path.join(obs_dir, "flight.json"), reason="end_of_run")
        telemetry["trace"] = obs.get_recorder().save(os.path.join(obs_dir, "trace.json"))
        timeline.flush()
        telemetry["timeline"] = timeline.path
        telemetry["timeline_events"] = timeline.snapshot()["emitted"]
    telemetry["health"] = health
    ramp = record["ramp"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rec = {
        "metric": "serve_tokens_per_sec_per_chip",
        "value": ramp.get("tokens_per_sec_per_chip"),
        "unit": "tokens/sec/chip",
        "vs_baseline": None,
        "model": record["key"]["model"],
        "profile": record["key"]["profile"],
        "chip": f"{kind} x{ramp.get('n_chips', 1)}",
        **({"tp": ramp.get("tp")} if ramp.get("tp", 1) > 1 else {}),
        "telemetry": telemetry,
    }
    return rec


if __name__ == "__main__":
    main()
