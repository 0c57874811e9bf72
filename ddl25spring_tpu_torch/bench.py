"""The port's bench entry: the two metrics ``BASELINE.json`` names, on one
JSON line.  The counterpart of the top-level ``bench.py`` without its retry
wrapper (ROADMAP A10b): each run is its own one-attempt lineage.

- The headline: ResNet-18/CIFAR-10 samples/s per card through
  ``lab.dp_pp --workload resnet`` (:func:`~ddl25spring_tpu_torch.lab.dp_pp.run_resnet`),
  whose ``report_line`` this line is.
- ``secondary``: the FedAvg round time of :func:`fedavg_secondary`, timed as
  ``bench.py:563-604`` times it.

The ResNet run takes ``lab.dp_pp``'s defaults (batch 1024 per card, SGD lr
0.1, ``--input auto``), as the top-level bench takes its lab's: on one card
K train steps per dispatch, one CUDA graph each, with K by the JAX rule
(``bench.py:1086-1100``: the largest divisor of the epoch's batches up to
16, so 16 at batch 1024; 2 windows, 32 timed steps), and the line's input
reads ``hbm-resident-shuffle-scan16``; ``--scan-steps K`` sets K, and
``--scan-steps 1`` gives the per-step mode (30 timed steps).

Run: ``python -m ddl25spring_tpu_torch.bench [--device cuda] [--rounds 10]
[--n-train 60000] [--scan-steps K]``.  The last line of the output is the
record, with ``telemetry``:

- ``perf`` (``--perf-reps K``, default 8, 0 turns it off): the measured
  perf record of the live per-batch train step
  (:func:`~ddl25spring_tpu_torch.obs.perfscope.measure_bench_step`), its
  cell on the line, the record appended to ``--perf-ledger`` (default
  ``runs/torch_perf_ledger.jsonl``, git-ignored) for ``tools/perf_report.py``;
- ``goodput``: the run's wall split into buckets (the warm-up, the timed
  calls, the rest), appended as a ``record: "goodput"`` row;
- ``mem`` (with ``--obs-dir``): the live bytes sampled after each timed
  call against the first sample's, appended as a ``record: "mem"`` row;
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
continuous-batching LLaMA serving bench instead
(:func:`~ddl25spring_tpu_torch.serve.driver.run_serve_bench`): seeded
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
import statistics
import sys

from ddl25spring_tpu_torch.benchmarks import timed_run
from ddl25spring_tpu_torch.data.mnist import load_mnist
from ddl25spring_tpu_torch.fl.horizontal import FedAvgServer
from ddl25spring_tpu_torch.utils.device import resolve_device

# tutorial_1a's solved-homework golden config (lab/series01.ipynb cell 20)
FEDAVG = dict(nr_clients=10, client_fraction=0.1, batch_size=100, nr_local_epochs=1,
              lr=0.01, seed=10)


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
    """Run the ResNet headline, then the FedAvg rounds, and print the
    headline's ``report_line`` with ``"secondary": [<FedAvg line>]`` as the
    last line; returns that record.  With ``--serve``, the serving bench
    (:func:`serve_main`) instead."""
    from ddl25spring_tpu_torch.lab import dp_pp

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=10, help="FedAvg timed rounds")
    ap.add_argument("--n-train", type=int, default=0,
                    help="FedAvg train rows; 0 = the full 60,000")
    ap.add_argument("--scan-steps", type=int, default=0, metavar="K",
                    help="ResNet train steps per dispatch; 0 = the JAX rule (16 at batch "
                         "1024 on the card, 1 on the CPU); 1 = one step at a time")
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
    return train_main(args)


def _lineage():
    """This run's place in its lineage: the retry parent's (``DDL25_LINEAGE``
    / ``DDL25_ATTEMPT``) or, with none, a fresh one-attempt lineage of its
    own (``own`` True: it appends its own goodput row)."""
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod

    lineage_id, attempt = goodput_mod.lineage_from_env()
    own = lineage_id is None
    return {"lineage_id": lineage_id or goodput_mod.mint_lineage_id(), "attempt": attempt}, own


def train_main(args) -> dict:
    """The training bench: the ResNet headline with its telemetry, then the
    FedAvg rounds; prints the record as the last line and returns it."""
    import time

    import torch

    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod
    from ddl25spring_tpu_torch.obs import memscope, perfscope, sentinels
    from ddl25spring_tpu_torch.obs.timeline import timeline
    from ddl25spring_tpu_torch.utils.flops import chip_peak_flops

    t_main0 = time.perf_counter()
    lineage, own_lineage = _lineage()
    meter = goodput_mod.GoodputMeter(lineage["lineage_id"], lineage["attempt"], t0_perf=t_main0)
    obs.flight.annotate(driver="bench", **lineage)
    ledger = args.perf_ledger or perfscope.DEFAULT_LEDGER
    lab = ["--workload", "resnet", "--device", args.device]
    cuts = {}
    if args.smoke:
        lab += ["--batch", "64", "--iters", "8", "--scan-steps", "1"]
        cuts = {"warmup": 2, "n_train": 512}
        args.obs_dir = args.obs_dir or os.path.join("runs", "bench_smoke")
    elif args.scan_steps:
        lab += ["--scan-steps", str(args.scan_steps)]
    device = resolve_device(args.device)
    # the hooks reach a run this process makes alone (the lab spawns a
    # world of ranks on a host of several cards)
    one_process = device.type != "cuda" or torch.cuda.device_count() <= 1
    obs_dir = args.obs_dir if one_process else None
    logger = None
    if obs_dir:
        # on BEFORE the step is built, so its spans and counters record
        obs.enable()
        obs.set_recorder(obs.SpanRecorder(process_name="bench"))
        obs.counters.reset()
        obs.flight.configure(run_dir=obs_dir)
        timeline.configure(run_dir=obs_dir, meta=lineage)
        logger = obs.MetricsLogger(obs_dir, meta=obs.run_metadata(
            mesh={"data": 1}, n_chips=1, **lineage))
    scope = memscope.MemScope(label="train", every=memscope.default_every(device),
                              device=device)
    tel = dp_pp.ResnetTelemetry(logger=logger, goodput=meter,
                                memscope=scope if memscope.enabled() else None)
    run = dp_pp.main(lab, telemetry=tel if one_process else None, **cuts)
    rec = json.loads(run["line"])
    r0 = run["ranks"][0]
    telemetry: dict = {"enabled": bool(obs_dir)}
    fedavg = ([] if args.smoke
              else [fedavg_secondary(args.rounds, args.device, args.n_train or None)])
    live = r0.get("live")
    if live is None:
        why = ("the run handed back no live step: the bench's hooks reach a run this "
               "process makes alone, not a spawned world of ranks")
        for k in ("perf", "mem", "goodput"):
            telemetry[k] = {"enabled": False, "why": why}
        rec["telemetry"], rec["secondary"] = telemetry, fedavg
        print(json.dumps(rec), flush=True)
        return rec
    step, fixed, meta = live
    mesh_axes = {"data": meta["n_chips"]}

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
                   flops_per_step=r0["flops"], peak_flops_per_chip=chip_peak_flops(device))
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

    snap = obs.flight.snapshot()
    telemetry["health"] = {
        "sentinels": sentinels.enabled(), "policy": sentinels.policy(),
        "violations": snap["violations"], "stalls": snap["stalls"],
        "flight_records": snap["recorded"],
        **({"flight_dump": obs.flight.dump(reason="end_of_run")} if obs_dir else {}),
    }

    # this attempt's wall split; everything never measured (imports, the
    # dataset, FedAvg, perfscope) is the ``other`` residual
    for r in obs.flight.last():
        if r.get("kind") == "stall" and isinstance(r.get("idle_s"), (int, float)):
            meter.add_seconds("stall", r["idle_s"])
    doc = meter.finalize(scope="train_attempt", strategy=meta["layout"], mesh=mesh_axes)
    telemetry["goodput"] = goodput_mod.goodput_cell(doc)
    if obs_dir:
        goodput_mod.write_run_goodput(doc, obs_dir)
    if own_lineage:
        telemetry["goodput"]["ledger"] = perfscope.append_ledger(goodput_mod.ledger_row(
            doc, strategy=meta["layout"], mesh=mesh_axes,
            host=perfscope.host_fingerprint(device)), ledger)
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
