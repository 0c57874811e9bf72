"""The port's bench entry: the two metrics ``BASELINE.json`` names, on one
JSON line.  The counterpart of the top-level ``bench.py`` without its retry
wrapper, lineage and telemetry (ROADMAP A10, A11).

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
record.

Serving mode (``bench.py:694-745``, ``:939-1000``): ``--serve`` runs the
continuous-batching LLaMA serving bench instead
(:func:`~ddl25spring_tpu_torch.serve.driver.run_serve_bench`): seeded
open-loop traffic through the paged-KV engine, a continuous-vs-static and a
cached-vs-cold prefix A/B on the virtual clock (with ``DDL25_SERVE_SPEC=1``
also the spec-on-vs-off A/B; with an elastic ``DDL25_CHAOS`` the replica
scale-up/down run), ``serve.json`` in
``--obs-dir`` and one ``record: "serve"`` row in ``--perf-ledger``
(default ``runs/perf_ledger.jsonl``); the last line is the BENCH record
with ``telemetry.serve``.  ``--smoke`` serves the tiny fp32 model with the
smoke knobs (obs dir ``runs/serve_smoke``); ``--serve-model ref`` the
full-width LLaMA.  ``python -m ddl25spring_tpu_torch.bench --serve
--serve-model ref --device cuda``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics

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
                    help="serving: write serve.json, trace.json and timeline.jsonl here")
    ap.add_argument("--perf-ledger", default=None, metavar="JSONL",
                    help="serving: append the record:\"serve\" row here (default "
                         "runs/perf_ledger.jsonl; gate trends with tools/serve_report.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --serve: the tiny fp32 model and the smoke knobs, obs dir "
                         "runs/serve_smoke")
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
                    help="TP-shard the serving engine N ways (N > 1 waits for A9b-3)")
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
    scan = ["--scan-steps", str(args.scan_steps)] if args.scan_steps else []
    run = dp_pp.main(["--workload", "resnet", "--device", args.device, *scan])
    rec = json.loads(run["line"])
    rec["secondary"] = [fedavg_secondary(args.rounds, args.device, args.n_train or None)]
    print(json.dumps(rec), flush=True)
    return rec


def serve_main(args) -> dict:
    """The serving bench: prints the BENCH record with ``telemetry.serve`` as
    the last line and returns it."""
    import os

    import torch

    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.obs.timeline import timeline
    from ddl25spring_tpu_torch.serve.driver import run_serve_bench, serve_cell
    from ddl25spring_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.smoke:
        args.obs_dir = args.obs_dir or os.path.join("runs", "serve_smoke")
    if args.obs_dir:
        # before the engines build, so the serve spans and the request
        # timeline record
        obs.enable()
        obs.set_recorder(obs.SpanRecorder(process_name="serve"))
        timeline.configure(run_dir=args.obs_dir)
    record = run_serve_bench(
        smoke=args.smoke, model=args.serve_model, obs_dir=args.obs_dir,
        duration_s=args.serve_duration, rate_rps=args.serve_rate,
        profile=args.serve_profile, seed=args.serve_seed, budget_s=args.serve_budget,
        ledger_path=args.perf_ledger or "runs/perf_ledger.jsonl",
        skip_ab=args.no_serve_ab, skip_prefix_ab=args.no_serve_prefix_ab,
        skip_spec_ab=args.no_serve_spec_ab,
        serve_tp=args.serve_tp, device=dev,
    )
    sentinels.flush()
    snap = obs.flight.snapshot()
    telemetry: dict = {
        "enabled": bool(args.obs_dir),
        "serve": serve_cell(record),
        # the goodput and memory cells come with the rest of the
        # observability port (ROADMAP A11b)
        "goodput": {"enabled": False},
        "mem": {"enabled": False},
    }
    health = {
        "sentinels": sentinels.enabled(),
        "policy": sentinels.policy(),
        "violations": snap["violations"],
        "stalls": snap["stalls"],
        "flight_records": snap["recorded"],
    }
    if args.obs_dir:
        health["flight_dump"] = obs.flight.dump(
            os.path.join(args.obs_dir, "flight.json"), reason="end_of_run")
        telemetry["trace"] = obs.get_recorder().save(os.path.join(args.obs_dir, "trace.json"))
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
        "telemetry": telemetry,
    }
    print(json.dumps(rec, default=str), flush=True)
    return rec


if __name__ == "__main__":
    main()
