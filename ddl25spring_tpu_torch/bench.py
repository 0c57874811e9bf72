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
    last line; returns that record."""
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
    args = ap.parse_args(argv)
    scan = ["--scan-steps", str(args.scan_steps)] if args.scan_steps else []
    run = dp_pp.main(["--workload", "resnet", "--device", args.device, *scan])
    rec = json.loads(run["line"])
    rec["secondary"] = [fedavg_secondary(args.rounds, args.device, args.n_train or None)]
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
