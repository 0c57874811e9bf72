"""The series01 golden accuracy tables on PyTorch: the counterpart of
``examples/golden_tables.py``.

The reference's empirical artifact is the solved homework's accuracy grid on
real MNIST (``lab/series01.ipynb`` cell 20: FedAvg 93.2 % / FedSGD 42.87 %
at N=10 C=0.1 after 10 rounds, and the N/C sweep).  This runner prints that
table through the port's servers (:mod:`ddl25spring_tpu_torch.fl.horizontal`)
the moment real data is present::

    DDL25_MNIST_DIR=/path/to/idx python -m ddl25spring_tpu_torch.examples.golden_tables

Without the four IDX files it runs on the synthetic stand-in and says so in
its header, printing the golden values beside what it got, so a reader sees
which numbers a real-data run must hit.  The config is the notebook's:
lr=0.01, E=1, B=100 (FedAvg) / full batch (FedSGD), seed=10.  The servers
run on the card unless ``--device cpu`` asks for the host (the JAX script's
``--force-cpu-devices``).

Run: ``python -m ddl25spring_tpu_torch.examples.golden_tables [--quick]
[--rounds 10] [--device cpu]``
"""

from __future__ import annotations

import argparse

from ddl25spring_tpu_torch.data.mnist import _find_idx_dir
from ddl25spring_tpu_torch.fl import FedAvgServer, FedSgdGradientServer

# (server, N, C) -> the golden final accuracy of series01.ipynb cell 20
GOLDEN = {
    ("FedAvg", 10, 0.1): 0.932,
    ("FedSGD", 10, 0.1): 0.4287,
}


def main(argv=None) -> list[dict]:
    """Print the table; returns its rows ``{server, N, C, final_acc, golden}``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--ns", type=int, nargs="+", default=[10, 50, 100])
    ap.add_argument("--cs", type=float, nargs="+", default=[0.01, 0.1, 0.2])
    ap.add_argument("--quick", action="store_true",
                    help="N=10 C=0.1 cell only (the headline golden pair)")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the servers on the host")
    args = ap.parse_args(argv)

    idx_dir = _find_idx_dir()
    print(f"# data: REAL MNIST ({idx_dir})" if idx_dir is not None else
          "# data: SYNTHETIC stand-in — golden values NOT expected to match; "
          "set DDL25_MNIST_DIR")
    print(f"# config: lr=0.01 E=1 seed=10 rounds={args.rounds} (series01.ipynb cell 20), "
          f"device={args.device}")
    grid = [(10, 0.1)] if args.quick else [(n, c) for n in args.ns for c in args.cs]
    print(f"{'server':>7} {'N':>4} {'C':>5} {'final_acc':>9} {'golden':>7}")
    rows = []
    for cls, name in ((FedAvgServer, "FedAvg"), (FedSgdGradientServer, "FedSGD")):
        for n, c in grid:
            server = cls(nr_clients=n, client_fraction=c,
                         batch_size=-1 if cls is FedSgdGradientServer else 100,
                         nr_local_epochs=1, lr=0.01, seed=10, device=args.device)
            acc = float(server.run(args.rounds).test_accuracy[-1])
            g = GOLDEN.get((name, n, c))
            gs = f"{g:.4f}" if g is not None else "-"
            print(f"{name:>7} {n:>4} {c:>5} {acc:>9.4f} {gs:>7}", flush=True)
            rows.append({"server": name, "N": n, "C": c, "final_acc": acc, "golden": g})
    if idx_dir is None:
        print("# synthetic run complete; the table above is a smoke check, "
              "not the golden artifact")
    return rows


if __name__ == "__main__":
    main()
