"""Homework 1, part A1, on PyTorch: FedSGD-with-gradients ==
FedSGD-with-weights.  The counterpart of ``examples/homework1_a1_equivalence.py``.

Shipping *gradients* (``FedSgdGradientServer``) must match shipping
*weights* (``FedAvgServer`` with full-batch clients and one local epoch) to
within 0.02 % test accuracy per round (``lab/series01.ipynb`` cells 9-12).
It holds with dropout on: both servers draw each client's first masks from
the same per-(round, client) generator, and one full-batch SGD step followed
by the weighted average of the weights is linear in the gradients.

Run: ``python -m ddl25spring_tpu_torch.examples.homework1_a1_equivalence
[--rounds 10] [--clients 10] [--n-train 1000] [--device cpu]``; exits 1 if
the tolerance fails.
"""

from __future__ import annotations

import argparse

from ddl25spring_tpu_torch.data.mnist import load_mnist
from ddl25spring_tpu_torch.fl import FedAvgServer, FedSgdGradientServer

TOLERANCE = 2e-4  # the homework's 0.02 %


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--fraction", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=10)  # homework-mandated seed
    ap.add_argument("--n-train", type=int, default=0,
                    help="subsample the train set (0 = full 60k); the "
                         "equivalence holds at any size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = None
    if args.n_train:
        data = load_mnist(n_train=args.n_train, n_test=2000)
        print(f"# reduced dataset: n_train={args.n_train}, n_test=2000")

    common = dict(nr_clients=args.clients, client_fraction=args.fraction, lr=args.lr,
                  seed=args.seed, data=data, device=args.device)
    # scenario per series01.ipynb cell 12: weights variant = FedAvg with
    # batch_size=len(data) (B=-1) and E=1
    grad_server = FedSgdGradientServer(batch_size=-1, nr_local_epochs=1, **common)
    weight_server = FedAvgServer(batch_size=-1, nr_local_epochs=1, **common)

    print(f"{'round':>5} {'grad acc':>9} {'weight acc':>10} {'|delta|':>8}")
    worst = 0.0
    for r in range(args.rounds):
        grad_server.round(r)
        weight_server.round(r)
        ga = grad_server.test_accuracy()
        wa = weight_server.test_accuracy()
        worst = max(worst, abs(ga - wa))
        print(f"{r:>5} {ga:>9.4f} {wa:>10.4f} {abs(ga - wa):>8.5f}")

    verdict = "PASS" if worst <= TOLERANCE else "FAIL"
    print(f"max |delta| = {worst:.6f} (tolerance {TOLERANCE}) -> {verdict}")
    return 0 if worst <= TOLERANCE else 1


if __name__ == "__main__":
    raise SystemExit(main())
