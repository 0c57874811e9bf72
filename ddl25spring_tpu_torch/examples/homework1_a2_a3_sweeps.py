"""Homework 1, parts A2/A3, on PyTorch: the FL hyperparameter sweeps.  The
counterpart of ``examples/homework1_a2_a3_sweeps.py``.

The solved homework's experiment grid (``lab/series01.ipynb`` cells 13-38)
over the ported servers:

- A2: the number of clients N in {10, 50, 100} and the client fraction C in
  {0.01, 0.1, 0.2}, for FedSGD and FedAvg (golden table: FedAvg N=10 C=0.1
  reaches 93.2 % after 10 rounds on real MNIST, ``series01.ipynb`` cell 20);
- A3: local epochs E in {1, 5, 10}, IID and non-IID splits.

Prints each run's final test accuracy and message count.  Without the MNIST
files the synthetic set stands in, on which every configuration saturates;
``--data digits`` takes sklearn's bundled UCI handwritten digits instead,
real data on which the sweeps separate.

Run: ``python -m ddl25spring_tpu_torch.examples.homework1_a2_a3_sweeps
[--rounds 10] [--quick] [--only a2|a3] [--server fedsgd|fedavg] [--data digits]
[--device cpu]``
"""

from __future__ import annotations

import argparse

from ddl25spring_tpu_torch.data.mnist import load_digits_28x28, load_mnist
from ddl25spring_tpu_torch.fl import FedAvgServer, FedSgdGradientServer


def run_one(server_cls, rounds: int, data, device, **kw):
    return server_cls(data=data, device=device, **kw).run(rounds)


def sweep_a2(rounds: int, ns, cs, lr: float, seed: int, data, device,
             server: str = "both") -> list[dict]:
    pairs = [(FedSgdGradientServer, "FedSGD"), (FedAvgServer, "FedAvg")]
    if server != "both":
        pairs = [p for p in pairs if p[1].lower() == server]
    rows = []
    for cls, name in pairs:
        batch = -1 if cls is FedSgdGradientServer else 100
        for label, grid in ((f"client-count sweep (C=0.1)", [(n, 0.1) for n in ns]),
                            (f"participation sweep (N={ns[-1]})", [(ns[-1], c) for c in cs])):
            print(f"\n=== A2 {name}: {label} ===")
            for n, c in grid:
                res = run_one(cls, rounds, data, device, nr_clients=n, client_fraction=c,
                              batch_size=batch, nr_local_epochs=1, lr=lr, seed=seed)
                key = f"N={n:>4}" if "client-count" in label else f"C={c:>5}"
                print(f"{key}: final acc {res.test_accuracy[-1]:.4f}  "
                      f"msgs {res.message_count[-1]}", flush=True)
                rows.append({"part": "a2", "server": name, "N": n, "C": c,
                             "accuracy": res.test_accuracy, "messages": res.message_count})
    return rows


def sweep_a3(rounds: int, es, lr: float, seed: int, data, device) -> list[dict]:
    print("\n=== A3 FedAvg: local-epoch and IID sweep (N=10, C=0.1) ===")
    rows = []
    for iid in (True, False):
        for e in es:
            res = run_one(FedAvgServer, rounds, data, device, nr_clients=10,
                          client_fraction=0.1, batch_size=100, nr_local_epochs=e, lr=lr,
                          seed=seed, iid=iid)
            print(f"iid={str(iid):>5} E={e:>2}: final acc {res.test_accuracy[-1]:.4f}",
                  flush=True)
            rows.append({"part": "a3", "server": "FedAvg", "iid": iid, "E": e,
                         "accuracy": res.test_accuracy, "messages": res.message_count})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--quick", action="store_true", help="small grid for a fast smoke run")
    ap.add_argument("--n-train", type=int, default=0,
                    help="subsample the train set (0 = all of it); accuracies shift "
                         "accordingly, so state it beside any result")
    ap.add_argument("--n-test", type=int, default=0)
    ap.add_argument("--only", choices=("all", "a2", "a3"), default="all",
                    help="run a part of the grid")
    ap.add_argument("--server", choices=("both", "fedsgd", "fedavg"), default="both",
                    help="A2: one server family only")
    ap.add_argument("--data", choices=("mnist", "digits"), default="mnist",
                    help="'digits': the real UCI handwritten digits bundled with sklearn, "
                         "upsampled to 28x28")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = None
    if args.data == "digits":
        data = load_digits_28x28(n_train=args.n_train or 1437, n_test=args.n_test or 360)
        print("# REAL data: UCI handwritten digits (sklearn bundled), "
              f"n_train={len(data['y_train'])}, n_test={len(data['y_test'])}")
    elif args.n_train:
        data = load_mnist(n_train=args.n_train, n_test=args.n_test or 2000)
        print(f"# reduced dataset: n_train={args.n_train}, n_test={args.n_test or 2000}")

    if args.quick:
        ns, cs, es, rounds = [10, 50], [0.1, 0.2], [1, 5], min(args.rounds, 3)
    else:
        ns, cs, es, rounds = [10, 50, 100], [0.01, 0.1, 0.2], [1, 5, 10], args.rounds
    rows = []
    if args.only in ("all", "a2"):
        rows += sweep_a2(rounds, ns, cs, args.lr, args.seed, data, args.device, args.server)
    if args.only in ("all", "a3"):
        rows += sweep_a3(rounds, es, args.lr, args.seed, data, args.device)
    return rows


if __name__ == "__main__":
    main()
