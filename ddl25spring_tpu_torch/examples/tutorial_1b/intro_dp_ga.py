"""Tutorial 1b, DP by gradient aggregation, on PyTorch.  The counterpart of
``examples/tutorial_1b/intro_dp_ga.py``.

The reference (``lab/tutorial_1b/DP/gradient_aggr/intro_DP_GA.py:41-68``)
runs one process per rank: after ``backward()`` it all-reduces the
gradients (SUM over gloo), divides them by the world size and steps.  Here
each of ``--ranks`` spawned processes runs
:func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step` on its rows of
one global TinyStories stream (the full-width LLaMA, Adam 8e-4), the
gradients averaged in flat buckets.  On CUDA the ranks compute in bf16 with
the flash kernels; ranks that share a card talk over gloo through pinned
host buffers.

Run: ``python -m ddl25spring_tpu_torch.examples.tutorial_1b.intro_dp_ga
[--iters 20] [--ranks 2] [--device cpu]``
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ddl25spring_tpu_torch.data.tinystories import TinyStories
from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
from ddl25spring_tpu_torch.models.llama import Llama
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step, make_dp_weight_avg_step
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.utils.config import LlamaConfig
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.mesh import init_mesh


@dataclass(frozen=True)
class DpJob:
    ranks: int
    per_replica_batch: int
    seq_len: int
    lr: float
    iters: int
    seed: int
    device: str
    weight_avg: bool


def dp_rank(rdv, job: DpJob) -> dict:
    """One replica's training loop; rank 0 prints the loss of every step."""
    with init_mesh(rdv, job.ranks, 1, job.device) as mesh:
        cfg = LlamaConfig(ctx_size=job.seq_len,
                          dtype="bfloat16" if mesh.device.type == "cuda" else "float32")
        model = Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(job.seed))
        make = make_dp_weight_avg_step if job.weight_avg else make_dp_train_step
        step = make(model, lambda m, t: causal_lm_loss(m(t), t),
                    torch.optim.Adam(model.parameters(), lr=job.lr), mesh)
        # one global stream, each replica taking its rows: the counterpart of
        # the reference's disjoint skip=rank*N streams (intro_DP_GA.py:29)
        ds = iter(TinyStories(get_tokenizer(), batch_size=job.per_replica_batch * job.ranks,
                              seq_l=job.seq_len, seed=job.seed))
        losses = []
        for it in range(job.iters):
            losses.append(float(step(torch.from_numpy(np.asarray(next(ds))).long())))
            if mesh.rank == 0:
                print(f"iter {it:3d}  loss {losses[-1]:.4f}", flush=True)
        return {"losses": losses, "device": str(mesh.device), "backend": mesh.backend}


def run(argv, weight_avg: bool, doc: str) -> dict:
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--per-replica-batch", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=8e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    job = DpJob(args.ranks, args.per_replica_batch, args.seq_len, args.lr, args.iters,
                args.seed, device.type, weight_avg)
    print(f"DP {'weight averaging' if weight_avg else 'gradient aggregation'} over "
          f"{args.ranks} ranks, device={device.type}", flush=True)
    ranks = spawn(dp_rank, args.ranks, job)
    return {"losses": ranks[0]["losses"], "ranks": ranks}


def main(argv=None) -> dict:
    return run(argv, weight_avg=False, doc=__doc__)


if __name__ == "__main__":
    main()
