"""Homework B2 on PyTorch: the 2 x 3 DP x PP LLaMA, one process per rank.

The counterpart of ``lab/s01_b2_dp_pp.py --workload llama`` (``run_llama``,
:90-226): two pipelines of three stages, ranks ``0..2`` and ``3..5``, the DP
group of each stage ``[0, 3] / [1, 4] / [2, 5]``; the workload constants
(vocab 4096, dmodel 288, 6 heads, 6 layers, ctx 256), 3 rows per replica in
3 microbatches, Adam 8e-4 (``utils/config.py`` ``DpPpConfig``).  Each rank holds one
:class:`~ddl25spring_tpu_torch.models.llama.LlamaStage` and runs the GPipe
step of :mod:`~ddl25spring_tpu_torch.parallel.pipeline`.  Every rank reads
the same global TinyStories stream and takes its own rows of it.

On CUDA the ranks compute in bf16 over float32 parameters, attention through
the flash-attention kernels (``--no-flash``: dense); the backend follows the
layout (:func:`~ddl25spring_tpu_torch.utils.mesh.select_backend`): six ranks
on one card talk over gloo through pinned host buffers.  ``--device cpu``
runs them on the host in float32, the kernels' plain versions in their place.

Prints the loss of every iteration (the last stage of pipeline 0), then the
tokens per second.  Under ``torchrun --nproc-per-node 6`` each process is one
rank; otherwise the ranks are spawned here.

Run: ``python -m ddl25spring_tpu_torch.lab.dp_pp [--iters 20] [--device cuda]``
"""

from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from ddl25spring_tpu_torch.data.tinystories import TinyStories
from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
from ddl25spring_tpu_torch.ops import flash_attention as fa
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.parallel.pipeline import (
    SCHEDULES,
    check_schedule,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import DpPpConfig, LlamaConfig
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.mesh import init_mesh


@dataclass(frozen=True)
class Job:
    """What every rank of one run does."""

    cfg: LlamaConfig
    data: int
    stages: int
    microbatches: int
    batch: int                  # global rows per step: microbatches x data x rows
    iters: int
    lr: float = 8e-4
    seed: int = 0
    device: str = "cuda"
    params: dict | None = None  # full or staged numpy pytree; None: Llama(seed)'s
    batches: list | None = None  # global [batch, ctx] token batches; None: TinyStories
    export: bool = False        # return the first step's gradients and the last params
    log: bool = True


def run_rank(rdv, job: Job) -> dict:
    """One rank of ``job``: its stage's training loop.  Returns its
    coordinates, device and backend, the losses (last stage only), each
    step's host time (to the card's idle), its comm counts per step
    (:meth:`~ddl25spring_tpu_torch.parallel.comm.Comm.take_stats`), its flash
    kernel launches and, with ``job.export``, its stage's gradients after the
    first step and parameters after the last."""
    cfg = job.cfg
    with init_mesh(rdv, job.data, job.stages, job.device) as mesh:
        params = job.params
        if params is None:
            params = export_params(Llama(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(job.seed)))
        stage = shard_staged_params(params, cfg, mesh)
        opt = torch.optim.Adam(stage.parameters(), lr=job.lr)
        step = make_pipeline_train_step(stage, cfg, opt, mesh, job.microbatches)
        if job.batches is not None:
            batches = iter(job.batches)
        else:
            batches = iter(TinyStories(get_tokenizer(), batch_size=job.batch,
                                       seq_l=cfg.ctx_size, seed=job.seed))
        d, s = mesh.coords
        out = {"rank": mesh.rank, "coords": (d, s), "device": str(mesh.device),
               "backend": mesh.backend, "losses": [], "step_s": [], "comm": []}
        fa.reset_launches()
        mesh.comm.take_stats()
        for it in range(job.iters):
            tokens = torch.from_numpy(np.asarray(next(batches))).long()
            t0 = time.perf_counter()
            loss = step(tokens)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            out["step_s"].append(time.perf_counter() - t0)
            out["comm"].append(mesh.comm.take_stats())
            if loss is not None:
                out["losses"].append(float(loss))
                if job.log and d == 0:
                    print(f"iter {it:3d}  loss {out['losses'][-1]:.4f}  "
                          f"step {out['step_s'][-1] * 1e3:.2f} ms", flush=True)
            if job.export and it == 0:
                out["grads"] = export_grads(stage)
        out["launches"] = dict(fa.LAUNCHES)
        out["launches_by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        if job.export:
            out["params"] = export_params(stage)
        return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=("llama", "resnet"), default="llama")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--schedule", choices=SCHEDULES, default="gpipe")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true",
                    help="dense attention instead of the flash kernels")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the spawned ranks are killed")
    return ap.parse_args(argv)


def main(argv=None, layout: DpPpConfig = DpPpConfig()) -> dict:
    """Train ``layout`` (default: the reference's 2 x 3) and print; returns
    ``{"losses", "step_s", "tokens_per_s", "ranks"}``: the logging rank's
    losses and step times, and every rank's result from :func:`run_rank`
    (only this process's under torchrun)."""
    args = parse_args(argv)
    if args.workload == "resnet":
        raise NotImplementedError("--workload resnet is not ported yet (ROADMAP A6)")
    check_schedule(args.schedule)
    device = resolve_device(args.device)
    cfg = LlamaConfig(ctx_size=args.seq_len,
                      dtype="bfloat16" if device.type == "cuda" else "float32",
                      use_flash=not args.no_flash)
    D, S, M = layout.data, layout.num_stages, layout.num_microbatches
    job = Job(cfg, D, S, M, batch=D * layout.per_replica_batch, iters=args.iters,
              lr=layout.learning_rate, seed=args.seed, device=device.type)
    print(f"llama DPxPP: {D} x {S} ranks, {M} microbatches, {layout.per_replica_batch} rows "
          f"per replica, ctx {args.seq_len}, {cfg.dtype}, "
          f"attention={'flash' if cfg.use_flash else 'dense'}, device={device.type}",
          flush=True)
    ranks = spawn(run_rank, D * S, job, timeout=args.timeout)
    log = ranks[S - 1] or next(r for r in ranks if r)
    step_s = log["step_s"]
    timed = step_s[1:] or step_s  # the first step warms up (kernel loads, allocator)
    tokens_per_s = job.batch * args.seq_len * len(timed) / sum(timed)
    print(f"backend {log['backend']}; done: {len(step_s)} steps, {tokens_per_s:.1f} "
          f"tokens/s after the first (median step {statistics.median(timed) * 1e3:.2f} ms)",
          flush=True)
    return {"losses": log["losses"], "step_s": step_s, "tokens_per_s": tokens_per_s,
            "ranks": ranks}


if __name__ == "__main__":
    main()
