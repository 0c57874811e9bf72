"""Homework B2 on PyTorch: the 2 x 3 DP x PP LLaMA and the ResNet-18/CIFAR-10
benchmark step, one process per rank.

``--workload llama`` (the default) is the counterpart of
``lab/s01_b2_dp_pp.py --workload llama`` (``run_llama``, :90-226): two
pipelines of three stages, ranks ``0..2`` and ``3..5``, the DP group of each
stage ``[0, 3] / [1, 4] / [2, 5]``; the workload constants
(vocab 4096, dmodel 288, 6 heads, 6 layers, ctx 256), 3 rows per replica in
3 microbatches, Adam 8e-4 (``utils/config.py`` ``DpPpConfig``).  Each rank holds one
:class:`~ddl25spring_tpu_torch.models.llama.LlamaStage` (``--chunks V``
of them under an interleaved schedule) and runs the step of
:mod:`~ddl25spring_tpu_torch.parallel.pipeline` under ``--schedule``
(``gpipe``, ``1f1b``, ``1f1b-stash``, ``interleaved``,
``interleaved-1f1b``; ``--chunks`` defaults to 2 and only the interleaved
schedules read it).  ``--scan-steps K > 1`` (the JAX ``fuse_train_steps``)
is not ported and raises.  Every rank reads the same global TinyStories
stream and takes its own rows of it.

On CUDA the ranks compute in bf16 over float32 parameters, attention through
the flash-attention kernels (``--no-flash``: dense); the backend follows the
layout (:func:`~ddl25spring_tpu_torch.utils.mesh.select_backend`): six ranks
on one card talk over gloo through pinned host buffers.  ``--device cpu``
runs them on the host in float32, the kernels' plain versions in their place.

Prints the loss of every iteration (the last stage of pipeline 0), then the
tokens per second.  Under ``torchrun --nproc-per-node 6`` each process is one
rank; otherwise the ranks are spawned here.  Either way one rank reports, the
last stage of pipeline 0, with each step's seconds the slowest rank's
(:func:`world_totals`).

``--workload resnet`` is the counterpart of ``run_resnet``
(``lab/s01_b2_dp_pp.py:228-326``): the north-star step of
:func:`~ddl25spring_tpu_torch.benchmarks.build_resnet_step` over ``N`` ranks
(``--ranks``; default one per card, one on the CPU), pure DP
(``data = N``) or, with ``--pp``, the 2-stage heterogeneous pipeline x DP
(``data = N // 2``, 2 microbatches).  Batch 1024 per rank on CUDA (bf16) and
4 on the CPU (float32), SGD 0.1 with momentum 0.9, the CIFAR-10 train split
on the device (:class:`~ddl25spring_tpu_torch.benchmarks.DeviceDataset`;
``--input fixed``: one batch re-fed).  3 warm-up steps (the first counts
the step's FLOPs), then ``--iters`` timed ones (default 30) through
:func:`~ddl25spring_tpu_torch.benchmarks.timed_run`; prints the loss every
``--log-every`` steps (read after the timed window), samples/s and TFLOP/s
per card (ranks that share a card count it once), MFU, and
``report_line``'s JSON as its last line, from one rank, the last stage of
pipeline 0: the FLOPs are the whole world's step, the seconds the slowest
rank's (:func:`world_totals`), under ``torchrun`` as when spawned.  One
rank runs in this process; more are spawned (``--ranks N`` shares the
cards, or the CPU, between N processes: the port's form of
``--force-cpu-devices N``).  On CUDA the run sets
``torch.backends.cudnn.benchmark`` and turns TF32 off (:data:`RUN_FLAGS`),
and puts both back after.

Run: ``python -m ddl25spring_tpu_torch.lab.dp_pp [--iters 20] [--device cuda]
[--schedule interleaved-1f1b --chunks 2]``
     ``python -m ddl25spring_tpu_torch.lab.dp_pp --workload resnet [--pp --ranks 4]``
"""

from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ddl25spring_tpu_torch import benchmarks
from ddl25spring_tpu_torch.data.tinystories import TinyStories
from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
from ddl25spring_tpu_torch.ops import flash_attention as fa
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.parallel.pipeline import (
    INTERLEAVED,
    SCHEDULES,
    check_layout,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import DpPpConfig, LlamaConfig
from ddl25spring_tpu_torch.utils.device import backend_flags, resolve_device
from ddl25spring_tpu_torch.utils.flops import count_flops, mfu
from ddl25spring_tpu_torch.utils.mesh import cards_used, init_mesh


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
    schedule: str = "gpipe"
    chunks: int = 1             # layer chunks per rank (the interleaved schedules)


def world_totals(mesh, flops: int, seconds: list[float]) -> tuple[int, list[float]]:
    """``flops`` summed and each of ``seconds`` maxed over every rank of
    ``mesh``'s world: the whole step's FLOPs (each stage counts its own
    share), and the time of the slowest rank.  Every rank must call it."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    total = torch.tensor([flops], dtype=torch.int64, device=dev)
    slowest = torch.tensor(seconds, dtype=torch.float64, device=dev)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return int(total.item()), slowest.tolist()


def reporting_rank(ranks: list, stages: int) -> dict | None:
    """The result that reports a run: the last stage of pipeline 0's, if this
    process holds it (a spawned run holds every rank's; a rank under
    ``torchrun`` only its own), else None."""
    return next((r for r in ranks if r is not None and r["coords"] == (0, stages - 1)), None)


def run_rank(rdv, job: Job) -> dict:
    """One rank of ``job``: its stage's training loop.  Returns its
    coordinates, device and backend, the losses (last stage only), each
    step's host time (to the card's idle) and the slowest rank's
    (``world_step_s``), its comm counts per step
    (:meth:`~ddl25spring_tpu_torch.parallel.comm.Comm.take_stats`), its flash
    kernel launches and, with ``job.export``, its stage's gradients after the
    first step and parameters after the last."""
    cfg = job.cfg
    with init_mesh(rdv, job.data, job.stages, job.device) as mesh:
        params = job.params
        if params is None:
            params = export_params(Llama(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(job.seed)))
        stage = shard_staged_params(params, cfg, mesh, job.chunks)
        opt = torch.optim.Adam(stage.parameters(), lr=job.lr)
        step = make_pipeline_train_step(stage, cfg, opt, mesh, job.microbatches,
                                        job.schedule, job.chunks)
        if job.batches is not None:
            batches = iter(job.batches)
        else:
            batches = iter(TinyStories(get_tokenizer(), batch_size=job.batch,
                                       seq_l=cfg.ctx_size, seed=job.seed))
        d, s = mesh.coords
        out = {"rank": mesh.rank, "coords": (d, s), "device": str(mesh.device),
               "backend": mesh.backend, "losses": [], "step_s": [], "comm": [],
               "stash_max": []}
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
            out["stash_max"].append(step.stats["stash_max"])
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
        _, out["world_step_s"] = world_totals(mesh, 0, out["step_s"])
        return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=("llama", "resnet"), default="llama")
    ap.add_argument("--iters", type=int, default=0,
                    help="0 = the workload's default (llama 20, resnet 30)")
    ap.add_argument("--schedule", choices=SCHEDULES, default="gpipe",
                    help="llama: the pipeline schedule")
    ap.add_argument("--chunks", type=int, default=2, metavar="V",
                    help="llama, interleaved schedules: layer chunks per rank (needs "
                         "microbatches %% stages == 0 and n_layers %% (stages*V) == 0)")
    ap.add_argument("--scan-steps", type=int, default=1, metavar="K",
                    help="llama: train steps per dispatch; only 1 is ported")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true",
                    help="dense attention instead of the flash kernels")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the spawned ranks are killed")
    ap.add_argument("--pp", action="store_true",
                    help="resnet: the 2-stage heterogeneous pipeline x DP")
    ap.add_argument("--ranks", type=int, default=0,
                    help="resnet: rank processes; 0 = one per card (one on the CPU)")
    ap.add_argument("--batch", type=int, default=0,
                    help="resnet: global batch; 0 = 1024 per rank on CUDA, 4 on the CPU")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="resnet: microbatches under --pp; 0 = 2")
    ap.add_argument("--lr", type=float, default=0.0, help="resnet: 0 = 0.1")
    ap.add_argument("--input", choices=("hbm", "fixed"), default="hbm",
                    help="resnet: 'hbm' = the train split on the device, reshuffled "
                         "per epoch; 'fixed' = one batch re-fed")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None, layout: DpPpConfig = DpPpConfig()) -> dict:
    """Train ``layout`` (default: the reference's 2 x 3) and print; returns
    ``{"losses", "step_s", "tokens_per_s", "ranks"}``: the reporting rank's
    losses and the slowest rank's step times (:func:`reporting_rank`,
    :func:`world_totals`), and every rank's result from :func:`run_rank`
    (only this process's under torchrun, where a rank that does not report
    prints nothing after the header and returns ``{"ranks"}`` alone)."""
    args = parse_args(argv)
    if args.workload == "resnet":
        return run_resnet(args)
    if args.scan_steps > 1:
        raise NotImplementedError(
            f"--scan-steps {args.scan_steps}: fusing K train steps per dispatch (the JAX "
            "fuse_train_steps; its port is a CUDA graph of the step) is not ported yet "
            "(ROADMAP A5-next 5)")
    args.iters = args.iters or 20
    D, S, M = layout.data, layout.num_stages, layout.num_microbatches
    V = args.chunks if args.schedule in INTERLEAVED else 1
    check_layout(args.schedule, S, V, M)
    device = resolve_device(args.device)
    cfg = LlamaConfig(ctx_size=args.seq_len,
                      dtype="bfloat16" if device.type == "cuda" else "float32",
                      use_flash=not args.no_flash)
    if cfg.n_layers % (S * V):
        raise ValueError(f"{cfg.n_layers} layers not divisible by S*V = {S}*{V}")
    job = Job(cfg, D, S, M, batch=D * layout.per_replica_batch, iters=args.iters,
              lr=layout.learning_rate, seed=args.seed, device=device.type,
              schedule=args.schedule, chunks=V)
    print(f"llama DPxPP: {D} x {S} ranks, {M} microbatches, {layout.per_replica_batch} rows "
          f"per replica, ctx {args.seq_len}, {cfg.dtype}, "
          f"attention={'flash' if cfg.use_flash else 'dense'}, schedule {args.schedule}"
          + (f" ({V} chunks per rank)" if V > 1 else "") + f", device={device.type}",
          flush=True)
    ranks = spawn(run_rank, D * S, job, timeout=args.timeout)
    log = reporting_rank(ranks, S)
    if log is None:
        return {"ranks": ranks}
    step_s = log["world_step_s"]
    timed = step_s[1:] or step_s  # the first step warms up (kernel loads, allocator)
    tokens_per_s = job.batch * args.seq_len * len(timed) / sum(timed)
    print(f"backend {log['backend']}; done: {len(step_s)} steps, {tokens_per_s:.1f} "
          f"tokens/s after the first (median step {statistics.median(timed) * 1e3:.2f} ms)",
          flush=True)
    return {"losses": log["losses"], "step_s": step_s, "tokens_per_s": tokens_per_s,
            "ranks": ranks}



# ------------------------------------------------------------------ resnet

WARMUP = 3


@dataclass(frozen=True)
class ResnetJob:
    """What every rank of one ResNet run does."""

    data: int
    stages: int
    microbatches: int
    batch: int                   # global rows per step
    iters: int                   # timed steps, after WARMUP warm-up steps
    lr: float = 0.1
    seed: int = 0
    device: str = "cuda"
    input: str = "hbm"           # "hbm": DeviceDataset.feed; "fixed": its first batch


# the timed ResNet run: cuDNN autotunes its convolutions, TF32 off
RUN_FLAGS = dict(cudnn_benchmark=True, cudnn_tf32=False, matmul_tf32=False)


def train_resnet(mesh, job: ResnetJob) -> dict:
    """One rank's ResNet run (``mesh`` None: one process alone).  Returns its
    coordinates, device, backend, layout, boundary shapes and parameter
    count; the losses of every step (last stage only); the timed seconds and
    each timed step's seconds; the FLOPs of its first step; its comm counts
    over the timed steps; and where its parameters and its dataset live."""
    dev = mesh.device if mesh is not None else resolve_device(job.device)
    with backend_flags(**RUN_FLAGS):
        step, module, _, meta = benchmarks.build_resnet_step(
            mesh, job.microbatches, job.batch, lr=job.lr, device=dev, seed=job.seed)
        fixed = job.input == "fixed"
        ds = benchmarks.DeviceDataset(job.batch, n_train=job.batch if fixed else None,
                                      device=dev)
        feed = (lambda: ds.fixed) if fixed else ds.feed
        comm = mesh.comm if mesh is not None else None
        first, flops = count_flops(step, feed())
        _, warm, _ = benchmarks.timed_run(step, feed, 0, WARMUP - 1, device=dev)
        if comm is not None:
            comm.take_stats()
        dt, timed, step_s = benchmarks.timed_run(step, feed, job.iters, 0, device=dev)
        return {
            "rank": mesh.rank if mesh is not None else 0,
            "coords": mesh.coords if mesh is not None else (0, 0),
            "device": str(dev), "backend": mesh.backend if mesh is not None else None,
            "layout": meta["layout"], "topology": meta["topology"],
            "input": "fixed-device-batch" if fixed else ds.input_mode,
            "boundary_shapes": meta["boundary_shapes"], "n_params": meta["n_params"],
            "losses": ([] if first is None else [float(first)]) + warm + timed,
            "dt": dt, "step_s": step_s, "flops": flops,
            "comm": comm.take_stats() if comm is not None else None,
            "params_device": sorted({str(p.device) for p in module.parameters()}),
            "data_device": str(ds.x.device),
        }


def resnet_rank(rdv, job: ResnetJob) -> dict:
    """One spawned rank of a ResNet run: joins the ``data x stages`` world,
    runs :func:`train_resnet`, and adds the world's FLOPs per step and
    timed seconds (:func:`world_totals`) as ``world_flops`` and
    ``world_dt``."""
    with init_mesh(rdv, job.data, job.stages, job.device) as mesh:
        out = train_resnet(mesh, job)
        out["world_flops"], (out["world_dt"],) = world_totals(mesh, out["flops"], [out["dt"]])
        return out


def run_resnet(args) -> dict:
    """``--workload resnet``: lay out the ranks, run them, print the losses,
    samples/s and TFLOP/s per card (ranks that share a card count as one
    card: :func:`~ddl25spring_tpu_torch.utils.mesh.cards_used`), MFU and
    ``report_line``, from the reporting rank (:func:`report_resnet`).
    Returns ``{"ranks", "samples_per_s_per_chip", "cards", "flops",
    "tflops", "mfu", "line"}``, or under torchrun, on a rank that does not
    report, ``{"ranks"}`` alone."""
    device = resolve_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 1)
    dp, S = (n // 2, 2) if args.pp and n >= 2 else (n, 1)
    n_used = dp * S
    M = (args.microbatches or 2) if S == 2 else 1
    batch = args.batch or (1024 if device.type == "cuda" else 4) * n_used
    batch = batch // (dp * M) * (dp * M)
    job = ResnetJob(dp, S, M, batch, args.iters or 30, lr=args.lr or 0.1, seed=args.seed,
                    device=device.type, input=args.input)
    print(f"resnet18/cifar10: mesh(data={dp}, stage={S}), microbatches={M}, global "
          f"batch={batch}, {n_used} rank(s), input={args.input}, device={device.type}",
          flush=True)
    if n_used == 1:
        r = train_resnet(None, job)
        ranks = [{**r, "world_flops": r["flops"], "world_dt": r["dt"]}]
    else:
        ranks = spawn(resnet_rank, n_used, job, timeout=args.timeout)
    report = report_resnet(ranks, job, cards_used(n_used, device.type), device, args.log_every)
    return {"ranks": ranks, **(report or {})}


def report_resnet(ranks: list, job: ResnetJob, cards: int, device, log_every: int = 10):
    """Print a ResNet run's losses, rates and ``report_line`` from the
    reporting rank (:func:`reporting_rank`) with the world's FLOPs and
    slowest seconds (``world_flops``, ``world_dt``); returns its numbers, or
    None (printing nothing) where this process does not hold that rank."""
    log = reporting_rank(ranks, job.stages)
    if log is None:
        return None
    for i, loss in enumerate(log["losses"]):
        if log_every and i % log_every == 0:
            print(f"iter {i:4d}  loss {loss:.4f}", flush=True)
    dt, flops = log["world_dt"], log["world_flops"]
    sps_chip = job.iters * job.batch / dt / cards
    tf, frac = mfu(flops, dt / job.iters, cards, device)
    print(f"{log['topology']}: {job.iters} timed steps in {dt:.3f} s (median step "
          f"{statistics.median(log['step_s']) * 1e3:.3f} ms), {sps_chip:.1f} samples/s per "
          f"card, {flops / 1e12:.4f} TFLOP per step", flush=True)
    if tf is not None:
        print(f"achieved {tf:.2f} TFLOP/s per card" + (f" (MFU {frac:.2%})" if frac is not None
                                                       else ""), flush=True)
    line = benchmarks.report_line(log["layout"], sps_chip, log["input"], frac, tf)
    print(line, flush=True)
    return {"samples_per_s_per_chip": sps_chip, "cards": cards, "flops": flops, "tflops": tf,
            "mfu": frac, "line": line}


if __name__ == "__main__":
    main()
