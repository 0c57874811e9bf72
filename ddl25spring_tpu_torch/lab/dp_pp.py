"""Homework B2 on PyTorch: the 2 x 3 DP x PP LLaMA and the ResNet-18/CIFAR-10
benchmark step, one process per rank.

``--workload resnet`` (the default, as in ``lab/s01_b2_dp_pp.py:34``: the
BASELINE benchmark config, ``lab/run-b2.sh:7-9``) is described below.

``--workload llama`` is the counterpart of
``lab/s01_b2_dp_pp.py --workload llama`` (``run_llama``, :90-226): two
pipelines of three stages, ranks ``0..2`` and ``3..5``, the DP group of each
stage ``[0, 3] / [1, 4] / [2, 5]``; the workload constants
(vocab = the tokenizer's, as ``lab/s01_b2_dp_pp.py:117-121`` sizes it: 259
with the byte tokenizer; dmodel 288, 6 heads, 6 layers, ctx 256), 3 rows
per replica in
3 microbatches, Adam 8e-4 (``utils/config.py`` ``DpPpConfig``), 200 steps;
``--batch`` (global), ``--microbatches``, ``--lr`` and ``--iters`` change
them with the JAX lab's meanings (:func:`llama_job`).  Each rank holds one
:class:`~ddl25spring_tpu_torch.models.llama.LlamaStage` (``--chunks V``
of them under an interleaved schedule) and runs the step of
:mod:`~ddl25spring_tpu_torch.parallel.pipeline` under ``--schedule``
(``gpipe``, ``1f1b``, ``1f1b-stash``, ``interleaved``,
``interleaved-1f1b``; ``--chunks`` defaults to 2 and only the interleaved
schedules read it).  ``--scan-steps K`` fuses K train steps per dispatch
(:func:`~ddl25spring_tpu_torch.parallel.pipeline.fuse_train_steps`, the
rule of ``lab/s01_b1_microbatches.py:147-160``): ``--iters`` becomes a
multiple of K, and the first dispatch, which builds the fused program,
stays out of the rate.  On the CPU it is a loop of K steps; on the card it
is one CUDA graph, which these ranks cannot be: they share the card over
gloo through host buffers (or talk over NCCL, whose capture is not ported),
so the default (0: 16 on the card, 1 on the CPU, as in JAX) resolves to 1
there, the header says why, and an explicit K > 1 raises
(:func:`llama_scan_steps`).  Every rank reads the same global TinyStories
stream and takes its own rows of it.

On CUDA the ranks compute in bf16 over float32 parameters, attention through
the flash-attention kernels (``--no-flash``: dense); the backend follows the
layout (:func:`~ddl25spring_tpu_torch.utils.mesh.select_backend`): six ranks
on one card talk over gloo through pinned host buffers.  ``--device cpu``
runs them on the host in float32, the kernels' plain versions in their place.

``--ckpt-dir DIR`` checkpoints the LLaMA run and resumes a relaunched one
from DIR's latest step, with the JAX lab's meanings (``--ckpt-every``, default
100; :class:`StageCheckpoint`, :func:`run_rank`).

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
(``data = N // 2``, 2 microbatches; ``--stages S``: S stages, 2..4).  Batch
1024 per rank on CUDA (bf16) and
4 on the CPU (float32), SGD 0.1 with momentum 0.9, the CIFAR-10 train split
on the device (:class:`~ddl25spring_tpu_torch.benchmarks.DeviceDataset`;
``--input``, :func:`resnet_input`: ``hbm`` feeds one step at a time,
``hbm-scan`` runs K steps per dispatch, their batches drawn on the card
inside one CUDA graph (:func:`~ddl25spring_tpu_torch.benchmarks.
build_resnet_scan_step`; K = ``--scan-steps``, else the largest divisor of
the epoch's batches up to 16, the JAX rule: 16 at batch 1024), ``fixed``
re-feeds one batch, and ``auto`` (the default, as in JAX) takes
``hbm-scan`` on CUDA where one rank has the card to itself and ``hbm``
otherwise; the header and the report line's input field name what was
taken (``hbm-resident-shuffle-scan16``).  The first step counts the step's
FLOPs; then 2 warm-up steps (windows under ``hbm-scan``), then ``--iters``
timed ones (default 30; under ``hbm-scan`` ``max(2, iters // K)`` windows,
as in JAX) through
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
and puts both back after.  The bench drives a one-process run through
:class:`ResnetTelemetry`: its hooks, the resilient primary of
:class:`ResnetFT` and the secondary lines (:func:`resnet_secondaries`);
``bench --elastic`` runs :func:`elastic_resnet`.

Run: ``python -m ddl25spring_tpu_torch.lab.dp_pp [--pp --ranks 4] [--input hbm]``
     ``python -m ddl25spring_tpu_torch.lab.dp_pp --workload llama [--iters 200]
[--device cuda] [--schedule interleaved-1f1b --chunks 2] [--ckpt-dir DIR]``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ddl25spring_tpu_torch import benchmarks, obs
from ddl25spring_tpu_torch.data.tinystories import TinyStories
from ddl25spring_tpu_torch.data.tokenizer import get_tokenizer
from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
from ddl25spring_tpu_torch.ops import flash_attention as fa
from ddl25spring_tpu_torch.parallel.comm import Comm
from ddl25spring_tpu_torch.parallel.launch import spawn
from ddl25spring_tpu_torch.parallel.pipeline import (
    INTERLEAVED,
    SCHEDULES,
    check_layout,
    fuse_train_steps,
    graph_refusal,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import DpPpConfig, LlamaConfig
from ddl25spring_tpu_torch.utils.device import backend_flags, resolve_device
from ddl25spring_tpu_torch.utils.flops import count_flops, mfu
from ddl25spring_tpu_torch.utils.mesh import cards_used, init_mesh, select_backend
from ddl25spring_tpu_torch.utils.tracing import trace


@dataclass(frozen=True)
class Job:
    """What every rank of one run does."""

    cfg: LlamaConfig
    data: int
    stages: int
    microbatches: int
    batch: int                  # global rows per step: microbatches x data x rows
    iters: int                  # dispatches, each of scan_steps steps
    lr: float = 8e-4
    seed: int = 0
    device: str = "cuda"
    params: dict | None = None  # full or staged numpy pytree; None: Llama(seed)'s
    batches: list | None = None  # global [batch, ctx] token batches; None: TinyStories
    tokenizer: object = None    # TinyStories' tokenizer (None: get_tokenizer())
    export: bool = False        # return the first step's gradients and the last params
    log: bool = True
    schedule: str = "gpipe"
    chunks: int = 1             # layer chunks per rank (the interleaved schedules)
    scan_steps: int = 1         # train steps per dispatch (fuse_train_steps)
    trace_dir: str = ""         # the reporting rank's torch.profiler trace of its loop
    ckpt_dir: str = ""          # checkpoint/resume directory ("": none)
    ckpt_every: int = 100       # steps between checkpoints (0: only the tail's)


def traced(trace_dir: str, reports: bool):
    """The context of a rank's timed loop: with ``trace_dir`` on the
    reporting rank, a :func:`~ddl25spring_tpu_torch.utils.tracing.trace`
    run writing ``trace_dir/trace.json``, its steps as
    :mod:`~ddl25spring_tpu_torch.obs.spans` (``record_function`` ranges in
    the trace); else nothing."""
    if not (trace_dir and reports):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(trace(trace_dir))
    stack.enter_context(obs.scoped(True))
    return stack


LLAMA_ITERS = 200  # the JAX labs' default (lab/s01_b2_dp_pp.py:140)


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


class StageCheckpoint:
    """The lab's checkpoint of one rank (``lab/s01_b2_dp_pp.py:153-166,
    198-212``): its stage's parameters and Adam state under
    ``stage{s}/params/<name>`` and ``stage{s}/opt_state/<name>/<state>``
    (the DP replicas of a stage hold the same tensors; the checkpoint writes
    them once), through a :class:`~ddl25spring_tpu_torch.utils.checkpoint.
    Checkpointer` (async, the newest 3 kept).  Every rank makes one, in the
    same order."""

    def __init__(self, directory: str, stage_index: int, module, optimizer):
        from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer

        self.ckpt = Checkpointer(directory)
        self.key = f"stage{stage_index}"
        self.named = list(module.named_parameters())
        self.optimizer = optimizer

    def state(self) -> dict:
        from ddl25spring_tpu_torch.utils.checkpoint import optimizer_state

        return {self.key: {"params": {n: p.detach() for n, p in self.named},
                           "opt_state": optimizer_state(self.optimizer, self.named)}}

    def restore_or_init(self) -> int:
        """Load the latest checkpoint into the stage and its optimizer;
        returns the next step (0 on a fresh start, which loads nothing)."""
        from ddl25spring_tpu_torch.utils.checkpoint import (
            load_optimizer_state,
            optimizer_template,
        )

        init = {self.key: {"params": {n: p.detach() for n, p in self.named},
                           "opt_state": optimizer_template(self.optimizer, self.named)}}
        state, start = self.ckpt.restore_or_init(init)
        if start:
            mine = state[self.key]
            with torch.no_grad():
                for n, p in self.named:
                    p.copy_(mine["params"][n])
            load_optimizer_state(self.optimizer, self.named, mine["opt_state"])
        return start


def run_rank(rdv, job: Job) -> dict:
    """One rank of ``job``: its stage's training loop, ``job.iters``
    dispatches of ``job.scan_steps`` steps.  Returns its coordinates, device
    and backend, the losses (last stage only, every step), each dispatch's
    host time (to the card's idle) per step and the slowest rank's
    (``world_step_s``), its comm counts per dispatch
    (:meth:`~ddl25spring_tpu_torch.parallel.comm.Comm.take_stats`), its flash
    kernel launches and, with ``job.export``, its stage's gradients after the
    first step and parameters after the last.

    With ``job.ckpt_dir`` (:class:`StageCheckpoint`): the run resumes from
    the directory's latest step (``start``, returned), skips the
    ``start * batch`` samples the earlier runs consumed, runs ``job.iters``
    dispatches more, saves after every step ``it`` with ``(it + 1) %
    ckpt_every == 0`` and the last step unless that save covered it (the
    JAX lab's rule); ``ckpt_s`` holds each save's blocking seconds."""
    cfg = job.cfg
    with init_mesh(rdv, job.data, job.stages, job.device) as mesh:
        params = job.params
        if params is None:
            params = export_params(Llama(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(job.seed)))
        stage = shard_staged_params(params, cfg, mesh, job.chunks)
        opt = torch.optim.Adam(stage.parameters(), lr=job.lr)
        d, s = mesh.coords
        ckpt, start = None, 0
        if job.ckpt_dir:
            ckpt = StageCheckpoint(job.ckpt_dir, s, stage, opt)
            start = ckpt.restore_or_init()
            if start and mesh.rank == 0:
                print(f"resumed from step {start - 1} in {job.ckpt_dir}", flush=True)
        step = make_pipeline_train_step(stage, cfg, opt, mesh, job.microbatches,
                                        job.schedule, job.chunks)
        stats, K = step.stats, job.scan_steps
        if K > 1:
            step = fuse_train_steps(step, K, module=stage, optimizer=opt, device=mesh.device,
                                    comm=mesh.comm)
        if job.batches is not None:
            batches = iter(job.batches[start:])
        else:
            tok = job.tokenizer if job.tokenizer is not None else get_tokenizer()
            batches = iter(TinyStories(tok, batch_size=job.batch,
                                       seq_l=cfg.ctx_size, seed=job.seed,
                                       skip=start * job.batch))
        out = {"rank": mesh.rank, "coords": (d, s), "device": str(mesh.device),
               "backend": mesh.backend, "losses": [], "step_s": [], "comm": [],
               "stash_max": [], "start": start, "ckpt_s": []}
        fa.reset_launches()
        mesh.comm.take_stats()
        with traced(job.trace_dir, (d, s) == (0, job.stages - 1)):
            _loop(job, mesh, step, stats, batches, stage, out, ckpt, start)
        if ckpt is not None:
            last = start + job.iters * K - 1
            if job.iters and (job.ckpt_every <= 0 or (last + 1) % job.ckpt_every):
                # persist the tail: without it up to ckpt_every - 1 trailing
                # steps would be redone on relaunch
                t0 = time.perf_counter()
                ckpt.ckpt.save(last, ckpt.state(), force=True)
                out["ckpt_s"].append(time.perf_counter() - t0)
            ckpt.ckpt.close()
        out["launches"] = dict(fa.LAUNCHES)
        out["launches_by_variant"] = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        if job.export:
            out["params"] = export_params(stage)
        _, out["world_step_s"] = world_totals(mesh, 0, out["step_s"])
        return out


def _loop(job: Job, mesh, step, stats, batches, stage, out: dict, ckpt=None, start: int = 0):
    """:func:`run_rank`'s training loop, each dispatch an ``obs`` span; steps
    are numbered from ``start``, and ``ckpt`` saves at the end of a dispatch
    whose last step ``it`` has ``(it + 1) % ckpt_every == 0``."""
    K, (d, _) = job.scan_steps, mesh.coords
    for it in range(job.iters):
        with obs.span("dp_pp.step", step=it):
            tokens = np.stack([np.asarray(next(batches)) for _ in range(K)])
            tokens = torch.from_numpy(tokens if K > 1 else tokens[0]).long()
            t0 = time.perf_counter()
            loss = step(tokens)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            out["step_s"].append((time.perf_counter() - t0) / K)
        out["comm"].append(mesh.comm.take_stats())
        out["stash_max"].append(stats["stash_max"])
        for j, x in enumerate([] if loss is None else loss.reshape(-1).tolist()):
            out["losses"].append(x)
            if job.log and d == 0:
                print(f"iter {start + it * K + j:3d}  loss {x:.4f}  "
                      f"step {out['step_s'][-1] * 1e3:.2f} ms", flush=True)
        if job.export and it == 0:
            out["grads"] = export_grads(stage)
        last = start + (it + 1) * K - 1
        if ckpt is not None and job.ckpt_every > 0 and (last + 1) % job.ckpt_every == 0:
            t0 = time.perf_counter()
            ckpt.ckpt.save(last, ckpt.state())
            out["ckpt_s"].append(time.perf_counter() - t0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=("resnet", "llama"), default="resnet")
    ap.add_argument("--iters", type=int, default=0,
                    help="0 = the workload's default (llama 200, resnet 30)")
    ap.add_argument("--schedule", choices=SCHEDULES, default="gpipe",
                    help="llama: the pipeline schedule")
    ap.add_argument("--chunks", type=int, default=2, metavar="V",
                    help="llama, interleaved schedules: layer chunks per rank (needs "
                         "microbatches %% stages == 0 and n_layers %% (stages*V) == 0)")
    ap.add_argument("--scan-steps", type=int, default=0, metavar="K",
                    help="train steps per dispatch, one CUDA graph on the card; 0 = auto: "
                         "llama 16 on the card where its ranks can be graphed (else 1), 1 on "
                         "the CPU; resnet under hbm-scan the largest divisor of the epoch's "
                         "batches up to 16")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-flash", action="store_true",
                    help="dense attention instead of the flash kernels")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the spawned ranks are killed")
    ap.add_argument("--pp", action="store_true",
                    help="resnet: the 2-stage heterogeneous pipeline x DP")
    ap.add_argument("--stages", type=int, default=0, metavar="S",
                    help="resnet: the S-stage (2..4) heterogeneous pipeline x DP, the ranks "
                         "sharing the cards; 0 = 2 under --pp, else pure DP")
    ap.add_argument("--ranks", type=int, default=0,
                    help="resnet: rank processes; 0 = one per card (one on the CPU)")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch; 0 = llama 3 per replica, resnet 1024 per rank on "
                         "CUDA and 4 on the CPU")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = llama 3, resnet 2 (under --pp)")
    ap.add_argument("--lr", type=float, default=0.0, help="0 = llama 8e-4, resnet 0.1")
    ap.add_argument("--input", choices=("auto", "hbm-scan", "hbm", "fixed"), default="auto",
                    help="resnet: 'hbm' = the train split on the device, reshuffled "
                         "per epoch; 'hbm-scan' = the same, K steps per dispatch with the "
                         "batches drawn inside one CUDA graph; 'fixed' = one batch re-fed; "
                         "'auto' = hbm-scan on CUDA where one rank has the card to itself, "
                         "else hbm")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--trace-dir", default="",
                    help="capture a torch.profiler trace of the timed loop (the reporting "
                         "rank's, into DIR/trace.json; the steps as obs spans)")
    ap.add_argument("--ckpt-dir", default="",
                    help="llama workload: checkpoint/resume directory; a relaunched run "
                         "continues from the latest step")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="llama workload with --ckpt-dir: steps between checkpoints (a "
                         "multiple of --scan-steps); the last step is always saved")
    return ap.parse_args(argv)


def main(argv=None, layout: DpPpConfig = DpPpConfig(), **resnet) -> dict:
    """Train ``layout`` (default: the reference's 2 x 3) and print; returns
    ``{"losses", "step_s", "tokens_per_s", "ranks"}``: the reporting rank's
    losses and the slowest rank's step times (:func:`reporting_rank`,
    :func:`world_totals`), and every rank's result from :func:`run_rank`
    (only this process's under torchrun, where a rank that does not report
    prints nothing after the header and returns ``{"ranks"}`` alone).
    ``resnet`` (``telemetry``, ``warmup``, ``n_train``) goes to
    :func:`run_resnet`: the bench's hooks and its ``--smoke`` cuts."""
    args = parse_args(argv)
    if args.workload == "resnet":
        if args.ckpt_dir:
            raise ValueError("--ckpt-dir checkpoints the llama workload only, as the JAX lab "
                             "does (lab/s01_b2_dp_pp.py:48-51)")
        return run_resnet(args, **resnet)
    job, why = llama_job(args, layout)
    D, S, M, V, K = job.data, job.stages, job.microbatches, job.chunks, job.scan_steps
    device = torch.device(job.device)
    cfg = job.cfg
    print(f"llama DPxPP: {D} x {S} ranks, {M} microbatches, {job.batch // D} rows "
          f"per replica, ctx {args.seq_len}, {cfg.dtype}, "
          f"attention={'flash' if cfg.use_flash else 'dense'}, schedule {args.schedule}"
          + (f" ({V} chunks per rank)" if V > 1 else "") + f", device={device.type}, "
          f"{K} step(s) per dispatch" + (f" ({why})" if why else ""), flush=True)
    ranks = spawn(run_rank, D * S, job, timeout=args.timeout)
    log = reporting_rank(ranks, S)
    if log is None:
        return {"ranks": ranks}
    step_s = log["world_step_s"]
    # the first dispatch warms up (kernel loads, allocator, a fused program's build)
    timed = step_s[1:] or step_s
    tokens_per_s = job.batch * args.seq_len * len(timed) / sum(timed)
    print(f"backend {log['backend']}; done: {len(step_s) * K} steps, {tokens_per_s:.1f} "
          f"tokens/s after the first dispatch (median step "
          f"{statistics.median(timed) * 1e3:.2f} ms)", flush=True)
    if args.trace_dir:
        print(f"profiler trace written to {args.trace_dir}", flush=True)
    return {"losses": log["losses"], "step_s": step_s, "tokens_per_s": tokens_per_s,
            "ranks": ranks}


def llama_job(args, layout: DpPpConfig) -> tuple[Job, str]:
    """The LLaMA run that ``args`` (:func:`parse_args`) asks for on
    ``layout``'s grid, and the header's reason for the steps per dispatch.
    The flags keep the JAX labs' meanings (``lab/s01_b2_dp_pp.py:126-140``,
    ``lab/s01_b1_microbatches.py:27-38``): ``--batch`` is the global batch
    (0: ``per_replica_batch`` per replica), ``--microbatches`` M (0:
    ``num_microbatches``), ``--lr`` Adam's rate (0: ``learning_rate``),
    ``--iters`` the steps (0: 200).  A batch that does not split into M
    microbatches of whole rows per replica raises, as the JAX step's shapes
    do."""
    D, S = layout.data, layout.num_stages
    M = args.microbatches or layout.num_microbatches
    batch = args.batch or D * layout.per_replica_batch
    if batch % (M * D):
        raise ValueError(f"batch {batch} not divisible by {M} microbatches x {D} replicas")
    V = args.chunks if args.schedule in INTERLEAVED else 1
    check_layout(args.schedule, S, V, M)
    device = resolve_device(args.device)
    K, why = llama_scan_steps(args.scan_steps, device, D * S)
    asked = args.iters or LLAMA_ITERS
    iters = max(1, asked // K)  # dispatches
    if iters * K != asked:
        print(f"note: --iters {asked} adjusted to {iters * K} (a dispatch runs {K} fused "
              "steps; use --scan-steps to change the granularity)", flush=True)
    # one tokenizer sizes the embedding and feeds the stream, as in
    # lab/s01_b2_dp_pp.py:117-121 and lab/s01_b1_microbatches.py:94-100
    tok = get_tokenizer()
    cfg = LlamaConfig(vocab_size=tok.vocab_size, ctx_size=args.seq_len,
                      dtype="bfloat16" if device.type == "cuda" else "float32",
                      use_flash=not args.no_flash)
    if cfg.n_layers % (S * V):
        raise ValueError(f"{cfg.n_layers} layers not divisible by S*V = {S}*{V}")
    if args.ckpt_dir and args.ckpt_every % K:
        # a save lands at the end of a dispatch, and a resume starts at one
        raise ValueError(f"--ckpt-every {args.ckpt_every} is not a multiple of the "
                         f"{K} steps per dispatch (--scan-steps)")
    job = Job(cfg, D, S, M, batch=batch, iters=iters, lr=args.lr or layout.learning_rate,
              seed=args.seed, device=device.type, schedule=args.schedule, chunks=V,
              scan_steps=K, trace_dir=args.trace_dir, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, tokenizer=tok)
    return job, why


def _layout_refusal(device, world: int) -> Exception | None:
    """:func:`~ddl25spring_tpu_torch.parallel.pipeline.graph_refusal` for a
    world of ``world`` ranks on this host, from the backend its layout
    selects, before any rank starts (None for one rank alone)."""
    if world == 1:
        return None
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    return graph_refusal(device, Comm(select_backend(device.type, world, n_cards), device))


def llama_scan_steps(asked: int, device, world: int) -> tuple[int, str]:
    """The LLaMA run's train steps per dispatch and the header's reason for
    a default that fell to 1.  ``asked`` 0 is the JAX default: 16 on the
    card, 1 on the CPU; on the card a world whose ranks cannot be graphed
    (:func:`_layout_refusal`: every layout of these labs) takes 1, and an
    explicit ``asked > 1`` raises the refusal."""
    refusal = _layout_refusal(device, world)
    if asked > 1 and refusal is not None:
        raise refusal
    if asked:
        return asked, ""
    if device.type != "cuda":
        return 1, ""
    if refusal is not None:
        return 1, f"not 16: {refusal}"
    return 16, ""


# ------------------------------------------------------------------ resnet

WARMUP = 3


@dataclass(frozen=True)
class ResnetJob:
    """What every rank of one ResNet run does."""

    data: int
    stages: int
    microbatches: int
    batch: int                   # global rows per step
    iters: int                   # timed steps (a multiple of scan_steps), after the warm-up
    lr: float = 0.1
    seed: int = 0
    device: str = "cuda"
    input: str = "hbm"           # "hbm": DeviceDataset.feed; "hbm-scan": its windows;
                                 # "fixed": its first batch
    scan_steps: int = 1          # steps per dispatch under "hbm-scan"
    trace_dir: str = ""          # the reporting rank's torch.profiler trace of its timed run
    warmup: int = WARMUP         # steps before the timed ones (the first counts the FLOPs)
    n_train: int | None = None   # the train split's rows (None: CIFAR-10's 50,000)
    overlap: bool = False        # pure DP's backward-overlapped buckets (layout "dp-overlap")


@dataclass
class ResnetFT:
    """The fault tolerance a bench hands a ResNet run (:func:`train_resnet`,
    :func:`elastic_rank`), as the JAX bench wires it (``bench.py:1112-1210``):
    an :class:`~ddl25spring_tpu_torch.ft.AutoSaver` on ``ckpt_dir`` every
    ``save_every`` steps (0: none unless ``resume``), chaos armed from
    ``DDL25_CHAOS`` with its journal there, and with ``resume`` the latest
    durable step restored before the first timed call.  ``t_entry`` is the
    process's entry on ``time.perf_counter`` (``recovery_wall_s`` runs from
    it); ``prev_last_step`` the dead attempt's last checkpointable step, read
    from its flight dump before this attempt wrote one (the steps it
    replays); ``elastic`` leaves ``device_loss`` and ``capacity_change`` to
    the caller's reshape."""

    ckpt_dir: str
    save_every: int = 0
    resume: bool = False
    t_entry: float | None = None
    prev_last_step: int | None = None
    elastic: bool = False


@dataclass
class ResnetTelemetry:
    """The bench's hooks into a one-process ResNet run (:func:`train_resnet`):
    a :class:`~ddl25spring_tpu_torch.obs.MetricsLogger` for one ``step``
    record per timed call, a :class:`~ddl25spring_tpu_torch.obs.goodput.
    GoodputMeter` billed the warm-up and each call, and a
    :class:`~ddl25spring_tpu_torch.obs.memscope.MemScope` sampled after each
    call.  Any may be None.  ``ft`` (a :class:`ResnetFT`) makes the primary
    phase resumable; ``secondaries`` runs the bench's secondary lines after
    it (:func:`resnet_secondaries`)."""

    logger: object = None
    goodput: object = None
    memscope: object = None
    ft: ResnetFT | None = None
    secondaries: bool = False


class _Recovery:
    """The resilient primary phase of a ResNet run (:class:`ResnetFT`): the
    saver, the chaos injector, the restore and the per-step hook."""

    def __init__(self, cfg: ResnetFT, layout: str):
        from ddl25spring_tpu_torch.ft import AutoSaver, ChaosInjector

        self.cfg = cfg
        self.saver = (AutoSaver(cfg.ckpt_dir, save_every=cfg.save_every,
                                meta={"driver": "bench", "layout": layout})
                      if cfg.save_every or cfg.resume else None)
        self.chaos = ChaosInjector.from_env(state_dir=cfg.ckpt_dir)
        if self.chaos.pending("nan_grad"):
            print("chaos: nan_grad does not reach the bench's uint8 input path; exercise it "
                  "through ft.demo or the ft tests", flush=True)
        # the kinds an elastic run claims at its segment boundaries (chaos.take):
        # on_step must not raise them out from under the reshape
        self.skip = ("device_loss", "capacity_change") if cfg.elastic else ()
        self.start_step = 0
        self.replayed = None
        self.recovery_wall_s = None

    @staticmethod
    def bundle(module, opt, ds) -> dict:
        from ddl25spring_tpu_torch.ft import resume_bundle
        from ddl25spring_tpu_torch.utils.checkpoint import optimizer_state

        named = list(module.named_parameters())
        return resume_bundle({n: p.detach() for n, p in named}, optimizer_state(opt, named),
                             data_cursor=ds.cursor, rng_seed=ds.seed)

    def restore(self, module, opt, ds, meter) -> bool:
        """With ``resume``: the latest durable step into ``module``, ``opt``
        and ``ds``'s cursor, copied into the tensors that are there (a CUDA
        graph captured over them keeps reading them), and ``recovery`` billed
        from process entry to now.  True when this ran."""
        if not (self.cfg.resume and self.saver is not None):
            return False
        state, start = self.saver.restore_or_init(self.bundle(module, opt, ds))
        if self.cfg.t_entry is not None:
            # the relaunch's recovery bill: process entry -> restored
            self.recovery_wall_s = round(time.perf_counter() - self.cfg.t_entry, 3)
        if meter is not None:
            meter.add("recovery", 0.0, meter.now(), reason="relaunch_restore")
        if start:
            with torch.no_grad():
                for n, p in module.named_parameters():
                    p.copy_(state["params"][n])
                    live = opt.state[p]
                    for k, v in state["opt_state"][n].items():
                        if torch.is_tensor(live.get(k)) and live[k].shape == v.shape:
                            live[k].copy_(v)
                        else:
                            live[k] = v.clone()
            ds.cursor = int(state["data_cursor"])
            prev = self.cfg.prev_last_step
            if prev is not None:
                # the steps between the dead attempt's last one and this
                # restart re-run now: billed replayed_steps, not useful
                self.replayed = max(0, prev + 1 - start)
                obs.flight.annotate(steps_replayed=self.replayed)
                if meter is not None:
                    meter.set_replay_window(start, prev)
        self.start_step = start
        return True

    def on_step(self, i, lval, module, opt, ds, meter) -> None:
        """After timed call ``i``: kill-type chaos first (a fault at ``i``
        fires before ``i``'s state can become durable), then the gated save,
        billed ``checkpoint_save`` when it fired."""
        self.chaos.on_step(i, skip=self.skip)
        if self.saver is not None:
            t0 = meter.now() if meter is not None else 0.0
            if self.saver.maybe_save(i, self.bundle(module, opt, ds), loss=lval) \
                    and meter is not None:
                meter.add("checkpoint_save", t0, meter.now(), step=i)

    def close(self) -> None:
        if self.saver is not None:
            self.saver.close()

    def cell(self, total: int, **extra) -> dict | None:
        """``telemetry.resume``'s facts of this attempt (None without a
        saver), ``total`` the phase's dispatches."""
        if self.saver is None:
            return None
        s = self.start_step
        return {
            "start_step": s,
            **({"resumed_from_step": s - 1} if s else {}),
            **({"steps_replayed": self.replayed} if self.replayed is not None else {}),
            # the run was done when it resumed: a minimal window re-ran
            **({"resumed_past_end": True} if s >= total else {}),
            "save_every": self.cfg.save_every,
            "ckpt_dir": self.cfg.ckpt_dir,
            "saves": self.saver.saves,
            "saves_skipped": self.saver.skipped,
            **({"recovery_wall_s": self.recovery_wall_s}
               if self.recovery_wall_s is not None else {}),
            **extra,
        }


# the timed ResNet run: cuDNN autotunes its convolutions, TF32 off
RUN_FLAGS = dict(cudnn_benchmark=True, cudnn_tf32=False, matmul_tf32=False)


def train_resnet(mesh, job: ResnetJob, telemetry: ResnetTelemetry | None = None) -> dict:
    """One rank's ResNet run (``mesh`` None: one process alone).  Returns its
    coordinates, device, backend, layout, boundary shapes and parameter
    count; the input mode; the losses of every step (last stage only); the
    timed seconds and each timed dispatch's seconds per step; the FLOPs of
    its first step; its comm counts over the timed steps; where its
    parameters and its dataset live; and on CUDA the peak of
    ``max_memory_allocated`` over the run (the dataset included).

    With ``telemetry`` (a one-process run, the bench's): the timed calls go
    through :func:`~ddl25spring_tpu_torch.benchmarks.timed_run`'s per-call
    path with its logger, meter and a memory sample after each call, the
    first (FLOP-counting) step is billed as warm-up, and ``live`` holds the
    per-batch step, the dataset's fixed batch and the builder's meta, for
    :func:`~ddl25spring_tpu_torch.obs.perfscope.measure_bench_step`.

    ``telemetry.ft`` (:class:`ResnetFT`) makes the timed phase the bench's
    resilient primary (``bench.py:1112-1443``): restored before it (the
    build's first step and the capture of a CUDA graph see the restored
    tensors, copied in place), chaos and the gated autosave after each timed
    call, whose indices count dispatches (``K`` steps each under
    ``hbm-scan``) from the restored step on, the saver drained after it;
    ``resume`` holds the attempt's facts, ``timed_steps`` the steps it ran.
    A ``device_loss`` fault drains the saver and raises
    :class:`~ddl25spring_tpu_torch.ft.DeviceLossError`.
    ``telemetry.secondaries``: ``secondary`` holds the bench's secondary
    lines and ``h2d_mib_per_s`` the link's rate (:func:`resnet_secondaries`)."""
    dev = mesh.device if mesh is not None else resolve_device(job.device)
    cuda = dev.type == "cuda"
    tel = telemetry or ResnetTelemetry()
    meter = tel.goodput
    with backend_flags(**RUN_FLAGS):
        fixed, K = job.input == "fixed", job.scan_steps
        ds = benchmarks.DeviceDataset(job.batch, n_train=job.batch if fixed else job.n_train,
                                      device=dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        g0 = meter.now() if meter is not None else 0.0
        if job.input == "hbm-scan":
            call, step, module, opt, meta = benchmarks.build_resnet_scan_step(
                mesh, job.microbatches, job.batch, lr=job.lr, device=dev, seed=job.seed,
                scan_steps=K, dataset=ds, overlap=job.overlap)
            feed, input_mode = (lambda: ds.scan_window(K)), f"{ds.input_mode}-scan{K}"
            first, flops = count_flops(step, ds.fixed)
        else:
            step, module, opt, meta = benchmarks.build_resnet_step(
                mesh, job.microbatches, job.batch, lr=job.lr, device=dev, seed=job.seed,
                overlap=job.overlap)
            call, feed = step, (lambda: ds.fixed) if fixed else ds.feed
            input_mode = "fixed-device-batch" if fixed else ds.input_mode
            first, flops = count_flops(step, feed())
        if meter is not None and cuda:
            torch.cuda.synchronize(dev)
        rec = _Recovery(tel.ft, meta["layout"]) if tel.ft is not None else None
        # a resumed attempt bills process entry -> restored as recovery (the
        # build inside it); any other bills the build, capture and
        # FLOP-counting step as warm-up
        if not (rec is not None and rec.restore(module, opt, ds, meter)) and meter is not None:
            meter.add("warmup_compile", g0, meter.now(), label=job.input)
        comm = mesh.comm if mesh is not None else None
        # the warm-up re-runs in a resumed attempt too (cuDNN's autotune and
        # the graph's capture are per process), so its cursor drifts past the
        # restored one by the warm-up's batches, as in the JAX bench
        _, warm, _ = benchmarks.timed_run(call, feed, 0, job.warmup - 1, device=dev, k=K,
                                          label=job.input, goodput=meter)
        if comm is not None:
            comm.take_stats()
        reports = mesh is None or mesh.coords == (0, job.stages - 1)
        sample = tel.memscope
        total = job.iters // K
        start = rec.start_step if rec is not None else 0
        n_disp = max(total - start, 1)

        def on_step(i, lval):
            if sample is not None:
                sample.sample(i)
            if rec is not None:
                rec.on_step(i, lval, module, opt, ds, meter)

        from ddl25spring_tpu_torch.ft.chaos import DeviceLossError

        try:
            with traced(job.trace_dir, reports):
                dt, timed, step_s = benchmarks.timed_run(
                    call, feed, n_disp, 0, device=dev, k=K, logger=tel.logger,
                    label=job.input, samples_per_step=job.batch, goodput=meter,
                    on_step=on_step if sample is not None or rec is not None else None,
                    step_offset=start)
        except DeviceLossError:
            rec.close()  # the relaunch resumes from what this drains
            raise
        if rec is not None:
            rec.close()
        secondary, h2d = [], None
        if tel.secondaries:
            secondary, h2d = resnet_secondaries(step, ds, job, meta, dev, tel.logger, meter,
                                                scan=job.input == "hbm-scan")
        return {
            "rank": mesh.rank if mesh is not None else 0,
            "coords": mesh.coords if mesh is not None else (0, 0),
            "device": str(dev), "backend": mesh.backend if mesh is not None else None,
            "layout": meta["layout"], "topology": meta["topology"], "input": input_mode,
            "boundary_shapes": meta["boundary_shapes"], "n_params": meta["n_params"],
            "losses": ([] if first is None else [float(first)]) + warm + timed,
            "dt": dt, "step_s": step_s, "flops": flops, "timed_steps": n_disp * K,
            "comm": comm.take_stats() if comm is not None else None,
            "params_device": sorted({str(p.device) for p in module.parameters()}),
            "data_device": str(ds.x.device), "provenance": ds.provenance,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            **({"resume": rec.cell(total)} if rec is not None else {}),
            **({"secondary": secondary, "h2d_mib_per_s": h2d} if tel.secondaries else {}),
            **({"live": (step, ds.fixed, meta)} if telemetry is not None else {}),
        }


def resnet_secondaries(step, ds, job: ResnetJob, meta: dict, dev, logger=None,
                       meter=None, scan: bool = False) -> tuple[list, float | None]:
    """The bench's secondary lines after its primary phase, in the JAX
    bench's order and with its fields (``bench.py:1287-1298, 1445-1482,
    1749-1790``), each ``job.iters`` timed calls of the per-batch ``step``
    (one step each), samples/s per card:

    - ``hbm-resident-shuffle`` (only after a ``hbm-scan`` primary): the same
      device-resident input one step per dispatch; its gap to the primary
      is what the CUDA graph of ``K`` steps saves;
    - ``native-stream-uint8``: the native C++ loader's raw batches through
      pinned buffers to the card (:class:`~ddl25spring_tpu_torch.benchmarks.
      InputFeed`, ``workers = max(2, cpus // 2)``, prefetch depth 6), warmed
      past ``warmup + depth + workers`` calls so the timed window starts with
      the queue drained;
    - ``fixed-device-batch``: one device-resident batch re-fed (compute only).

    Returns ``(lines, h2d_mib_per_s)``: the median of three 4 MiB pinned
    host-to-device copies (CUDA events), None on the CPU (no link)."""
    cards = meta["n_chips"]
    lines = []
    if scan:
        # scan windows and single batches count the cursor in other units:
        # the one-step line starts the epoch afresh
        ds.cursor = 0
        dt0, _, _ = benchmarks.timed_run(step, ds.feed, job.iters, job.warmup, device=dev,
                                         logger=logger, label="hbm-single",
                                         samples_per_step=job.batch, goodput=meter)
        lines.append({"input": ds.input_mode, "value": round(job.iters * job.batch / dt0 / cards, 1),
                      "unit": "samples/sec/chip",
                      "note": "one step per dispatch; the delta vs the primary is what one "
                              "CUDA graph of the window's steps saves"})
    workers, depth = max(2, (os.cpu_count() or 4) // 2), 6
    feed = benchmarks.InputFeed(job.batch, stream=True, workers=workers, prefetch_depth=depth,
                                device=dev)
    try:
        dt_s, _, _ = benchmarks.timed_run(step, feed.feed, job.iters, job.warmup + depth + workers,
                                          device=dev, logger=logger, label="stream",
                                          samples_per_step=job.batch, goodput=meter)
        dt_f, _, _ = benchmarks.timed_run(step, feed.feed_fixed, job.iters, job.warmup,
                                          device=dev, logger=logger, label="fixed-batch",
                                          samples_per_step=job.batch, goodput=meter)
    finally:
        streamed = feed.streaming
        feed.close()
    h2d = h2d_mib_per_s(dev)
    if not streamed:
        note = "native loader unavailable; fell back to the fixed device-resident batch"
    elif h2d is None:
        note = "the native C++ loader's uint8 batches on the host (a CPU run: no link)"
    else:
        note = (f"the native C++ loader's uint8 batches through pinned buffers to the card "
                f"(the link measured {h2d:.0f} MiB/s here)")
    lines += [
        {"input": feed.input_mode, "value": round(job.iters * job.batch / dt_s / cards, 1),
         "unit": "samples/sec/chip", "note": note},
        {"input": "fixed-device-batch", "value": round(job.iters * job.batch / dt_f / cards, 1),
         "unit": "samples/sec/chip"},
    ]
    return lines, h2d


def h2d_mib_per_s(dev) -> float | None:
    """The host-to-device rate of a 4 MiB pinned copy to ``dev``, the median
    of 3 (CUDA events around each copy, after one warm copy); None on the
    CPU."""
    if dev.type != "cuda":
        return None
    mib = 4
    src = torch.empty(mib << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty(mib << 20, dtype=torch.uint8, device=dev)
    dst.copy_(src, non_blocking=True)
    rates = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        e1.synchronize()
        rates.append(mib / (e0.elapsed_time(e1) / 1e3))
    return statistics.median(rates)


ELASTIC_KINDS = ("device_loss", "capacity_change")


def elastic_resnet(job: ResnetJob, ft: ResnetFT, world: int = 2, export: bool = False,
                   lineage: dict | None = None) -> dict:
    """The bench's ``--elastic`` run (``bench.py:1303-1427``): ``world``
    spawned ranks (sharing the card over gloo, or on the CPU) of pure DP,
    one step per dispatch, that answer a ``device_loss`` or
    ``capacity_change`` fault in the run by reshaping instead of dying
    (:func:`elastic_rank`).  The ranks take this process's ``DDL25_*``
    environment (chaos, lineage) as it is now, with ``lineage``
    (``{"lineage_id", "attempt"}``) over it.  Returns rank 0's result."""
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod

    env = {k: v for k, v in os.environ.items() if k.startswith("DDL25_")}
    if lineage is not None:
        env[goodput_mod.ENV_LINEAGE] = lineage["lineage_id"]
        env[goodput_mod.ENV_ATTEMPT] = str(lineage["attempt"])
    return spawn(elastic_rank, world, job, ft, env, export, timeout=900.0)[0]


def elastic_rank(rdv, job: ResnetJob, ft: ResnetFT, env: dict, export: bool = False):
    """One rank of :func:`elastic_resnet`.  The run is split at the armed
    elastic faults inside its window into segments, each an ordinary timed
    run (the warm-up before the first only); at a boundary every rank takes
    the fault (``chaos.take``: each rank's journal), and the data axis
    shrinks to the fault's target (``capacity_change@k:n``: n; a
    ``device_loss``: half) or grows back up to the world:
    ``Mesh.regrid(n, model=world // n)``, whose ``model`` ranks are replicas
    of the data axis (:func:`~ddl25spring_tpu_torch.benchmarks.
    build_resnet_step`), the step built on it, the live parameters and
    momentum re-landed on its module and optimizer
    (:func:`~ddl25spring_tpu_torch.ft.elastic.reshape_state`), a
    ``reshape`` flight record with 0 steps lost (the fault fires after its
    step completed: nothing was in flight) and the saver told.  The data
    cursor runs on.  Samples/s per card are over card-seconds, each segment
    at its own width.  Rank 0 returns the run's facts (the goodput doc of
    its meter, the reshapes, the resume cell; with ``export`` the old
    layout's state just before the first reshape, its step and cursor, and
    the final parameters, as numpy), the others None."""
    from ddl25spring_tpu_torch.ft import elastic
    from ddl25spring_tpu_torch.ft.chaos import DeviceLossError
    from ddl25spring_tpu_torch.obs import goodput as goodput_mod
    from ddl25spring_tpu_torch.utils.checkpoint import (
        load_optimizer_state,
        optimizer_state,
        optimizer_template,
    )

    t0 = time.perf_counter()
    for k in [k for k in os.environ if k.startswith("DDL25_")]:
        del os.environ[k]
    os.environ.update(env)
    world = rdv.world
    lineage_id, attempt = goodput_mod.lineage_from_env()
    meter = (goodput_mod.GoodputMeter(lineage_id or goodput_mod.mint_lineage_id(), attempt,
                                      t0_perf=t0) if rdv.rank == 0 else None)
    with init_mesh(rdv, world, 1, job.device) as mesh, backend_flags(**RUN_FLAGS):
        dev, batch = mesh.device, job.batch
        ds = benchmarks.DeviceDataset(batch, n_train=job.n_train, device=dev)
        g0 = meter.now() if meter is not None else 0.0

        def build(m):
            return benchmarks.build_resnet_step(m, 1, batch, lr=job.lr, device=dev,
                                                seed=job.seed)

        step, module, opt, meta = build(mesh)
        first, flops = count_flops(step, ds.feed())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = _Recovery(dataclasses.replace(ft, elastic=True), meta["layout"])
        if not rec.restore(module, opt, ds, meter) and meter is not None:
            meter.add("warmup_compile", g0, meter.now(), label="hbm")
        _, losses, _ = benchmarks.timed_run(step, ds.feed, 0, job.warmup - 1, device=dev,
                                            label="hbm", goodput=meter)
        losses = ([] if first is None else [float(first)]) + losses
        start = rec.start_step
        end = start + max(job.iters - start, 1)
        plan = sorted((f for f in rec.chaos.pending()
                       if f.kind in ELASTIC_KINDS and start <= f.step < end),
                      key=lambda f: f.step)
        dt = card_s = 0.0
        seg, data_now, events, before_reshape = start, world, [], None

        def on_step(i, lval):
            rec.on_step(i, lval, module, opt, ds, meter)

        try:
            for fault in [*plan, None]:
                seg_end = end if fault is None else fault.step + 1
                if seg_end > seg:
                    dt_i, seg_losses, _ = benchmarks.timed_run(
                        step, ds.feed, seg_end - seg, 0, device=dev, label="hbm",
                        samples_per_step=batch, goodput=meter, on_step=on_step,
                        step_offset=seg)
                    dt += dt_i
                    card_s += dt_i * meta["n_chips"]
                    losses += seg_losses
                    seg = seg_end
                if fault is None:
                    break
                if not rec.chaos.take(fault.step, kinds=(fault.kind,)):
                    continue  # journaled in an earlier attempt: one-shot
                if export and before_reshape is None:
                    before_reshape = {"step": fault.step, "cursor": ds.cursor,
                                      **_np_state(module, opt)}
                t0r = time.perf_counter()
                g0r = meter.now() if meter is not None else 0.0
                target = (fault.arg if fault.kind == "capacity_change" and fault.arg
                          else max(1, data_now // 2))
                target = min(target, world)  # growing is best-effort, up to the world
                while batch % target or world % target:  # keep the global batch exact
                    target -= 1
                new_mesh = mesh.regrid(target, model=world // target) if target < world else mesh
                step, new_module, new_opt, meta = build(new_mesh)
                old_named = list(module.named_parameters())
                new_named = list(new_module.named_parameters())
                state = elastic.reshape_state(
                    {"params": {n: p.detach() for n, p in old_named},
                     "opt_state": optimizer_state(opt, old_named)},
                    {"params": {n: p.detach() for n, p in new_named},
                     "opt_state": optimizer_template(new_opt, new_named)})
                with torch.no_grad():
                    for n, p in new_named:
                        p.copy_(state["params"][n])
                load_optimizer_state(new_opt, new_named, state["opt_state"])
                # the old layout's state and the template's are dropped here
                module, opt = new_module, new_opt
                del state, old_named
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0r
                if meter is not None:
                    meter.add("reshape_window", g0r, g0r + wall, step=fault.step,
                              reason=fault.kind)
                events.append(elastic.record_reshape(
                    old={"data": data_now}, new={"data": target}, wall_s=wall, steps_lost=0,
                    reason=fault.kind, step=fault.step))
                if rec.saver is not None:
                    rec.saver.note_reshape(old=events[-1]["old"], new=events[-1]["new"],
                                           step=fault.step)
                data_now = target
        except DeviceLossError:
            rec.close()
            raise
        rec.close()
        steps_run = end - start
        world_flops, _ = world_totals(mesh, flops, [dt])
        if rdv.rank:
            return None
        reshape_wall = round(sum(e["wall_s"] for e in events), 3)
        return {
            "layout": meta["layout"], "topology": f"mesh(data={world}) -> mesh(data={data_now})",
            "input": ds.input_mode, "provenance": ds.provenance, "losses": losses,
            "dt": dt, "card_s": card_s, "steps": steps_run,
            "samples_per_s_per_chip": steps_run * batch / card_s, "flops": world_flops,
            "cards": meta["n_chips"],
            "resume": rec.cell(job.iters, **({
                "reshapes": len(events), "reshape": events, "reshape_wall_s": reshape_wall,
                "recovery_wall_s": reshape_wall, "total_steps_lost": 0} if events else {})),
            "goodput": meter.finalize(scope="train_attempt", strategy=meta["layout"],
                                      mesh={"data": data_now}),
            **({"before_reshape": before_reshape, "final": _np_state(module, opt)}
               if export else {}),
        }


def _np_state(module, opt) -> dict:
    """A module's parameters and its optimizer's momentum, as numpy."""
    params = {n: p.detach().cpu().numpy().copy() for n, p in module.named_parameters()}
    momentum = {n: opt.state[p]["momentum_buffer"].detach().cpu().numpy().copy()
                for n, p in module.named_parameters()
                if "momentum_buffer" in opt.state.get(p, {})}
    return {"params": params, "momentum": momentum}


def resnet_rank(rdv, job: ResnetJob) -> dict:
    """One spawned rank of a ResNet run: joins the ``data x stages`` world,
    runs :func:`train_resnet`, and adds the world's FLOPs per step and
    timed seconds (:func:`world_totals`) as ``world_flops`` and
    ``world_dt``."""
    with init_mesh(rdv, job.data, job.stages, job.device) as mesh:
        out = train_resnet(mesh, job)
        out["world_flops"], (out["world_dt"],) = world_totals(mesh, out["flops"], [out["dt"]])
        return out


def run_resnet(args, telemetry: ResnetTelemetry | None = None, warmup: int = WARMUP,
               n_train: int | None = None, overlap: bool = False) -> dict:
    """``--workload resnet``: lay out the ranks, run them, print the losses,
    samples/s and TFLOP/s per card (ranks that share a card count as one
    card: :func:`~ddl25spring_tpu_torch.utils.mesh.cards_used`), MFU and
    ``report_line``, from the reporting rank (:func:`report_resnet`).
    Returns ``{"ranks", "samples_per_s_per_chip", "cards", "flops",
    "tflops", "mfu", "line"}``, or under torchrun, on a rank that does not
    report, ``{"ranks"}`` alone.  ``telemetry`` reaches a one-rank run
    (:func:`train_resnet`); ``warmup`` and ``n_train`` are the bench's
    ``--warmup`` and ``--smoke`` cuts, ``overlap`` its ``--overlap`` (pure
    DP's backward-overlapped buckets).  ``--stages S`` (2..4) lays out the
    ``data x S`` heterogeneous pipeline, ``max(N // S, 1)`` replicas; else
    ``--pp`` is ``--stages 2`` where there are 2 ranks or more."""
    device = resolve_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if args.stages > 1:
        dp, S = max(n // args.stages, 1), args.stages
    else:
        dp, S = (n // 2, 2) if args.pp and n >= 2 else (n, 1)
    n_used = dp * S
    M = (args.microbatches or 2) if S == 2 else 1
    batch = args.batch or (1024 if device.type == "cuda" else 4) * n_used
    batch = batch // (dp * M) * (dp * M)
    mode, K, why = resnet_input(args.input, args.scan_steps, device, n_used, batch)
    iters = args.iters or 30
    if K > 1:  # the JAX lab's dispatch count: max(2, iters // K) windows
        iters = max(2, iters // K) * K
    job = ResnetJob(dp, S, M, batch, iters, lr=args.lr or 0.1, seed=args.seed,
                    device=device.type, input=mode, scan_steps=K, trace_dir=args.trace_dir,
                    warmup=warmup, n_train=n_train, overlap=overlap)
    print(f"resnet18/cifar10: mesh(data={dp}, stage={S}), microbatches={M}, global "
          f"batch={batch}, {n_used} rank(s), input={mode}"
          + (f" ({K} steps per dispatch, {iters} timed steps)" if K > 1 else "")
          + (f" ({why})" if why else "") + f", device={device.type}", flush=True)
    if n_used == 1:
        r = train_resnet(None, job, telemetry)
        ranks = [{**r, "world_flops": r["flops"], "world_dt": r["dt"]}]
    else:
        ranks = spawn(resnet_rank, n_used, job, timeout=args.timeout)
    report = report_resnet(ranks, job, cards_used(n_used, device.type), device, args.log_every)
    if args.trace_dir and report is not None:
        print(f"profiler trace written to {args.trace_dir}", flush=True)
    return {"ranks": ranks, **(report or {})}


def resnet_input(asked: str, scan_steps: int, device, n_used: int,
                 batch: int) -> tuple[str, int, str]:
    """The ResNet run's input mode, its steps per dispatch and the header's
    reason for an ``auto`` that took ``hbm`` on CUDA.  ``auto`` takes
    ``hbm-scan`` on CUDA where one rank has the card to itself (the JAX
    lab's ``auto`` takes it on the accelerator), unless ``scan_steps`` is 1,
    and ``hbm`` otherwise; several ranks cannot be graphed
    (:func:`_layout_refusal`), and an explicit ``hbm-scan`` of theirs on
    CUDA raises the refusal.  Under ``hbm-scan`` K is ``scan_steps``, else
    the largest divisor of the epoch's batches up to 16."""
    refusal = _layout_refusal(device, n_used)
    mode, why = asked, ""
    if asked == "auto":
        graphable = device.type == "cuda" and refusal is None
        mode = "hbm-scan" if graphable and scan_steps != 1 else "hbm"
        if device.type == "cuda" and refusal is not None:
            why = f"auto: hbm, since {refusal}"
    if mode != "hbm-scan":
        return mode, 1, why
    if refusal is not None:
        raise refusal
    per_epoch = benchmarks.TRAIN_ROWS // batch
    return mode, scan_steps or max(k for k in range(1, 17) if per_epoch % k == 0), why


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
    steps = log.get("timed_steps", job.iters)  # a resumed run times what was left
    sps_chip = steps * job.batch / dt / cards
    tf, frac = mfu(flops, dt / steps, cards, device)
    peak = log.get("peak_bytes")
    print(f"{log['topology']}: {steps} timed steps in {dt:.3f} s (median step "
          f"{statistics.median(log['step_s']) * 1e3:.3f} ms), {sps_chip:.1f} samples/s per "
          f"card, {flops / 1e12:.4f} TFLOP per step"
          + (f", peak {peak / 2**30:.3f} GiB allocated" if peak else ""), flush=True)
    if tf is not None:
        print(f"achieved {tf:.2f} TFLOP/s per card" + (f" (MFU {frac:.2%})" if frac is not None
                                                       else ""), flush=True)
    line = benchmarks.report_line(log["layout"], sps_chip, log["input"], frac, tf)
    print(line, flush=True)
    return {"samples_per_s_per_chip": sps_chip, "cards": cards, "flops": flops, "tflops": tf,
            "mfu": frac, "peak_bytes": peak, "line": line}


if __name__ == "__main__":
    main()
