"""Homework B2 on PyTorch: the 2 x 3 DP x PP LLaMA and the ResNet-18/CIFAR-10
benchmark step, one process per rank.

``--workload resnet`` (the default, as in ``lab/s01_b2_dp_pp.py:34``: the
BASELINE benchmark config, ``lab/run-b2.sh:7-9``) is described below.

``--workload llama`` is the counterpart of
``lab/s01_b2_dp_pp.py --workload llama`` (``run_llama``, :90-226): two
pipelines of three stages, ranks ``0..2`` and ``3..5``, the DP group of each
stage ``[0, 3] / [1, 4] / [2, 5]``; the workload constants
(vocab 4096, dmodel 288, 6 heads, 6 layers, ctx 256), 3 rows per replica in
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
(``data = N // 2``, 2 microbatches).  Batch 1024 per rank on CUDA (bf16) and
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
and puts both back after.

Run: ``python -m ddl25spring_tpu_torch.lab.dp_pp [--pp --ranks 4] [--input hbm]``
     ``python -m ddl25spring_tpu_torch.lab.dp_pp --workload llama [--iters 200]
[--device cuda] [--schedule interleaved-1f1b --chunks 2] [--ckpt-dir DIR]``
"""

from __future__ import annotations

import argparse
import contextlib
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
            batches = iter(TinyStories(get_tokenizer(), batch_size=job.batch,
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
    cfg = LlamaConfig(ctx_size=args.seq_len,
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
              ckpt_every=args.ckpt_every)
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


@dataclass
class ResnetTelemetry:
    """The bench's hooks into a one-process ResNet run (:func:`train_resnet`):
    a :class:`~ddl25spring_tpu_torch.obs.MetricsLogger` for one ``step``
    record per timed call, a :class:`~ddl25spring_tpu_torch.obs.goodput.
    GoodputMeter` billed the warm-up and each call, and a
    :class:`~ddl25spring_tpu_torch.obs.memscope.MemScope` sampled after each
    call.  Any may be None."""

    logger: object = None
    goodput: object = None
    memscope: object = None


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
    :func:`~ddl25spring_tpu_torch.obs.perfscope.measure_bench_step`."""
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
            call, step, module, _, meta = benchmarks.build_resnet_scan_step(
                mesh, job.microbatches, job.batch, lr=job.lr, device=dev, seed=job.seed,
                scan_steps=K, dataset=ds)
            feed, input_mode = (lambda: ds.scan_window(K)), f"{ds.input_mode}-scan{K}"
            first, flops = count_flops(step, ds.fixed)
        else:
            step, module, _, meta = benchmarks.build_resnet_step(
                mesh, job.microbatches, job.batch, lr=job.lr, device=dev, seed=job.seed)
            call, feed = step, (lambda: ds.fixed) if fixed else ds.feed
            input_mode = "fixed-device-batch" if fixed else ds.input_mode
            first, flops = count_flops(step, feed())
        if meter is not None:  # the build, capture and FLOP-counting step
            if cuda:
                torch.cuda.synchronize(dev)
            meter.add("warmup_compile", g0, meter.now(), label=job.input)
        comm = mesh.comm if mesh is not None else None
        _, warm, _ = benchmarks.timed_run(call, feed, 0, job.warmup - 1, device=dev, k=K,
                                          label=job.input, goodput=meter)
        if comm is not None:
            comm.take_stats()
        reports = mesh is None or mesh.coords == (0, job.stages - 1)
        sample = tel.memscope
        with traced(job.trace_dir, reports):
            dt, timed, step_s = benchmarks.timed_run(
                call, feed, job.iters // K, 0, device=dev, k=K, logger=tel.logger,
                label=job.input, samples_per_step=job.batch, goodput=meter,
                on_step=(lambda i, _loss: sample.sample(i)) if sample is not None else None)
        return {
            "rank": mesh.rank if mesh is not None else 0,
            "coords": mesh.coords if mesh is not None else (0, 0),
            "device": str(dev), "backend": mesh.backend if mesh is not None else None,
            "layout": meta["layout"], "topology": meta["topology"], "input": input_mode,
            "boundary_shapes": meta["boundary_shapes"], "n_params": meta["n_params"],
            "losses": ([] if first is None else [float(first)]) + warm + timed,
            "dt": dt, "step_s": step_s, "flops": flops,
            "comm": comm.take_stats() if comm is not None else None,
            "params_device": sorted({str(p.device) for p in module.parameters()}),
            "data_device": str(ds.x.device),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            **({"live": (step, ds.fixed, meta)} if telemetry is not None else {}),
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


def run_resnet(args, telemetry: ResnetTelemetry | None = None, warmup: int = WARMUP,
               n_train: int | None = None) -> dict:
    """``--workload resnet``: lay out the ranks, run them, print the losses,
    samples/s and TFLOP/s per card (ranks that share a card count as one
    card: :func:`~ddl25spring_tpu_torch.utils.mesh.cards_used`), MFU and
    ``report_line``, from the reporting rank (:func:`report_resnet`).
    Returns ``{"ranks", "samples_per_s_per_chip", "cards", "flops",
    "tflops", "mfu", "line"}``, or under torchrun, on a rank that does not
    report, ``{"ranks"}`` alone.  ``telemetry`` reaches a one-rank run
    (:func:`train_resnet`); ``warmup`` and ``n_train`` are the bench's
    ``--smoke`` cuts."""
    device = resolve_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 1)
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
                    warmup=warmup, n_train=n_train)
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
    sps_chip = job.iters * job.batch / dt / cards
    tf, frac = mfu(flops, dt / job.iters, cards, device)
    peak = log.get("peak_bytes")
    print(f"{log['topology']}: {job.iters} timed steps in {dt:.3f} s (median step "
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
