"""GPipe microbatch pipelining and its DP x PP hybrid: the counterpart of the
JAX package's ``parallel/pipeline.py`` (``make_pipeline_train_step`` with
``schedule="gpipe"``, ``shard_staged_params``).

The JAX package runs the pipeline as one SPMD program: a scan of ``ppermute``
hops over the mesh ``stage`` axis, differentiated by ``jax.grad``.  The port
gives the mechanism back its native form, one process per rank, as the
reference course ran it (``lab/s01_b1_microbatches.py:66-178``,
``lab/s01_b2_dp_pp.py:93-227``):

- forward: every microbatch streams through, each stage receiving its input
  from the stage before (``recv``), applying its layers and sending its
  output on (``send``), tagged by the microbatch index; the first stage
  embeds, the last takes the causal-LM loss;
- backward: then every microbatch in reverse (the LIFO drain that the scan's
  transpose performs), one ``torch.autograd.backward`` each; the gradient of
  a stage's received input goes upstream with ``send``;
- the loss: the last stage seeds each microbatch's mean cross-entropy with
  ``1/M``, as the JAX loss divides its sum by ``M``;
- DP: the gradients of each stage are then averaged over the stage's DP
  group (one all-reduce per flat bucket), the ``pmean`` over the ``data``
  axis; then ``optimizer`` steps the stage's own parameters.

The embedding lives on the first stage and ``ln_f``/``unembed`` on the last,
where the JAX package replicates them and psums their cotangents over the
stage axis (the other stages add zeros, so the gradients are the same).
Replica ``d`` takes rows ``[d * mb, (d+1) * mb)`` of each microbatch of the
global batch, the rows its device gets from the JAX step's token spec.

Only ``schedule="gpipe"`` is ported; the others raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ddl25spring_tpu_torch.models.llama import (
    LlamaStage,
    load_stage_params,
    split_blocks_for_stages,
    stage_forward,
)
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
from ddl25spring_tpu_torch.parallel import bucketing
from ddl25spring_tpu_torch.parallel.dp import grad_leaves, param_leaves
from ddl25spring_tpu_torch.utils.config import LlamaConfig

SCHEDULES = ("gpipe", "1f1b", "1f1b-stash", "interleaved", "interleaved-1f1b")


def check_schedule(schedule: str):
    """Raise unless ``schedule`` is the ported one, ``"gpipe"``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule != "gpipe":
        raise NotImplementedError(f"schedule {schedule!r} is not ported yet "
                                  "(ROADMAP A5: 1f1b, 1f1b-stash, interleaved, "
                                  "interleaved-1f1b)")


def shard_staged_params(params: dict, cfg: LlamaConfig, mesh) -> LlamaStage:
    """This rank's :class:`LlamaStage` on ``mesh.device``, loaded from the
    reference's parameter pytree: full (blocks ``[L, ...]``) or staged by
    ``split_blocks_for_stages`` (blocks ``[S, L/S, ...]``), numpy leaves."""
    S = mesh.grid.stages
    if np.ndim(params["blocks"]["wq"]) == 3:
        params = split_blocks_for_stages(params, S)
    stage = LlamaStage(cfg, mesh.coords[1], S, device=mesh.device,
                       generator=torch.Generator().manual_seed(0))
    return load_stage_params(stage, params)


def make_pipeline_train_step(stage: LlamaStage, cfg: LlamaConfig,
                             optimizer: torch.optim.Optimizer, mesh,
                             num_microbatches: int, schedule: str = "gpipe",
                             bucket_bytes=bucketing.AUTO):
    """The GPipe train step of one rank of a ``D x S`` grid (``D = 1``: the
    pipeline alone; ``D > 1``: DP x PP, the JAX step with ``data_axis``).

    ``step(tokens)`` takes the global ``[B, L]`` batch, ``B = M * D * mb``,
    runs this rank's part of the schedule, averages the stage's gradients
    over its DP group when ``D > 1`` and steps ``optimizer``.  It returns the
    loss (the mean over microbatches and replicas) on the last stage, and
    None on the others.  ``bucket_bytes`` as in :func:`~ddl25spring_tpu_torch.
    parallel.dp.make_dp_train_step`."""
    check_schedule(schedule)
    M = num_microbatches
    D = mesh.grid.data
    d = mesh.coords[0]
    comm, prev, nxt = mesh.comm, mesh.prev_rank, mesh.next_rank
    dtype = getattr(torch, cfg.dtype)
    leaves = param_leaves(stage)
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    plan = bucketing.plan_buckets(leaves, bb) if bb else None

    def step(tokens: torch.Tensor):
        B, L = tokens.shape
        if B % (M * D):
            raise ValueError(f"batch {B} not divisible by {M} microbatches x {D} replicas")
        mb = B // (M * D)
        rows = tokens.reshape(M, D * mb, L)[:, d * mb:(d + 1) * mb]
        if stage.first or stage.last:
            rows = rows.to(mesh.device)
        optimizer.zero_grad(set_to_none=True)

        ins, outs, losses = [], [], []
        for m in range(M):
            if stage.first:
                x = rows[m]
            else:
                x = comm.recv((mb, L, cfg.dmodel), dtype, prev, tag=m).requires_grad_()
            y = stage_forward(stage, x, cfg)
            if stage.last:
                loss = causal_lm_loss(y, rows[m])
                losses.append(loss.detach())
                outs.append(loss / M)
            else:
                comm.send(y, nxt, tag=m)
                outs.append(y)
            ins.append(x)
        for m in reversed(range(M)):
            if stage.last:
                outs[m].backward()
            else:
                outs[m].backward(comm.recv(outs[m].shape, dtype, nxt, tag=M + m))
            if not stage.first:
                comm.send(ins[m].grad, prev, tag=M + m)
            ins[m] = outs[m] = None  # free the microbatch's graph

        if D > 1:
            comm.bucketed_all_reduce_mean_(grad_leaves(leaves), mesh.dp_group, plan)
        optimizer.step()
        if not stage.last:
            return None
        loss = torch.stack(losses).mean()
        if D > 1:
            comm.all_reduce_mean_([loss], mesh.dp_group)
        return loss

    return step
