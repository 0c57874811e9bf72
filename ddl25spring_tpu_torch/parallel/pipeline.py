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

The schedule itself (:func:`make_gpipe_train_step`) knows nothing of LLaMA:
a stage callable, stage 0's input, the last stage's loss and each hop's
shape are its arguments.  :func:`make_pipeline_train_step` is its LLaMA
form; :mod:`~ddl25spring_tpu_torch.parallel.het_pipeline` is its ResNet
form.  Only ``schedule="gpipe"`` is ported; the others raise.
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


def _microbatches(batch: dict, M: int, D: int, d: int, device) -> list[dict]:
    """Replica ``d``'s rows of each of the ``M`` microbatches of ``batch`` (a
    dict of tensors leading with the global batch ``B = M * D * mb``), on
    ``device`` when it is given."""
    B = next(iter(batch.values())).shape[0]
    if B % (M * D):
        raise ValueError(f"batch {B} not divisible by {M} microbatches x {D} replicas")
    mb = B // (M * D)
    rows = {k: v.reshape(M, D * mb, *v.shape[1:])[:, d * mb:(d + 1) * mb]
            for k, v in batch.items()}
    if device is not None:
        rows = {k: v.to(device) for k, v in rows.items()}
    return [{k: v[m] for k, v in rows.items()} for m in range(M)]


def _forward(stage_fn, batch, mesh, M, in_shape, hop_dtype, inject_fn, loss_fn, grad: bool):
    """The forward half of the schedule on this rank: ``(ins, outs, losses)``,
    with ``outs`` the outputs sent on, or on the last stage each microbatch's
    loss divided by ``M``."""
    d, s = mesh.coords
    first, last = s == 0, s == mesh.grid.stages - 1
    comm = mesh.comm
    # only the first and last stages read the batch's tensors; the others
    # take their rows' shapes from it
    micro = _microbatches(batch, M, mesh.grid.data, d, mesh.device if first or last else None)
    ins, outs, losses = [], [], []
    for m in range(M):
        if first:
            x = inject_fn(micro[m])
        else:
            x = comm.recv(in_shape(micro[m]), hop_dtype, mesh.prev_rank,
                          tag=m).requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = stage_fn(x)
            if last:
                loss = loss_fn(y, micro[m])
                losses.append(loss.detach())
                outs.append(loss / M)
            else:
                comm.send(y.to(hop_dtype), mesh.next_rank, tag=m)
                outs.append(y)
        ins.append(x)
    return ins, outs, losses


def _mean_loss(losses, mesh):
    loss = torch.stack(losses).mean()
    if mesh.grid.data > 1:
        mesh.comm.all_reduce_mean_([loss], mesh.dp_group)
    return loss


def make_gpipe_loss(stage_fn, mesh, num_microbatches: int, *, in_shape, hop_dtype,
                    inject_fn, loss_fn):
    """``loss(batch)``: the pipelined forward alone, no gradients, on this rank
    of a ``D x S`` grid; the mean loss over microbatches and replicas on the
    last stage, None on the others.  Arguments as
    :func:`make_gpipe_train_step`."""

    def loss(batch: dict):
        _, _, losses = _forward(stage_fn, batch, mesh, num_microbatches, in_shape, hop_dtype,
                                inject_fn, loss_fn, grad=False)
        return _mean_loss(losses, mesh) if losses else None

    return loss


def make_gpipe_train_step(stage_fn, module: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          mesh, num_microbatches: int, *, in_shape, hop_dtype, inject_fn,
                          loss_fn, bucket_bytes=bucketing.AUTO):
    """The GPipe train step of one rank of a ``D x S`` grid, for any model cut
    into stages.

    ``stage_fn(x)`` applies this rank's stage (``module``, whose parameters
    ``optimizer`` steps).  ``step(batch)`` takes a dict of tensors whose rows
    lead with the global batch ``B = M * D * mb``; every rank is given it,
    and only the first and last stages read its tensors.  Per microbatch
    (a dict of ``mb`` rows): ``inject_fn(micro)`` is stage 0's input,
    ``loss_fn(final, micro)`` the last stage's mean loss, and
    ``in_shape(micro)`` the shape of the tensor this rank receives from the
    stage before; every hop travels in ``hop_dtype``.  The step runs this
    rank's part of the schedule, averages the stage's gradients over its DP
    group when ``D > 1`` (``bucket_bytes`` as in :func:`~ddl25spring_tpu_torch.
    parallel.dp.make_dp_train_step`), steps ``optimizer``, and returns the loss
    (the mean over microbatches and replicas) on the last stage, None on the
    others."""
    M, D = num_microbatches, mesh.grid.data
    comm = mesh.comm
    _, s = mesh.coords
    first, last = s == 0, s == mesh.grid.stages - 1
    leaves = param_leaves(module)
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    plan = bucketing.plan_buckets(leaves, bb) if bb else None

    def step(batch: dict):
        optimizer.zero_grad(set_to_none=True)
        ins, outs, losses = _forward(stage_fn, batch, mesh, M, in_shape, hop_dtype, inject_fn,
                                     loss_fn, grad=True)
        for m in reversed(range(M)):
            if last:
                outs[m].backward()
            else:
                outs[m].backward(comm.recv(outs[m].shape, hop_dtype, mesh.next_rank,
                                           tag=M + m).to(outs[m].dtype))
            if not first:
                comm.send(ins[m].grad, mesh.prev_rank, tag=M + m)
            ins[m] = outs[m] = None  # free the microbatch's graph
        if D > 1:
            comm.bucketed_all_reduce_mean_(grad_leaves(leaves), mesh.dp_group, plan)
        optimizer.step()
        return _mean_loss(losses, mesh) if last else None

    return step


def make_pipeline_train_step(stage: LlamaStage, cfg: LlamaConfig,
                             optimizer: torch.optim.Optimizer, mesh,
                             num_microbatches: int, schedule: str = "gpipe",
                             bucket_bytes=bucketing.AUTO):
    """The GPipe train step of one LLaMA rank of a ``D x S`` grid (``D = 1``:
    the pipeline alone; ``D > 1``: DP x PP, the JAX step with ``data_axis``):
    :func:`make_gpipe_train_step` over :func:`~ddl25spring_tpu_torch.models.
    llama.stage_forward`, each hop ``[mb, L, dmodel]`` in ``cfg.dtype``.

    ``step(tokens)`` takes the global ``[B, L]`` batch, ``B = M * D * mb``,
    and returns the loss on the last stage, None on the others."""
    check_schedule(schedule)
    step = make_gpipe_train_step(
        lambda x: stage_forward(stage, x, cfg), stage, optimizer, mesh, num_microbatches,
        in_shape=lambda micro: (*micro["tokens"].shape, cfg.dmodel),
        hop_dtype=getattr(torch, cfg.dtype), inject_fn=lambda micro: micro["tokens"],
        loss_fn=lambda logits, micro: causal_lm_loss(logits, micro["tokens"]),
        bucket_bytes=bucket_bytes)
    return lambda tokens: step({"tokens": tokens})
