"""GPipe for heterogeneous stages (the ResNet-18 DP x PP step): the
counterpart of the JAX package's ``parallel/het_pipeline.py``
(``make_het_pipeline_loss``, ``make_het_pipeline_train_step``).

The JAX package runs the pipeline as one SPMD program.  Every device there
holds every stage's parameters (replicated) and picks its own stage with
``lax.switch``, and the stage boundaries travel in one flat
``[mb, max_boundary]`` buffer padded with zeros, because one ``ppermute``
carries one shape.  The port needs neither: it runs one process per rank, as
:mod:`~ddl25spring_tpu_torch.parallel.pipeline` does for LLaMA, so

- each rank holds only its own stage module (``resnet_stage(s, S)``):
  the port is stage-sharded by construction, and the JAX package's
  ``make_sharded_het_pipeline_*`` (parameters packed ``[S, maxP]`` over the
  stage axis) has no separate counterpart;
- each hop sends the boundary tensor in its own shape and the compute
  dtype, from ``boundary_shapes`` (per sample, as
  :func:`~ddl25spring_tpu_torch.models.resnet.boundary_shapes` works them
  out from the block plan); nothing is padded.

The schedule is the LLaMA pipeline's GPipe, run by the same executor,
:func:`~ddl25spring_tpu_torch.parallel.pipeline.make_schedule_train_step`
(the JAX package's het pipeline has no other schedule): the forward streams every
microbatch (``recv`` from the stage before, apply, ``send`` on, tagged by
microbatch), then the backward drains them last in, first out, sending each
input's gradient upstream; the last stage seeds each microbatch's loss with
``1/M``; then the stage's gradients are averaged over its DP group, one
all-reduce per flat bucket, and the optimizer steps.  Replica ``d`` of
``D`` takes rows ``[d * mb, (d+1) * mb)`` of each microbatch.  This module
gives the schedule the stage module, the hop shapes and a float32 loss.

One difference at bf16: the JAX program packs the last stage's float32
logits into the bf16 hop buffer before its loss, so its loss reads logits
rounded to bf16; the port computes the loss on the last stage's own float32
logits.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ddl25spring_tpu_torch.parallel import bucketing
from ddl25spring_tpu_torch.parallel.pipeline import make_schedule_loss, make_schedule_train_step

# loss_fn(final stage output, microbatch) -> scalar; inject_fn(microbatch) -> stage-0 input
LossFn = Callable[[torch.Tensor, Any], torch.Tensor]


def _hops(boundary_shapes, mesh, inject_fn, loss_fn: LossFn, compute_dtype) -> dict:
    """The schedule's keyword arguments for this rank's stage."""
    if len(boundary_shapes) != mesh.grid.size:
        raise ValueError(f"{len(boundary_shapes)} boundary shapes for "
                         f"{mesh.grid.size} stages")
    s = mesh.coords[1]
    per_sample = boundary_shapes[s - 1] if s > 0 else None

    def in_shape(micro: dict) -> tuple:
        return (next(iter(micro.values())).shape[0], *per_sample)

    return {"in_shape": in_shape, "hop_dtype": compute_dtype,
            "inject_fn": inject_fn or (lambda micro: micro["x"]),
            "loss_fn": lambda y, micro: loss_fn(y.float(), micro)}


def make_het_pipeline_loss(stage: nn.Module, loss_fn: LossFn, boundary_shapes, mesh,
                           num_microbatches: int, inject_fn=None,
                           compute_dtype: torch.dtype = torch.float32):
    """``loss(batch)``: the pipelined forward alone (no gradients) on this rank
    of a ``D x S`` grid.  ``batch`` is a dict of tensors whose rows lead with
    the global batch ``B = M * D * mb``; ``inject_fn(microbatch)`` gives stage
    0's input (default: its ``"x"``), ``loss_fn(final, microbatch)`` the
    microbatch's loss, on the last stage's output in float32.
    ``boundary_shapes[i]`` is stage ``i``'s output shape per sample.  Returns
    the mean over microbatches and replicas on the last stage, None on the
    others."""
    return make_schedule_loss([stage], mesh, num_microbatches, "gpipe",
                              **_hops(boundary_shapes, mesh, inject_fn, loss_fn, compute_dtype))


def make_het_pipeline_train_step(stage: nn.Module, loss_fn: LossFn, boundary_shapes,
                                 optimizer: torch.optim.Optimizer, mesh,
                                 num_microbatches: int, inject_fn=None,
                                 compute_dtype: torch.dtype = torch.float32,
                                 bucket_bytes=bucketing.AUTO, instrument: bool | None = None,
                                 sentinel: bool | None = None):
    """The GPipe train step of one rank of a ``D x S`` grid over heterogeneous
    stages: arguments as :func:`make_het_pipeline_loss`, plus ``optimizer``
    over ``stage``'s parameters and ``bucket_bytes`` as in
    :func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step`.
    ``step(batch)`` runs this rank's part of the schedule, averages the
    stage's gradients over its DP group when ``D > 1``, steps ``optimizer``
    and returns the loss (last stage) or None.  ``instrument`` and
    ``sentinel`` as in :func:`~ddl25spring_tpu_torch.parallel.pipeline.
    make_schedule_train_step`, strategy ``"het_pipeline"``, stage ``s``'s
    leaves under ``[s]`` as in the JAX package's tuple of stage pytrees."""
    return make_schedule_train_step([stage], stage, optimizer, mesh, num_microbatches,
                                    "gpipe", bucket_bytes=bucket_bytes,
                                    instrument=instrument, sentinel=sentinel,
                                    strategy="het_pipeline", leaf_prefix=(mesh.coords[1],),
                                    **_hops(boundary_shapes, mesh, inject_fn, loss_fn,
                                            compute_dtype))
