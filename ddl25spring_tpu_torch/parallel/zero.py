"""ZeRO stages 1, 2 and 3: the counterpart of the JAX package's
``parallel/zero.py``.

Every parameter leaf is flattened, zero-padded to ``n * k`` elements (``k =
ceil(size / n)``) and viewed as ``[n, k]``; rank ``i`` of the ``data`` axis
holds row ``i`` (a ``[1, k]`` tensor), and its optimizer state has the rows'
shapes.  A leaf is what :func:`~ddl25spring_tpu_torch.parallel.dp.
param_leaves` lists: the JAX pytree's leaves, in its flatten order, for a
model with ``param_tree()`` (LLaMA's stacked ``blocks.<key>`` is one leaf,
packed as its layers in order, the stack's ``reshape(-1)``), else the
parameters in registration order, in torch's layouts.  So a LLaMA's rows are
JAX's ``zero_shard_params`` rows element for element; a flax-bridged model's
convert through its ``export_params`` (the tests do both).

- :func:`make_zero_dp_train_step` (ZeRO-3 / FSDP, JAX ``:206``): the rows
  are the only persistent copy of the parameters.  Each step gathers the full
  parameters per bucket inside the differentiated function
  (:func:`~ddl25spring_tpu_torch.parallel.comm.gather_rows`), whose backward
  reduce-scatters each bucket's gradient SUM into this rank's rows; the step
  divides by ``n`` for the DP mean and steps the optimizer on the rows.
- :func:`make_zero_partitioned_train_step` (ZeRO-1 and ZeRO-2, JAX
  ``:459``): the parameters stay replicated and only the update is sharded:
  stage 1 all-reduces the full gradient and slices this rank's rows, stage 2
  reduce-scatters straight into them; both then all-gather the updated rows
  back into the replicated parameters.
- :func:`make_zero3_llama_train_step` (JAX ``:913``): ZeRO-3 over LLaMA's
  layers, each block's leaves their own rows under one per-layer plan,
  gathered one layer at a time: with ``prefetch`` the gather of layer
  ``i + 1`` is issued before layer ``i`` runs; without, each layer's gather
  sits inside a checkpoint, so the backward gathers it again.
- :func:`zero_clip_by_global_norm`: optax's ``clip_by_global_norm`` on the
  rows' gradients, with the global norm from one all-reduce.

Padding stays exactly zero: its gradients are zero (the gather's backward
gives the padded slots no cotangent), so SGD with momentum, Adam and AdamW
keep its moments at zero and move it by nothing, and weight decay keeps a
zero at zero.

Divergences kept on purpose: the ZeRO-3 steps free the model's own
parameters (they move to the ``meta`` device; buffers stay), since the rows
are the state and the model is only the forward's code: the forward runs
through ``torch.func.functional_call`` with the gathered tensors.  Optimizer
state is made by the optimizer's first step, as torch does, so the refusal
of a state that is neither row-shaped nor scalar (JAX ``_opt_state_specs``,
``:423``) probes a copy of the optimizer on a ``[1, 3]`` row when the step
is built.  No ``donate=`` (torch updates in place) and no PRNG key, as in
:mod:`~ddl25spring_tpu_torch.parallel.dp`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ddl25spring_tpu_torch import obs
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.parallel import bucketing
from ddl25spring_tpu_torch.parallel.bucketing import Leaf, flatten, parts, plan_buckets
from ddl25spring_tpu_torch.parallel.comm import gather_rows
from ddl25spring_tpu_torch.parallel.dp import (
    LossFn,
    _all_reduce_issue,
    _Overlap,
    grad_leaves,
    group_guard,
    param_leaves,
    shard_rows,
)
from ddl25spring_tpu_torch.utils.checkpoint import optimizer_layout

# ---------------------------------------------------------------- layout


def _size(leaf: Leaf) -> int:
    return sum(t.numel() for t in parts(leaf))


def row_elems(leaf: Leaf, n: int) -> int:
    """``k = ceil(size / n)``: the elements of one rank's row of ``leaf``."""
    return -(-_size(leaf) // n)


def _row_plan(leaves, n: int, bucket_bytes, order: str = "forward"):
    """The bucket plan over the rows (JAX ``_row_plan``, ``:59``): leaf ``i``
    takes its ``k_i`` row elements of a bucket, so one packed bucket row is
    what one rank holds of the bucket's leaves."""
    return plan_buckets(leaves, bucket_bytes, order=order, sizes=[row_elems(l, n) for l in leaves])


def _padded(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """A flat tensor zero-padded to ``n * k`` and viewed ``[n, k]``."""
    return F.pad(flat, (0, n * k - flat.numel())).view(n, k)


def _flat(leaf: Leaf) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in parts(leaf)])


@torch.no_grad()
def zero_shard_params(model, mesh, axis: str = "data") -> list[nn.Parameter]:
    """This rank's rows of every leaf of ``model`` (a module, or a list of
    leaves), on ``mesh.device``: row ``i`` of the leaf's ``[n, k]`` layout,
    ``i`` this rank's index on ``axis`` (JAX ``zero_shard_params``,
    ``:175``).  Build the optimizer over them; ZeRO-1, 2 and 3 share them."""
    leaves = param_leaves(model) if isinstance(model, nn.Module) else list(model)
    ax = mesh.axis(axis)
    n, i = ax.size, ax.index
    return [nn.Parameter(_padded(_flat(l).to(mesh.device), n, row_elems(l, n))[i:i + 1].clone())
            for l in leaves]


def zero_unshard_params(rows, template) -> list[np.ndarray]:
    """The inverse of :func:`zero_shard_params`, on the host (JAX
    ``zero_unshard_params``, ``:195``): ``rows[j]`` is leaf ``j``'s ``[n, k]``
    rows from every rank, in rank order (numpy or tensors); ``template`` the
    leaves (a module or a list; ``meta`` tensors will do).  Returns each
    leaf in its template's shape and dtype (a stacked leaf ``[L, ...]``), as
    numpy."""
    leaves = param_leaves(template) if isinstance(template, nn.Module) else list(template)
    out = []
    for r, leaf in zip(rows, leaves, strict=True):
        t = parts(leaf)[0]
        shape = (tuple(t.shape) if isinstance(leaf, torch.Tensor)
                 else (len(leaf), *t.shape))
        flat = torch.as_tensor(np.asarray(r) if not torch.is_tensor(r) else r.detach().cpu())
        out.append(flat.reshape(-1)[:_size(leaf)].reshape(shape).to(t.dtype).numpy())
    return out


def _check_rows(rows, leaves, n: int):
    want = [(1, row_elems(l, n)) for l in leaves]
    got = [tuple(r.shape) for r in rows]
    if got != want:
        raise ValueError(f"rows of shapes {got} are not the [1, k] rows of this model over "
                         f"{n} ranks, {want}: make them with zero_shard_params")


def _check_opt_state(optimizer: torch.optim.Optimizer, device):
    """Refuse an optimizer whose state holds anything but row-shaped tensors
    and scalars (JAX ``_opt_state_specs``, ``:423``): a per-row factor, as
    Adafactor's, would be computed from this rank's row alone.  Torch makes
    state at the first step, so a copy of the optimizer, with its defaults,
    steps once on a ``[1, 3]`` row and its state is read."""
    row = torch.zeros((1, 3), device=device, requires_grad=True)
    row.grad = torch.ones_like(row)
    probe = type(optimizer)([row], **optimizer.defaults)
    probe.step()
    for name, v in probe.state[row].items():
        if torch.is_tensor(v) and v.dim() > 0 and tuple(v.shape) != (1, 3):
            raise ValueError(
                f"{type(optimizer).__name__} keeps state {name!r} of shape "
                f"{tuple(v.shape)} for a [1, 3] row: state that is neither row-shaped nor "
                "a scalar is not supported by the ZeRO sharding heuristic")


def _free(model: nn.Module):
    """Move ``model``'s parameters to the ``meta`` device, in place (the
    Parameter objects stay, with their shapes and dtypes; buffers stay)."""
    for p in model.parameters():
        torch.utils.swap_tensors(p, nn.Parameter(torch.empty_like(p, device="meta"),
                                                 requires_grad=p.requires_grad))


def _pack(plan, b: int, rows) -> torch.Tensor:
    """Bucket ``b``'s rows -> one ``[r, K_b]`` tensor (JAX ``_pack_rows``)."""
    idxs = plan.buckets[b]
    return rows[idxs[0]] if len(idxs) == 1 else torch.cat([rows[i] for i in idxs], 1)


def _unpack_full(plan, b: int, full: torch.Tensor, out: list):
    """Bucket ``b``'s gathered ``[n, K_b]`` -> each of its leaves in its
    shape (JAX ``_unpack_full``, ``:157``): the leaf's column band, the
    padding dropped; a stacked leaf as its ``[L, ...]`` stack."""
    for i, off in zip(plan.buckets[b], plan.offsets(b)):
        size = math.prod(plan.shapes[i])
        out[i] = full[:, off:off + plan.sizes[i]].reshape(-1)[:size].view(plan.shapes[i])


def _packed(plan, rows) -> list[torch.Tensor]:
    """Each bucket's ``[1, K_b]`` packed rows (JAX ``_pack_rows``)."""
    return [_pack(plan, b, rows) for b in range(plan.n_buckets)]


def _gather(plan, packed, axis, pending=None) -> list[torch.Tensor]:
    """Every leaf of ``plan`` in full from this rank's ``packed`` bucket rows:
    one differentiable gather per bucket (JAX ``_gather_bucketed``,
    ``:142``); ``pending[b]`` finishes bucket ``b``'s gather issued earlier
    (:func:`_start_gather`)."""
    out: list = [None] * plan.n_leaves
    for b, p in enumerate(packed):
        _unpack_full(plan, b, gather_rows(p, axis, None if pending is None else pending[b]), out)
    return out


def _start_gather(packed, axis) -> list:
    """Issue every bucket's gather of ``packed`` without waiting: each
    bucket's ``finish``."""
    return [axis.comm.start_all_gather(p.detach().reshape(-1), axis.group, slot=b)
            for b, p in enumerate(packed)]


# ------------------------------------------------------------- the clip


@torch.no_grad()
def zero_clip_by_global_norm(grads, max_norm: float, axis) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on ZeRO's row gradients, in
    place (JAX ``zero_clip_by_global_norm``, ``:1408``): the rows are
    disjoint, so one all-reduce of their local square-norm sum (float32)
    gives the global norm, the padding adding nothing.  optax's arithmetic:
    the gradients pass untouched when ``g_norm < max_norm``, else each
    becomes ``g / g_norm * max_norm``.  Returns the global norm."""
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        sq += (g.float() ** 2).sum()
    axis.comm.all_reduce_sum_([sq], axis.group)
    g_norm = sq.sqrt()
    keep = g_norm < max_norm       # on the device: no wait for the card
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm.to(g.dtype) * max_norm))
    return g_norm


# ----------------------------------------------------------- ZeRO-3


class _LossOf(nn.Module):
    """``loss_fn(model, batch)`` as a module, for ``functional_call``."""

    def __init__(self, model: nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def _names(model: nn.Module, leaves) -> list[list[str]]:
    """Each leaf's parts' parameter names in ``model``."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    return [[by_id[id(t)] for t in parts(l)] for l in leaves]


def _microbatches(batch, M: int):
    """``batch`` split into ``M`` along dim 0, each tensor of it alike."""
    if isinstance(batch, dict):
        cols = {k: _microbatches(v, M) for k, v in batch.items()}
        return [{k: cols[k][m] for k in batch} for m in range(M)]
    if isinstance(batch, (tuple, list)):
        cols = [_microbatches(v, M) for v in batch]
        return [type(batch)(c[m] for c in cols) for m in range(M)]
    if batch.shape[0] % M:
        raise ValueError(f"per-device batch {batch.shape[0]} not divisible by "
                         f"num_microbatches={M}")
    return list(batch.chunk(M))


def _finish_rows(rows, optimizer, axis, loss, divisors: tuple, max_grad_norm, guard=None):
    """The common tail of the ZeRO-3 steps: the row gradients divided by
    each of ``divisors`` in turn (JAX's ``/ M`` then ``/ n``), the clip, the
    optimizer's step, the loss's mean over the replicas; the sentinel
    ``guard`` around the step, when there is one."""
    with torch.no_grad():
        for r in rows:
            if r.grad is None:
                r.grad = torch.zeros_like(r)
            for d in divisors:
                r.grad.div_(d)
    if max_grad_norm is not None:
        zero_clip_by_global_norm([r.grad for r in rows], max_grad_norm, axis)
    if guard is not None:
        guard.begin()
    optimizer.step()
    loss = loss.detach().clone()
    axis.comm.all_reduce_mean_([loss], axis.group)
    if guard is not None:
        guard.end(loss)
    return loss


def _row_guard(strategy: str, s_on: bool, s_policy: str, paths, rows, optimizer, axis):
    """The sentinel of a ZeRO step over this rank's ``rows`` (one per leaf
    path; a stacked leaf's as a list): the leaves' rows are disjoint over
    ``axis``, so their squared norms sum to the global ones, and the loss
    (the replicas' mean) counts once."""
    return group_guard(strategy, s_on, s_policy, list(zip(paths, rows)), optimizer, axis,
                       loss_weight=1.0 / axis.size)


def make_zero_dp_train_step(model: nn.Module, loss_fn: LossFn,
                            optimizer: torch.optim.Optimizer, mesh, rows,
                            axis: str = "data", num_microbatches: int = 1,
                            bucket_bytes=bucketing.AUTO, overlap: bool = False,
                            max_grad_norm: float | None = None,
                            instrument: bool | None = None, sentinel: bool | None = None):
    """ZeRO-3 / FSDP (JAX ``make_zero_dp_train_step``, ``:206``).  ``rows``
    are this rank's :func:`zero_shard_params` of ``model``, and
    ``optimizer`` is built over them; building the step moves ``model``'s
    parameters to ``meta``, so make the rows first.

    ``step(batch)`` takes the global batch, and this rank its rows of it
    (:func:`~ddl25spring_tpu_torch.parallel.dp.shard_rows`).  The forward
    gathers the full parameters per bucket of the row plan and runs
    ``loss_fn(model, batch)`` on them (``functional_call``); the backward
    reduce-scatters each bucket's gradient SUM into this rank's rows, which
    the step divides by ``n``; then ``max_grad_norm`` clips them
    (:func:`zero_clip_by_global_norm`), the optimizer steps, and the step
    returns the loss's mean over the replicas.  The row gradients stay in
    ``.grad`` until the next step.

    ``num_microbatches = M > 1``: this rank's rows split into ``M``, each
    microbatch gathers again, and the row gradients accumulate; they and
    the loss are divided by ``M`` (a per-rank batch that does not divide
    raises ``ValueError``).  ``bucket_bytes`` (AUTO: ``DDL25_BUCKET_BYTES``,
    4 MiB unset): one gather and one reduce-scatter per bucket; ``None``,
    one per leaf; both give the same result.  ``overlap=True`` plans the
    buckets in backward order (the reduce-scatters already run from the
    backward, as each bucket's gradients complete) and needs buckets.

    ``instrument`` (None = follow the :mod:`~ddl25spring_tpu_torch.obs` flag
    when the step is built): the static counters
    ``zero.allgather_bytes_per_step``, ``zero.reduce_scatter_bytes_per_step``
    (what JAX's ICI moves per device: ``(n - 1)/n`` of every gathered leaf,
    per microbatch) and ``zero.params_bytes_gathered``, and the counter
    ``zero.loss`` per step.  ``sentinel``: the in-step numerics sentinels
    over the row gradients, strategy ``"zero3"`` (``"zero3-overlap"``), the
    squared norms summed over ``axis`` (JAX's ``axis=``), recorded once by
    its index 0."""
    instr = obs.enabled() if instrument is None else bool(instrument)
    s_on, s_policy = sentinels.resolve(sentinel)
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    if overlap and not bb:
        raise ValueError("overlap=True needs the bucketed path; pass a bucket_bytes "
                         "threshold (or leave the AUTO default)")
    ax = mesh.axis(axis)
    n = ax.size
    leaves = param_leaves(model)
    _check_rows(rows, leaves, n)
    _check_opt_state(optimizer, mesh.device)
    # bucket_bytes None: a threshold of one byte gives every leaf its own
    plan = _row_plan(leaves, n, bb or 1, order="backward" if overlap else "forward")
    names = _names(model, leaves)
    if instr:
        gathered = sum(n * row_elems(l, n) * parts(l)[0].element_size() for l in leaves)
        wire = gathered * (n - 1) // n * num_microbatches
        obs.counters.add_static("zero.allgather_bytes_per_step", wire)
        obs.counters.add_static("zero.reduce_scatter_bytes_per_step", wire)
        obs.counters.add_static("zero.params_bytes_gathered", gathered)
    guard = _row_guard("zero3-overlap" if overlap else "zero3", s_on, s_policy,
                       [p for p, _ in sentinels.named_leaves(model)], rows, optimizer, ax)
    _free(model)
    wrapper = _LossOf(model, loss_fn)

    def full_params() -> dict:
        out = {}
        for leaf_names, full in zip(names, _gather(plan, _packed(plan, rows), ax)):
            if len(leaf_names) == 1:
                out["model." + leaf_names[0]] = full
            else:
                out.update(("model." + name, t) for name, t in zip(leaf_names, full.unbind(0)))
        return out

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        mine = shard_rows(batch, ax.index, n, mesh.device)
        mbs = [mine] if num_microbatches == 1 else _microbatches(mine, num_microbatches)
        total = None
        for mb in mbs:
            loss = torch.func.functional_call(wrapper, full_params(), (mb,))
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        divisors = (n,) if num_microbatches == 1 else (num_microbatches, n)
        loss = _finish_rows(rows, optimizer, ax, total / num_microbatches, divisors,
                            max_grad_norm, guard)
        if instr:
            obs.counters.emit("zero.loss", loss, force=True)
        return loss

    step.guard = guard
    return step


# --------------------------------------------------------- ZeRO-1 and 2


def make_zero_partitioned_train_step(model: nn.Module, loss_fn: LossFn,
                                     optimizer: torch.optim.Optimizer, mesh, rows,
                                     axis: str = "data", stage: int = 2,
                                     bucket_bytes=bucketing.AUTO, overlap: bool = False,
                                     sentinel: bool | None = None):
    """ZeRO-1 and ZeRO-2 (JAX ``make_zero_partitioned_train_step``,
    ``:459``): ``model`` stays replicated; ``rows`` (:func:`zero_shard_params`
    of it) are this rank's part of the update, and ``optimizer`` is built
    over them.

    ``step(batch)``: this rank's rows of the batch, forward and backward on
    the full model; then stage 1 all-reduces the mean of the gradient (packed
    into the ``[n, K_b]`` row buckets) and takes this rank's row, stage 2
    reduce-scatters the buckets straight into this rank's rows and divides by
    ``n``.  The optimizer steps the rows, and each bucket of updated rows is
    all-gathered back into the model's parameters.  Returns the loss's mean
    over the replicas.  ``bucket_bytes`` as in
    :func:`make_zero_dp_train_step`.

    ``overlap=True`` (needs buckets) issues the gradient collective from the
    backward, each bucket's as soon as its last gradient is accumulated
    (``register_post_accumulate_grad_hook``, :class:`~ddl25spring_tpu_torch.
    parallel.dp._Overlap`): stage 1 the all-reduce of DP's overlapped step,
    over a flat plan in backward order (the raw gradients, no padding, as
    JAX's), stage 2 the reduce-scatter of a row bucket planned in backward
    order.  The gather of the updated rows is unchanged.  ``stage`` outside
    {1, 2} raises.

    ``sentinel``: the in-step numerics sentinels over the row gradients and
    updates, strategy ``"zero1"``/``"zero2"`` (``-overlap``), summed over
    ``axis``; under ``skip`` the rows are put back before they are gathered,
    so the replicated parameters keep their values too."""
    s_on, s_policy = sentinels.resolve(sentinel)
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage} "
                         "(stage 3 is make_zero_dp_train_step)")
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    if overlap and not bb:
        raise ValueError("overlap=True needs the bucketed path; pass a bucket_bytes "
                         "threshold (or leave the AUTO default)")
    ax = mesh.axis(axis)
    n, i, comm = ax.size, ax.index, ax.comm
    leaves = param_leaves(model)
    _check_rows(rows, leaves, n)
    _check_opt_state(optimizer, mesh.device)
    order = "backward" if overlap else "forward"
    plan = _row_plan(leaves, n, bb or 1, order)
    ks = [row_elems(l, n) for l in leaves]
    guard = _row_guard(f"zero{stage}-overlap" if overlap else f"zero{stage}", s_on, s_policy,
                       [p for p, _ in sentinels.named_leaves(model)], rows, optimizer, ax)

    def padded_grad(j):
        return _padded(_flat(grad_leaves([leaves[j]])[0]), n, ks[j])

    @torch.no_grad()
    def set_row_grads(b, row):
        # bucket b's reduced [K_b] row -> each leaf's row gradient
        for j, off in zip(plan.buckets[b], plan.offsets(b)):
            rows[j].grad = row[off:off + ks[j]].view(1, -1).clone()

    def scatter_issue(b):
        buf = torch.cat([padded_grad(j) for j in plan.buckets[b]], 1)
        row = comm.reduce_scatter(buf, ax.group).div_(n)

        def finish():
            set_row_grads(b, row)

        return finish

    if overlap and stage == 1:
        flat_plan = plan_buckets(leaves, bb, order="backward")
        hooks = _Overlap(leaves, flat_plan, _all_reduce_issue(leaves, flat_plan, comm, ax.group))
    elif overlap:
        hooks = _Overlap(leaves, plan, scatter_issue)
    else:
        hooks = None

    @torch.no_grad()
    def reduce_grads():
        for b in range(plan.n_buckets):
            if stage == 2:
                scatter_issue(b)()
                continue
            buf = torch.cat([padded_grad(j) for j in plan.buckets[b]], 1)
            comm.all_reduce_mean_([buf], ax.group)
            set_row_grads(b, buf[i])

    @torch.no_grad()
    def gather_update():
        for b in range(plan.n_buckets):
            full = comm.all_gather(_pack(plan, b, rows).reshape(-1), ax.group)
            out: list = [None] * plan.n_leaves
            _unpack_full(plan, b, full, out)
            for j in plan.buckets[b]:
                values = [out[j]] if isinstance(leaves[j], torch.Tensor) else out[j].unbind(0)
                for t, v in zip(parts(leaves[j]), values, strict=True):
                    t.copy_(v)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, shard_rows(batch, i, n, mesh.device))
        if hooks is None:
            loss.backward()
            reduce_grads()
        else:
            hooks.start()
            loss.backward()
            hooks.finish()
            if stage == 1:
                with torch.no_grad():
                    for j in range(len(leaves)):
                        rows[j].grad = padded_grad(j)[i:i + 1].clone()
        if guard is not None:
            guard.begin()
        optimizer.step()
        if guard is not None:
            guard.end(loss.detach())
        gather_update()
        loss = loss.detach().clone()
        comm.all_reduce_mean_([loss], ax.group)
        return loss

    step.guard = guard
    return step


# -------------------------------------------------- LLaMA, layer by layer


@dataclass
class LlamaRows:
    """This rank's rows of a LLaMA (JAX ``zero_shard_llama_params``'s
    layout, ``:677``, the ``[L, n, k]`` stacks cut into layers): ``outer``,
    those of ``embed``, ``ln_f`` and ``unembed`` (the ordinary plan, flatten
    order); ``blocks[l]``, those of layer ``l``'s leaves, in the flatten
    order of one block's pytree."""

    outer: list[nn.Parameter]
    blocks: list[list[nn.Parameter]]

    def parameters(self) -> list[nn.Parameter]:
        """Every row, outer first: what the optimizer is built over."""
        return [*self.outer, *(r for layer in self.blocks for r in layer)]


def _llama_leaves(model):
    """``(outer leaves, per-layer leaves)`` of a :class:`~ddl25spring_tpu_torch.
    models.llama.Llama` in the JAX pytree's flatten order, with their dotted
    paths."""
    from ddl25spring_tpu_torch.models.llama import _blocks_tree

    tree = model.param_tree()
    outer = flatten({k: v for k, v in tree.items() if k != "blocks"})
    layers = [[(k, v[0]) for k, v in flatten(_blocks_tree([b]))] for b in model.blocks]
    return outer, layers


def zero_shard_llama_params(model, mesh, axis: str = "data") -> LlamaRows:
    """This rank's :class:`LlamaRows` of ``model`` on ``mesh.device``."""
    outer, layers = _llama_leaves(model)
    return LlamaRows(zero_shard_params([v for _, v in outer], mesh, axis),
                     [zero_shard_params([v for _, v in layer], mesh, axis) for layer in layers])


def _nest(pairs) -> dict:
    """A nested dict from ``(dotted path, value)`` pairs."""
    out: dict = {}
    for path, value in pairs:
        node = out
        *keys, last = path.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def llama_rows_to_jax(ranks_rows: list[LlamaRows], model) -> dict:
    """Every rank's :class:`LlamaRows`, in rank order -> JAX's
    ``zero_shard_llama_params`` layout, as numpy: ``[n, k]`` per outer key,
    ``[L, n, k]`` per block leaf (the layers' rows stacked), nested as the
    pytree.  ``model`` is the template (``meta`` parameters will do)."""
    outer, layers = _llama_leaves(model)
    out = {k: np.concatenate([_np(r.outer[j]) for r in ranks_rows])
           for j, (k, _) in enumerate(outer)}
    out["blocks"] = _nest(
        (path, np.stack([np.concatenate([_np(r.blocks[l][j]) for r in ranks_rows])
                         for l in range(len(layers))]))
        for j, (path, _) in enumerate(layers[0]))
    return out


def llama_rows_from_jax(shards: dict, model, index: int, device) -> LlamaRows:
    """Rank ``index``'s :class:`LlamaRows` from JAX's ``[n, k]`` / ``[L, n,
    k]`` shards (numpy): the inverse of :func:`llama_rows_to_jax`."""
    outer, layers = _llama_leaves(model)
    block = dict(flatten(shards["blocks"]))

    def row(a):
        return nn.Parameter(torch.from_numpy(np.array(a[index:index + 1])).to(device))

    return LlamaRows([row(shards[k]) for k, _ in outer],
                     [[row(block[path][l]) for path, _ in layers[0]]
                      for l in range(len(layers))])


def zero_unshard_llama_params(shards: dict, template) -> dict:
    """JAX's ``zero_shard_llama_params`` layout (numpy, as
    :func:`llama_rows_to_jax` makes it) -> the LLaMA pytree of
    :func:`~ddl25spring_tpu_torch.models.llama.export_params`, on the host
    (JAX ``zero_unshard_llama_params``, ``:704``)."""
    outer, layers = _llama_leaves(template)
    out = {k: zero_unshard_params([shards[k]], [v])[0] for k, v in outer}
    shapes = {path: tuple(t.shape) for path, t in layers[0]}

    def unpack(path, a):
        a = np.asarray(a)
        size = math.prod(shapes[path])
        return a.reshape(a.shape[0], -1)[:, :size].reshape((a.shape[0], *shapes[path]))

    out["blocks"] = _nest((path, unpack(path, a)) for path, a in flatten(shards["blocks"]))
    return out


def make_zero3_llama_train_step(model, optimizer: torch.optim.Optimizer, mesh, rows: LlamaRows,
                                axis: str = "data", bucket_bytes=bucketing.AUTO,
                                prefetch: bool = True, max_grad_norm: float | None = None,
                                sentinel: bool | None = None):
    """ZeRO-3 over LLaMA's layers with gather prefetch (JAX
    ``make_zero3_llama_train_step``, ``:913``).  ``rows`` are
    :func:`zero_shard_llama_params` of ``model``, the optimizer is built over
    ``rows.parameters()``; building the step moves ``model``'s parameters to
    ``meta``.

    ``step(tokens)`` takes the global ``[B, L]`` batch, this rank its rows.
    The outer leaves are gathered per bucket of their plan; the blocks one
    layer at a time, per bucket of the per-layer plan.  ``prefetch=True``:
    layer ``i + 1``'s gathers are issued (``Comm.start_all_gather``) before
    layer ``i``'s :func:`~ddl25spring_tpu_torch.models.llama.block_forward`
    runs, the last layer peeled off (it has nothing to prefetch), and
    autograd keeps each gathered layer for the backward.  ``prefetch=False``:
    each layer's gather runs inside ``torch.utils.checkpoint`` with the
    block, so the backward gathers the layer again instead of keeping it.
    The loss is ``causal_lm_loss`` (+ ``cfg.moe_aux_weight`` x the router aux
    for switch-MoE configs); the backward reduce-scatters into the rows,
    divided by ``n``; ``max_grad_norm`` clips; the optimizer steps; the
    step returns the loss's mean over the replicas.  ``bucket_bytes`` must
    be a positive threshold.  On the staged transport (gloo with the ranks
    on one card) the copy to the host waits for the card, so the prefetch
    overlaps nothing there.  ``sentinel``: the in-step numerics sentinels
    over the rows, strategy ``"zero3-prefetch"`` (``"zero3-llama"`` without
    prefetch), summed over ``axis``; a block leaf is its layers' rows."""
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    s_on, s_policy = sentinels.resolve(sentinel)
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    if not bb:
        raise ValueError("the LLaMA ZeRO-3 step is bucketed by construction; bucket_bytes "
                         "must be a positive threshold (DDL25_BUCKET_BYTES=0 cannot apply "
                         "here)")
    cfg = model.cfg
    ax = mesh.axis(axis)
    n = ax.size
    outer, layers = _llama_leaves(model)
    outer_plan = _row_plan([v for _, v in outer], n, bb)
    layer_plan = _row_plan([v for _, v in layers[0]], n, bb)
    _check_rows(rows.outer, [v for _, v in outer], n)
    for layer_rows, layer in zip(rows.blocks, layers, strict=True):
        _check_rows(layer_rows, [v for _, v in layer], n)
    _check_opt_state(optimizer, mesh.device)
    outer_keys = [k for k, _ in outer]
    block_keys = [k for k, _ in layers[0]]
    guard = _row_guard(
        "zero3-prefetch" if prefetch else "zero3-llama", s_on, s_policy,
        [tuple(k.split(".")) for k in outer_keys]
        + [("blocks", *k.split(".")) for k in block_keys],
        [*rows.outer, *([layer[j] for layer in rows.blocks] for j in range(len(block_keys)))],
        optimizer, ax)
    _free(model)
    every = rows.parameters()

    def as_block(full):
        p = SimpleNamespace()
        moe = {}
        for path, t in zip(block_keys, full):
            if path.startswith("moe."):
                moe[path[4:]] = t
            else:
                setattr(p, path, t)
        if moe:
            p.moe = moe
        return p

    def gather(plan, layer_rows, start=False):
        packed = _packed(plan, list(layer_rows))
        pending = _start_gather(packed, ax) if start else None
        return lambda: _gather(plan, packed, ax, pending)

    def one_layer(x, *layer_rows):
        return llama.block_forward(as_block(gather(layer_plan, layer_rows)()), x, cfg)

    def forward(toks):
        top = SimpleNamespace(**dict(zip(outer_keys, gather(outer_plan, rows.outer)())))
        x = llama.embed(top, toks, cfg)
        aux = 0.0
        L = len(rows.blocks)
        if prefetch:
            cur = as_block(gather(layer_plan, rows.blocks[0])())
            for l in range(L):
                # issue layer l + 1's gather before layer l runs; the last
                # layer has nothing to prefetch
                nxt = gather(layer_plan, rows.blocks[l + 1], start=True) if l + 1 < L else None
                x, a = llama.block_forward(cur, x, cfg)
                aux = aux + a
                if nxt is not None:
                    cur = as_block(nxt())
        else:
            for layer_rows in rows.blocks:
                x, a = checkpoint(one_layer, x, *layer_rows, use_reentrant=False)
                aux = aux + a
        loss = causal_lm_loss(llama.unembed(top, x, cfg), toks)
        if cfg.n_experts > 0:
            loss = loss + cfg.moe_aux_weight * aux
        return loss

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = forward(shard_rows(tokens, ax.index, n, mesh.device))
        loss.backward()
        return _finish_rows(every, optimizer, ax, loss, (n,), max_grad_norm, guard)

    step.guard = guard
    return step


# ------------------------------------------------ checkpoint and reshape


# torch's optimizer state names -> optax's ScaleByAdamState fields, so the
# state flattens as JAX's {"params", "opt_state"} (count, mu, nu) does
_OPT_ALIAS = {"step": "count", "exp_avg": "mu", "exp_avg_sq": "nu"}
_OPT_NAME = {v: k for k, v in _OPT_ALIAS.items()}


def _row_layout(model, llama: bool):
    """``[(path, leaf)]`` of ``model``'s row leaves in the rows' order: the
    plain plan's (:func:`param_leaves`'s, under the JAX paths), or LLaMA's
    outer leaves then each block leaf (its layers' rows stacked)."""
    if not llama:
        return [(p, leaf) for p, leaf in sentinels.named_leaves(model)]
    outer, layers = _llama_leaves(model)
    return ([(tuple(k.split(".")), v) for k, v in outer]
            + [(("blocks", *k.split(".")), v) for k, v in layers[0]])


def _row_list(rows) -> list:
    """Each row leaf's live rows: a ``[1, k]`` Parameter, or a LLaMA block
    leaf's per-layer list."""
    if isinstance(rows, LlamaRows):
        return [*rows.outer, *([layer[j] for layer in rows.blocks]
                               for j in range(len(rows.blocks[0])))]
    return list(rows)


def _rows_tree(paths, values, n: int, index: int, axis, device=None) -> dict:
    """A nested dict of :class:`~ddl25spring_tpu_torch.ft.reshard.Rows` under
    ``paths``; a list value is a block leaf's layers, stacked ``[L, 1, k]``."""
    from ddl25spring_tpu_torch.ft.reshard import Rows

    def rows_of(v):
        local = torch.stack(list(v)) if isinstance(v, list) else v
        return Rows(local, n, index, axis, device)

    return _nest((".".join(p), rows_of(v)) for p, v in zip(paths, values, strict=True))


def zero_state(rows, optimizer: torch.optim.Optimizer, mesh, model, axis: str = "data") -> dict:
    """This rank's live ZeRO state as the JAX package lays it out:
    ``{"params": rows, "opt_state": {"count", "mu", "nu"}}`` (Adam's names
    for torch's ``step``, ``exp_avg``, ``exp_avg_sq``; another optimizer's
    entries keep theirs), every row leaf a :class:`~ddl25spring_tpu_torch.
    ft.reshard.Rows` of its global ``[n, k]`` (``[L, n, k]`` for a LLaMA
    block leaf, layers stacked), keyed by the JAX pytree's paths.  So a
    :class:`~ddl25spring_tpu_torch.utils.checkpoint.Checkpointer` saves JAX's
    leaf shapes, and :func:`~ddl25spring_tpu_torch.ft.reshard.reshard_state`
    refits it onto another mesh's :func:`zero_resume_template`.  ``rows``
    are :func:`zero_shard_params`'s list or a :class:`LlamaRows`; ``model``
    the template (``meta`` parameters will do).  An optimizer that has not
    stepped has a fresh state's zeros."""
    ax = mesh.axis(axis)
    llama = isinstance(rows, LlamaRows)
    paths = [p for p, _ in _row_layout(model, llama)]
    live = _row_list(rows)
    first = live[0][0] if isinstance(live[0], list) else live[0]
    layout = optimizer_layout(optimizer, first.device, first.dtype)
    opt: dict = {}
    for key, (dtype, scalar_dev) in layout.items():
        name = _OPT_ALIAS.get(key, key)
        if scalar_dev is not None:
            st = optimizer.state.get(first, {})
            opt[name] = (st[key].detach().clone() if key in st
                         else torch.zeros((), dtype=dtype, device=scalar_dev))
            continue

        def get(r, key=key):
            st = optimizer.state.get(r, {})
            return st[key].detach() if key in st else torch.zeros_like(r, dtype=dtype)

        opt[name] = _rows_tree(paths, [[get(r) for r in v] if isinstance(v, list) else get(v)
                                       for v in live], ax.size, ax.index, ax)
    params = _rows_tree(paths, [[r.detach() for r in v] if isinstance(v, list) else v.detach()
                                for v in live], ax.size, ax.index, ax)
    return {"params": params, "opt_state": opt}


def zero_resume_template(model, optimizer: torch.optim.Optimizer, mesh, axis: str = "data",
                         llama: bool = False, abstract: bool = False) -> dict:
    """The restore template of a (possibly cross-mesh) ZeRO resume on this
    rank's ``mesh`` (JAX ``zero_resume_template``, ``:848``): the
    :func:`zero_state` layout a fresh run would build, its rows those of
    :func:`zero_shard_params` (:func:`zero_shard_llama_params` with
    ``llama``) and its optimizer state a fresh one's zeros, ``optimizer``
    giving the type and defaults.  Hand it (with the cursors, through
    ``ft.autosave.resume_bundle``) to ``AutoSaver.restore_or_init``: a
    checkpoint of another world size re-lands each saved ``[n, k]`` row
    layout onto this template's ``[m, k']``.

    ``abstract=True``: the same shapes and dtypes without storage (``meta``
    rows that land on ``mesh.device``, scalars that land on their own
    device), from ``model``'s shapes alone, so a model whose parameters a
    ZeRO-3 step moved to ``meta`` will do, and the elastic reshape
    (:mod:`~ddl25spring_tpu_torch.ft.elastic`) allocates no throwaway
    state."""
    ax = mesh.axis(axis)
    n = ax.size
    layout = _row_layout(model, llama)
    paths = [p for p, _ in layout]
    if abstract:
        def empty(leaf, dtype):
            return torch.empty((1, row_elems(leaf, n)), dtype=dtype, device="meta")

        first_dtype = parts(layout[0][1])[0].dtype
        outer_n = len(layout) if not llama else len(_llama_leaves(model)[0])
        L = None if not llama else len(model.blocks)

        def rows_for(dtype=None):
            vals = []
            for j, (_, leaf) in enumerate(layout):
                dt = dtype or parts(leaf)[0].dtype
                if llama and j >= outer_n:
                    vals.append([empty(leaf, dt)[0:1] for _ in range(L)])
                else:
                    vals.append(empty(leaf, dt))
            return _rows_tree(paths, vals, n, ax.index, ax, mesh.device)

        params = rows_for()
        row_device = mesh.device
    else:
        rows = zero_shard_llama_params(model, mesh, axis) if llama else \
            zero_shard_params(model, mesh, axis)
        live = _row_list(rows)
        params = _rows_tree(paths, [[r.detach() for r in v] if isinstance(v, list) else
                                    v.detach() for v in live], n, ax.index, ax)
        first_dtype = parts(layout[0][1])[0].dtype
        row_device = mesh.device

        def rows_for(dtype=None):
            return _rows_tree(paths, [[torch.zeros_like(r, dtype=dtype) for r in v]
                                      if isinstance(v, list) else torch.zeros_like(v, dtype=dtype)
                                      for v in live], n, ax.index, ax)
    opt: dict = {}
    for key, (dtype, scalar_dev) in optimizer_layout(optimizer, row_device,
                                                          first_dtype).items():
        name = _OPT_ALIAS.get(key, key)
        if scalar_dev is None:
            opt[name] = rows_for(dtype if dtype != first_dtype else None)
        elif abstract:
            opt[name] = torch.empty((), dtype=dtype, device="meta")
        else:
            opt[name] = torch.zeros((), dtype=dtype, device=scalar_dev)
    return {"params": params, "opt_state": opt}


def _tree_rows(tree: dict, model, llama: bool) -> list:
    """The :class:`~ddl25spring_tpu_torch.ft.reshard.Rows` of ``tree`` (a
    ``params`` or a moment subtree) in the rows' order."""
    from ddl25spring_tpu_torch.utils.pytree import flatten_with_path

    by_path = {tuple(p): leaf for p, leaf in flatten_with_path(tree)}
    return [by_path[p] for p, _ in _row_layout(model, llama)]


def zero_rows_from_state(state: dict, model, llama: bool = False):
    """New row Parameters holding ``state["params"]``'s rows (a
    :func:`zero_state`-layout state on this rank's mesh, as
    :func:`~ddl25spring_tpu_torch.ft.reshard.reshard_state` gives it): a
    list for the plain step, a :class:`LlamaRows` with ``llama``.  Build the
    optimizer over them and load it with :func:`zero_load_optimizer`."""
    got = _tree_rows(state["params"], model, llama)
    if not llama:
        return [nn.Parameter(r.local.detach().clone()) for r in got]
    n_outer = len(_llama_leaves(model)[0])
    outer = [nn.Parameter(r.local.detach().clone()) for r in got[:n_outer]]
    L = got[n_outer].local.shape[0]
    blocks = [[nn.Parameter(r.local[l].detach().clone()) for r in got[n_outer:]]
              for l in range(L)]
    return LlamaRows(outer, blocks)


@torch.no_grad()
def zero_load_state(state: dict, rows, optimizer: torch.optim.Optimizer, model) -> None:
    """Load a :func:`zero_state`-layout ``state`` of this rank's mesh into
    the live ``rows`` (copied in place) and ``optimizer`` (its state per row
    set anew: torch's names, a scalar such as Adam's ``step`` cloned per row
    on its own device).  Advances nothing and moves nothing else."""
    llama = isinstance(rows, LlamaRows)
    live = _row_list(rows)
    for v, r in zip(live, _tree_rows(state["params"], model, llama), strict=True):
        for l, p in enumerate(v if isinstance(v, list) else [v]):
            p.copy_(r.local[l] if isinstance(v, list) else r.local)
    zero_load_optimizer(optimizer, rows, state, model)


@torch.no_grad()
def zero_load_optimizer(optimizer: torch.optim.Optimizer, rows, state: dict, model) -> None:
    """Set ``optimizer``'s state for every row from ``state["opt_state"]``
    (see :func:`zero_load_state`)."""
    llama = isinstance(rows, LlamaRows)
    live = _row_list(rows)
    per_row: dict = {}
    for name, sub in state["opt_state"].items():
        key = _OPT_NAME.get(name, name)
        if torch.is_tensor(sub) or not isinstance(sub, dict):
            for v in live:
                for p in (v if isinstance(v, list) else [v]):
                    per_row.setdefault(p, {})[key] = torch.as_tensor(sub).clone()
            continue
        for v, r in zip(live, _tree_rows(sub, model, llama), strict=True):
            for l, p in enumerate(v if isinstance(v, list) else [v]):
                local = r.local[l] if isinstance(v, list) else r.local
                per_row.setdefault(p, {})[key] = local.to(p.device).clone()
    for p, st in per_row.items():
        optimizer.state[p] = st
