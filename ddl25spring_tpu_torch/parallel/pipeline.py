"""Microbatch pipelining and its DP x PP hybrid: the counterpart of the JAX
package's ``parallel/pipeline.py`` (``make_pipeline_train_step`` with its
five schedules, ``shard_staged_params``, ``make_grad_accum_step``,
``fuse_train_steps``).

The JAX package runs the pipeline as one SPMD program: a scan of ``ppermute``
hops over the mesh ``stage`` axis, differentiated by ``jax.grad`` (GPipe and
the interleaved schedule) or by a hand-rolled backward (the 1F1B family).
The port gives the mechanism back its native form, one process per rank, as
the reference course ran it (``lab/s01_b1_microbatches.py:66-178``,
``lab/s01_b2_dp_pp.py:93-227``).  A schedule is then the order of each
rank's actions (:mod:`~ddl25spring_tpu_torch.parallel.schedule`), and one
executor (:func:`make_schedule_train_step`) runs any of them:

- a forward ``F(v, m)`` takes chunk ``v``'s input for microbatch ``m``
  (stage 0's chunk 0 injects it, every other chunk receives it from the
  global chunk before), applies the chunk, and sends its output on; the
  last global chunk takes the causal-LM loss, seeded with ``1/M`` as the JAX
  loss divides its sum by ``M``;
- a backward ``B(v, m)`` receives the output's gradient (the last chunk
  seeds its own), back-propagates it through the chunk, and sends the
  input's gradient back;
- what a forward keeps until its backward (the stash) is the schedule's:
  its autograd graph under ``gpipe``, ``interleaved`` and ``1f1b-stash``
  (PyTorch's own form of the JAX ``stash="residuals"``: the pullback's
  residuals stay alive), or only its input under ``1f1b`` and
  ``interleaved-1f1b``: there the forward runs under ``torch.no_grad()``
  and the backward recomputes it under ``torch.enable_grad()`` first (the
  remat of the JAX default ``stash="input"``: one more forward of the chunk
  per microbatch);
- the point-to-point traffic goes in the exchanges of
  :func:`~ddl25spring_tpu_torch.parallel.schedule.comm_plan`, each posted
  whole before it is waited on (:meth:`~ddl25spring_tpu_torch.parallel.
  comm.Comm.send_recv`), whose plans the step proves deadlock-free before
  it runs;
- DP: the gradients of each stage are then averaged over the stage's DP
  group (one all-reduce per flat bucket), the ``pmean`` over the ``data``
  axis; then ``optimizer`` steps the stage's own parameters.

The embedding lives on the first chunk and ``ln_f``/``unembed`` on the
last, where the JAX package replicates them and psums their cotangents over
the stage axis (the other stages add zeros, so the gradients are the same).
Replica ``d`` takes rows ``[d * mb, (d+1) * mb)`` of each microbatch of the
global batch, the rows its device gets from the JAX step's token spec.

A chunk may add a term of its own to the loss (``extra_loss=True``: the
chunk callables return ``(out, extra)``), as a switch-MoE stage adds its
layers' weighted aux loss (JAX ``pipeline.py:458-467``): the last global
chunk adds it to its microbatch's loss; every other chunk seeds its
backward with ``1/M`` on it beside the output's cotangent (a remat
backward recomputes it too), and the step's returned loss gathers the
other chunks' terms with one sum of a scalar over the stage group.

The executor knows nothing of LLaMA: the chunk callables, stage 0's input,
the last chunk's loss and each hop's shape are its arguments.
:func:`make_pipeline_train_step` is its LLaMA form;
:mod:`~ddl25spring_tpu_torch.parallel.het_pipeline` is its ResNet form
(GPipe only, as in the JAX package).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ddl25spring_tpu_torch import obs
from ddl25spring_tpu_torch.models.llama import (
    LlamaChunkedStage,
    LlamaStage,
    load_stage_params,
    merge_blocks_from_stages,
    merge_blocks_interleaved,
    split_blocks_for_stages,
    split_blocks_interleaved,
    stage_forward,
)
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
from ddl25spring_tpu_torch.parallel import bucketing, ep, sp, tp
from ddl25spring_tpu_torch.parallel.bucketing import parts
from ddl25spring_tpu_torch.parallel.dp import grad_leaves, param_leaves
from ddl25spring_tpu_torch.parallel.schedule import (  # noqa: F401 (re-exported)
    INTERLEAVED,
    REMAT,
    SCHEDULES,
    action_ops,
    check_deadlock_free,
    check_layout,
    check_schedule,
    comm_plan,
    untag,
)
from ddl25spring_tpu_torch.utils.config import LlamaConfig


def shard_staged_params(params: dict, cfg: LlamaConfig, mesh, num_chunks: int = 1, *,
                        ep_axis: str | None = None, tp_axis: str | None = None):
    """This rank's stage on ``mesh.device``, loaded from the reference's
    parameter pytree (numpy leaves): full (blocks ``[L, ...]``), staged by
    ``split_blocks_for_stages`` (``[S, L/S, ...]``) or by
    ``split_blocks_interleaved`` (``[S, V, L/(S V), ...]``).  A
    :class:`~ddl25spring_tpu_torch.models.llama.LlamaStage` for one chunk, a
    :class:`~ddl25spring_tpu_torch.models.llama.LlamaChunkedStage` of
    ``num_chunks`` for the interleaved schedules.

    ``ep_axis`` (the data axis, EP x DP x PP): the switch-MoE expert stacks
    keep replica ``d``'s ``E/D`` experts, ``[d E/D, (d+1) E/D)``, as the
    JAX ``staged_param_specs(ep_axis=)`` (``pipeline.py:86-96``) shards dim
    2 of the ``[S, L/S, E, ...]`` stacks.  ``tp_axis`` (DP x PP x TP): the
    blocks keep model index ``t``'s Megatron slices, ``wq``/``wk``/``wv``/
    ``w_gate``/``w_up`` by column and ``wo``/``w_down`` by row, a MoE
    block's expert stacks ``E/T`` experts (``:97-121``); the router, the
    norms, ``embed``, ``ln_f`` and ``unembed`` stay whole (``P()`` there).
    The two exclude each other, as in JAX."""
    _check_ep_tp(ep_axis, tp_axis)
    S, s = mesh.grid.size, mesh.coords[1]
    if ep_axis is not None or tp_axis is not None:
        params = _full(params)
        if tp_axis is not None:
            ax = mesh.axis(tp_axis)
            params = tp.shard_tp_params(params, ax.size, ax.index, shard_vocab=False)
        if ep_axis is not None:
            ax = mesh.axis(ep_axis)
            params = dict(params, blocks=dict(params["blocks"], moe=_expert_slice(
                params["blocks"]["moe"], ax.size, ax.index)))
    if np.ndim(params["blocks"]["wq"]) == 3:
        params = (split_blocks_interleaved(params, S, num_chunks) if num_chunks > 1
                  else split_blocks_for_stages(params, S))
    gen = torch.Generator().manual_seed(0)
    if num_chunks > 1:
        stage = LlamaChunkedStage(cfg, s, S, num_chunks, device=mesh.device, generator=gen)
    else:
        stage = LlamaStage(cfg, s, S, device=mesh.device, generator=gen)
    return load_stage_params(stage, params, resize=ep_axis is not None or tp_axis is not None)


def _full(params: dict) -> dict:
    """``params`` with its blocks stacked ``[L, ...]``, from any of the three
    layouts :func:`shard_staged_params` takes."""
    nd = np.ndim(params["blocks"]["wq"])
    if nd == 4:
        return merge_blocks_from_stages(params)
    return merge_blocks_interleaved(params) if nd == 5 else params


def _expert_slice(moe: dict, n: int, i: int) -> dict:
    """Index ``i`` of ``n``'s experts of each ``[L, E, ...]`` expert stack;
    the router whole."""
    E = np.shape(moe["router"])[-1]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    El = E // n
    return {k: np.asarray(v) if k not in ep.EXPERT_KEYS
            else np.asarray(v)[:, i * El:(i + 1) * El] for k, v in moe.items()}


def _check_ep_tp(ep_axis, tp_axis):
    if ep_axis is not None and tp_axis is not None:
        raise NotImplementedError("ep_axis and tp_axis are exclusive")


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


class _Run:
    """One step of the executor on one rank: runs the plan's exchanges and
    actions, holding what is in flight between them."""

    def __init__(self, ex: "Executor", batch: dict, grad: bool, forward_only: bool):
        self.ex, self.grad = ex, grad
        S, V, s = ex.S, ex.V, ex.s
        # only the ranks of the first and last chunks read the batch's
        # tensors; the others take their rows' shapes from it
        reads = s == 0 or s == S - 1
        self.micro = _microbatches(batch, ex.M, ex.D, ex.d, ex.mesh.device if reads else None)
        self.plan = ex.forward_plan if forward_only else ex.plan
        self.inbox: dict[int, torch.Tensor] = {}   # received, by tag
        self.outbox: dict[int, torch.Tensor] = {}  # to send in the next exchange, by tag
        self.local: dict[int, torch.Tensor] = {}   # hops from this rank to itself
        self.stash: dict[tuple[int, int], dict] = {}
        self.stash_max = 0
        self.losses: list[torch.Tensor] = []
        self.extras: list[torch.Tensor] = []      # the other chunks' loss terms
        self._gv = V * S - 1

    def run(self):
        for i, (ops, unit) in enumerate(self.plan):
            if self.ex.instrument:
                # the host time at which this rank issues its i-th unit
                obs.counters.mark("pipeline.tick", i, force=True)
            self._exchange(ops)
            for kind, v, m in unit:
                (self._forward if kind == "F" else self._backward)(v, m)
        return self

    def _peer(self, stage: int) -> int:
        mesh = self.ex.mesh
        return mesh.grid.moved(mesh.rank, mesh.grid.axis, stage)

    def _exchange(self, ops):
        ex = self.ex
        sends = [(self.outbox.pop(op.tag), self._peer(op.peer), op.tag)
                 for op in ops if op.kind == "send"]
        recv_ops = [op for op in ops if op.kind == "recv"]
        recvs = []
        for op in recv_ops:
            direction, g, m = untag(op.tag, ex.S, ex.V, ex.M)
            if direction == "F":  # the input of chunk g + 1
                shape = ex.in_shape(self.micro[m])
            else:                 # the gradient of chunk g - 1's output
                shape = self.stash[((g - 1) // ex.S, m)]["out_shape"]
            recvs.append((shape, ex.hop_dtype, self._peer(op.peer), op.tag))
        if sends or recvs:
            got = ex.mesh.comm.send_recv(sends, recvs)
            self.inbox.update((op.tag, t) for op, t in zip(recv_ops, got))

    def _take(self, op) -> torch.Tensor:
        return (self.local if op.peer == self.ex.s else self.inbox).pop(op.tag)

    def _put(self, op, t: torch.Tensor):
        t = t.detach().to(self.ex.hop_dtype)
        if op.peer == self.ex.s:
            self.local[op.tag] = t
        else:
            self.outbox[op.tag] = t

    def _apply(self, v, m, x):
        """``(y, extra)``: chunk ``v`` on ``x`` and its own loss term (None
        without ``extra_loss``); on the last global chunk, microbatch ``m``'s
        loss, its term included, in place of the output, and None."""
        y = self.ex.chunk_fns[v](x)
        y, extra = y if self.ex.extra_loss else (y, None)
        if v * self.ex.S + self.ex.s == self._gv:
            loss = self.ex.loss_fn(y, self.micro[m])
            return (loss if extra is None else loss + extra), None
        return y, extra

    def _forward(self, v, m):
        ex = self.ex
        recv, send = action_ops(("F", v, m), ex.S, ex.V, ex.M, ex.s)
        if recv is None:
            x = ex.inject_fn(self.micro[m])
        else:
            x = self._take(recv)
        keep_graph = self.grad and not ex.remat
        if keep_graph and x.is_floating_point():
            x.requires_grad_(True)
        with torch.set_grad_enabled(keep_graph):
            y, extra = self._apply(v, m, x)
        if send is None:
            self.losses.append(y.detach())
        else:
            self._put(send, y)
        if extra is not None:
            self.extras.append(extra.detach().float())
        if self.grad:
            entry = {"x": x, "out_shape": tuple(y.shape)}
            if keep_graph:
                entry["y"], entry["extra"] = y, extra
            self.stash[(v, m)] = entry
            self.stash_max = max(self.stash_max, len(self.stash))

    def _backward(self, v, m):
        ex = self.ex
        recv, send = action_ops(("B", v, m), ex.S, ex.V, ex.M, ex.s)
        entry = self.stash.pop((v, m))
        x = entry["x"]
        if ex.remat:
            if x.is_floating_point():
                x.requires_grad_(True)
            with torch.enable_grad():
                y, extra = self._apply(v, m, x)
        else:
            y, extra = entry["y"], entry["extra"]
        if recv is None:
            (y / ex.M).backward()
        elif extra is not None:
            # the chunk's own loss term, seeded as the loss's 1/M
            torch.autograd.backward([y, extra], [self._take(recv).to(y.dtype),
                                                 torch.full_like(extra, 1.0 / ex.M)])
        else:
            y.backward(self._take(recv).to(y.dtype))
        if send is not None:
            self._put(send, x.grad)


class Executor:
    """The schedule of one rank, bound to its chunks and its transport (see
    :func:`make_schedule_train_step`)."""

    def __init__(self, chunk_fns, mesh, num_microbatches: int, schedule: str, *, in_shape,
                 hop_dtype, inject_fn, loss_fn, extra_loss: bool = False,
                 share_axis: str | None = None, instrument: bool = False):
        self.chunk_fns, self.mesh, self.M = list(chunk_fns), mesh, num_microbatches
        self.instrument = instrument
        self.S, self.V, self.D = mesh.grid.size, len(self.chunk_fns), mesh.grid.data
        self.d, self.s = mesh.coords[:2]
        self.share_axis = share_axis
        check_layout(schedule, self.S, self.V, self.M)
        check_deadlock_free(schedule, self.S, self.V, self.M)
        self.schedule, self.remat = schedule, schedule in REMAT
        self.plan = comm_plan(schedule, self.S, self.V, self.M, self.s)
        self.forward_plan = comm_plan(schedule, self.S, self.V, self.M, self.s,
                                      forward_only=True)
        self.in_shape, self.hop_dtype = in_shape, hop_dtype
        self.inject_fn, self.loss_fn, self.extra_loss = inject_fn, loss_fn, extra_loss

    @property
    def holds_loss(self) -> bool:
        return self.s == self.S - 1

    def mean_loss(self, run: _Run):
        """The mean loss over microbatches and replicas on the last stage,
        None on the others.  With ``extra_loss`` every rank first adds up its
        chunks' own terms and one sum over the stage group brings them to the
        last stage; with ``share_axis`` one sum over that axis adds up the
        shares."""
        extra = None
        if self.extra_loss:
            extra = (torch.stack(run.extras).sum() if run.extras
                     else torch.zeros((), device=self.mesh.device))
            self.mesh.comm.all_reduce_sum_([extra], self.mesh.axis_group)
        if not self.holds_loss:
            return None
        loss = torch.stack(run.losses).mean()
        if extra is not None:
            loss = loss + extra / self.M
        if self.share_axis is not None:
            self.mesh.comm.all_reduce_sum_([loss], self.mesh.axis(self.share_axis).group)
        if self.D > 1:
            self.mesh.comm.all_reduce_mean_([loss], self.mesh.dp_group)
        return loss


def make_schedule_loss(chunk_fns, mesh, num_microbatches: int, schedule: str = "gpipe", *,
                       in_shape, hop_dtype, inject_fn, loss_fn):
    """``loss(batch)``: the pipelined forward alone, no gradients, in the
    forward order of ``schedule``, on this rank of a ``D x S`` grid; the mean
    loss over microbatches and replicas on the last stage, None on the
    others.  Arguments as :func:`make_schedule_train_step`."""
    ex = Executor(chunk_fns, mesh, num_microbatches, schedule, in_shape=in_shape,
                  hop_dtype=hop_dtype, inject_fn=inject_fn, loss_fn=loss_fn)

    def loss(batch: dict):
        with torch.no_grad():
            run = _Run(ex, batch, grad=False, forward_only=True).run()
        return ex.mean_loss(run)

    return loss


def make_schedule_train_step(chunk_fns, module: torch.nn.Module,
                             optimizer: torch.optim.Optimizer, mesh, num_microbatches: int,
                             schedule: str = "gpipe", *, in_shape, hop_dtype, inject_fn,
                             loss_fn, extra_loss: bool = False, bucket_bytes=bucketing.AUTO,
                             share_axis: str | None = None, data_sharded=(),
                             instrument: bool | None = None, sentinel: bool | None = None,
                             strategy: str = "pipeline", leaf_prefix: tuple = (),
                             model_copies=None):
    """The train step of one rank of a ``D x S`` grid under ``schedule``, for
    any model cut into ``S * V`` chunks.

    ``chunk_fns[v](x)`` applies this rank's chunk ``v`` (global chunk
    ``v * S + s``; ``V = len(chunk_fns)``, 1 but for the interleaved
    schedules); ``module`` holds every chunk's parameters, which
    ``optimizer`` steps.  ``step(batch)`` takes a dict of tensors whose rows
    lead with the global batch ``B = M * D * mb``; every rank is given it,
    and only the first and last stages read its tensors.  Per microbatch (a
    dict of ``mb`` rows): ``inject_fn(micro)`` is the first chunk's input,
    ``loss_fn(final, micro)`` the last chunk's mean loss, and
    ``in_shape(micro)`` the shape of a chunk's input hop; every hop travels
    in ``hop_dtype``.  With ``extra_loss``, ``chunk_fns[v](x)`` returns
    ``(out, extra)``, a scalar term of the chunk's own that joins the loss
    (see the module docstring).  The step runs this rank's part of the schedule,
    averages the stage's gradients over its DP group when ``D > 1``
    (``bucket_bytes`` as in :func:`~ddl25spring_tpu_torch.parallel.dp.
    make_dp_train_step`), steps ``optimizer``, and returns the loss (the
    mean over microbatches and replicas) on the last stage, None on the
    others.  ``step.stats["stash_max"]`` is the most microbatch-chunks the
    last step held in flight at once.

    On a grid with more axes than ``data x stage`` (``data`` outermost,
    ``stage`` second) the pipeline's peers are the ranks that differ from
    this one only in ``stage``.  ``share_axis``: each rank's loss is its
    share of its replica's, summed over that axis (sequence parallelism),
    as are the gradients: one all-reduce over ``data`` and ``share_axis``
    together averages them, times the axis' size.  ``data_sharded``: the
    parameters that differ between replicas (expert parallelism's expert
    stacks), whose gradients already hold every replica's share: they are
    divided by ``D`` in place of the average.

    ``instrument`` (None = follow the :mod:`~ddl25spring_tpu_torch.obs` flag
    when the step is built): the static counters ``pipeline.num_stages``,
    ``pipeline.num_microbatches``, ``pipeline.num_chunks`` and
    ``pipeline.bubble_fraction_gpipe`` (:func:`~ddl25spring_tpu_torch.obs.
    counters.gpipe_bubble_fraction` of ``S`` and ``M V``), and the
    ``pipeline.tick`` series: the host time at which the executor issues
    each unit of the rank's plan (JAX marks the arrival of a device
    callback per scan tick).  ``sentinel`` (None = follow
    ``DDL25_SENTINELS`` when the step is built): the in-step numerics
    sentinels, ``strategy`` (``"pipeline"``), over the whole model as JAX's
    global guard sees it: each rank's facts for the leaves it holds (paths
    of ``module``'s pytree after ``leaf_prefix``; the union over the ranks
    is agreed when the step is built) are summed over every rank, each
    leaf's squared norm over the ranks that hold a copy of it (the ``D``
    replicas unless ``data_sharded``, ``model_copies(path)`` members of a
    model line, every seq shard) and the loss over the last stage's ranks;
    rank 0 records.  The guard adds no hook and comes after the step's
    reductions, so the schedule runs as without it."""
    instr = obs.enabled() if instrument is None else bool(instrument)
    s_on, s_policy = sentinels.resolve(sentinel)
    ex = Executor(chunk_fns, mesh, num_microbatches, schedule, in_shape=in_shape,
                  hop_dtype=hop_dtype, inject_fn=inject_fn, loss_fn=loss_fn,
                  extra_loss=extra_loss, share_axis=share_axis, instrument=instr)
    if instr:
        obs.counters.add_static("pipeline.num_stages", ex.S)
        obs.counters.add_static("pipeline.num_microbatches", ex.M)
        obs.counters.add_static("pipeline.num_chunks", ex.V)
        obs.counters.add_static("pipeline.bubble_fraction_gpipe",
                                obs.gpipe_bubble_fraction(ex.S, ex.M * ex.V))
    mine = {id(p) for p in data_sharded}
    leaves = [leaf for leaf in param_leaves(module) if id(parts(leaf)[0]) not in mine]
    local = [p for p in module.parameters() if id(p) in mine]
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    plan = bucketing.plan_buckets(leaves, bb) if bb else None
    if share_axis is None:
        group, n_share = (mesh.dp_group if ex.D > 1 else None), 1
    else:
        names = ("data", share_axis) if ex.D > 1 else share_axis
        group, n_share = mesh.axis(names).group, mesh.axis(share_axis).size
    guard = None
    if s_on:
        named = [((*leaf_prefix, *path), leaf)
                 for path, leaf in sentinels.named_leaves(module)]
        world = mesh.grid.world

        def copies(path, leaf) -> int:
            d = 1 if id(parts(leaf)[0]) in mine else ex.D
            return d * n_share * (model_copies(path[len(leaf_prefix):]) if model_copies else 1)

        guard = sentinels.Guard(
            strategy, named, optimizer, policy=s_policy,
            names=sentinels.global_names([p for p, _ in named], dist.group.WORLD),
            weights={p: 1.0 / copies(p, leaf) for p, leaf in named},
            loss_weight=ex.S / world, group=dist.group.WORLD if world > 1 else None,
            comm=mesh.comm, record=mesh.rank == 0)

    def step(batch: dict):
        optimizer.zero_grad(set_to_none=True)
        run = _Run(ex, batch, grad=True, forward_only=False).run()
        step.stats.update(stash_max=run.stash_max)
        if ex.D * n_share > 1:
            grads = grad_leaves(leaves)
            mesh.comm.bucketed_all_reduce_mean_(grads, group, plan)
            if n_share > 1:
                torch._foreach_mul_([g for leaf in grads for g in parts(leaf)], n_share)
        if ex.D > 1 and local:
            torch._foreach_div_([p.grad for p in local], ex.D)
        if guard is None:
            optimizer.step()
            return ex.mean_loss(run)
        guard.begin()
        optimizer.step()
        loss = ex.mean_loss(run)
        guard.end(loss)
        return loss

    step.stats = {"stash_max": 0}
    step.guard = guard
    return step


SP_SCHEDULES = ("gpipe", "1f1b", "interleaved-1f1b")


def check_compositions(cfg: LlamaConfig, mesh, schedule: str, *, ep_axis=None,
                       tp_axis=None, seq_axis=None, sp_mode: str = "ring"):
    """The JAX package's refusals of the pipeline compositions, with its
    messages: EP with TP (``staged_param_specs``), SP outside gpipe, 1f1b and
    interleaved-1f1b (``make_pipeline_train_step``), SP with EP
    (``make_pipeline_loss``), SP with MoE under the 1F1B backward
    (``make_1f1b_value_and_grad``), an SP mode or a Ulysses head count that
    does not fit (``_check_sp``: the local heads ``H / T`` under TP), heads or
    experts that do not split over TP (``_check_tp``), and EP without
    experts, EP over any axis but ``data``, experts that do not split over
    it (``_ep_moe_fn``)."""
    _check_ep_tp(ep_axis, tp_axis)
    if seq_axis is not None:
        if schedule not in SP_SCHEDULES:
            raise NotImplementedError(
                "seq_axis rides gpipe, 1f1b, and interleaved-1f1b (the residual-stash and "
                "scan-transpose-interleaved backwards are not wired for sequence-sharded "
                "stages)")
        if ep_axis is not None:
            raise NotImplementedError(
                "seq_axis with ep_axis is not wired (the EP a2a over data and the ring "
                "over seq are untested together)")
        if schedule != "gpipe" and cfg.n_experts > 0:
            raise NotImplementedError("SP under 1F1B ships dense blocks (no MoE/EP "
                                      "composition)")
        if sp_mode not in sp.MODES:
            raise ValueError(f"unknown SP mode {sp_mode!r}")
        n = mesh.axis(seq_axis).size
        local_heads = cfg.num_heads // (mesh.axis(tp_axis).size if tp_axis else 1)
        if sp_mode == "ulysses" and local_heads % n:
            raise ValueError(f"ulysses SP needs local heads ({local_heads}) divisible by "
                             f"the {seq_axis!r} axis size ({n})")
    if tp_axis is not None:
        t = mesh.axis(tp_axis).size
        if cfg.num_heads % t:
            raise ValueError(f"num_heads ({cfg.num_heads}) not divisible by {tp_axis}={t}")
        if cfg.n_experts > 0 and cfg.n_experts % t:
            raise ValueError(f"n_experts ({cfg.n_experts}) not divisible by {tp_axis}={t}")
    if ep_axis is not None:
        if cfg.n_experts <= 0:
            raise ValueError("ep_axis given but cfg.n_experts == 0")
        if ep_axis != "data":
            raise ValueError(f"ep_axis {ep_axis!r} must be the data axis 'data'")
        n = mesh.axis(ep_axis).size
        if cfg.n_experts % n:
            raise ValueError(f"{cfg.n_experts} experts not divisible by {ep_axis}={n}")


def make_pipeline_train_step(stage: LlamaStage | LlamaChunkedStage, cfg: LlamaConfig,
                             optimizer: torch.optim.Optimizer, mesh,
                             num_microbatches: int, schedule: str = "gpipe",
                             num_chunks: int = 1, bucket_bytes=bucketing.AUTO, *,
                             ep_axis: str | None = None, tp_axis: str | None = None,
                             seq_axis: str | None = None, sp_mode: str = "ring",
                             instrument: bool | None = None, sentinel: bool | None = None):
    """The train step of one LLaMA rank of a ``D x S`` grid (``D = 1``: the
    pipeline alone; ``D > 1``: DP x PP, the JAX step with ``data_axis``) under
    ``schedule``, one of :data:`SCHEDULES`:
    :func:`make_schedule_train_step` over :func:`~ddl25spring_tpu_torch.
    models.llama.stage_forward` of each chunk, each hop ``[mb, L, dmodel]``
    in ``cfg.dtype``.  ``num_chunks > 1`` (a
    :class:`~ddl25spring_tpu_torch.models.llama.LlamaChunkedStage` of that
    many chunks) needs an interleaved schedule, ``interleaved-1f1b`` needs
    ``num_chunks >= 2``, and the interleaved schedules need ``M % S == 0``;
    each raises ``ValueError`` as the JAX function does (``:1325-1362``).

    Switch-MoE configs (``cfg.n_experts > 0``): each chunk dispatches the
    ``[mb L, D]`` tokens of its microbatch and adds ``cfg.moe_aux_weight``
    times its layers' aux to the loss (``extra_loss``), so the loss is the
    mean over the ``M D`` microbatches of ``causal_lm_loss + w aux``, the JAX
    scalar (``pipeline.py:289-297``).

    The compositions, with the JAX names (``pipeline.py:1258``), each on a
    grid with that axis (:func:`~ddl25spring_tpu_torch.utils.mesh.init_mesh`)
    and the stage from :func:`shard_staged_params` with the same axes:

    - ``ep_axis="data"`` (EP x DP x PP, MoE configs, every schedule): each
      chunk's MoE runs :func:`~ddl25spring_tpu_torch.parallel.ep.ep_moe_local`
      over the stage's DP group, routing and capacity per replica decided
      before the all-to-all, so loss and gradients are the replicated-expert
      pipeline's, drops included.  An expert stack's gradient already holds
      every replica's tokens (the all-to-all's backward brought them): it is
      divided by ``D``, not averaged (the JAX ``1/n``, ``:1190-1205``);
    - ``tp_axis`` (DP x PP x TP, every schedule): Megatron slices inside
      each block (``block_forward(tp_axis=)``; MoE: the expert-sharded
      :func:`~ddl25spring_tpu_torch.parallel.tp.make_tp_moe_fn`); the
      embedding and the head are whole, so every hop carries the full
      activation between the same model index of neighbouring stages, the
      loss is the same on every member and every gradient is whole;
    - ``seq_axis`` with ``sp_mode`` ``"ring"`` or ``"ulysses"`` (SP inside
      the stages; gpipe, 1f1b and interleaved-1f1b, MoE under gpipe only):
      index ``i`` of ``n`` holds the positions ``[i L/n, (i+1) L/n)``, the
      blocks take their global RoPE positions and the attention of
      :func:`~ddl25spring_tpu_torch.parallel.sp.make_sp_attn_fn` (the flash
      ring under ``cfg.use_flash``), the last stage's targets come from one
      shift over ``seq`` before the schedule runs, and each rank's loss is
      its share, its cross-entropy sum over the global count of predicted
      positions (a MoE chunk's aux over ``n``, the shards' mean): the shares
      and their gradients are summed over ``seq`` (``share_axis``).  Composes
      with ``tp_axis`` (PP x SP x TP).

    :func:`check_compositions` raises, before anything runs, on what the JAX
    package refuses.  ``step(tokens)`` takes the global ``[B, L]`` batch,
    ``B = M * D * mb``, and returns the loss on the last stage (the same on
    every member of its ``model`` and ``seq`` lines), None on the others.

    ``instrument`` and ``sentinel`` (None: the flags when the step is
    built) as in :func:`make_schedule_train_step`, strategy ``"pipeline"``,
    with the leaves of the JAX pytree (``grads['blocks']['wq']``...); an
    instrumented MoE chunk also emits its layers' aux (the ``E Σ f_e P_e``
    load balance, 1.0 when balanced) as ``pipeline.moe_aux`` per forward.
    ``step.guard`` is the sentinel (None when off)."""
    chunks = stage.chunks if isinstance(stage, LlamaChunkedStage) else [stage]
    if len(chunks) != num_chunks:
        raise ValueError(f"the stage holds {len(chunks)} chunks, num_chunks={num_chunks}")
    check_compositions(cfg, mesh, schedule, ep_axis=ep_axis, tp_axis=tp_axis,
                       seq_axis=seq_axis, sp_mode=sp_mode)
    moe = cfg.n_experts > 0
    block_kw = {}
    if tp_axis is not None:
        block_kw["tp_axis"] = mesh.axis(tp_axis)
        if moe:
            block_kw["moe_fn"] = tp.make_tp_moe_fn(block_kw["tp_axis"], cfg.capacity_factor,
                                                   cfg.moe_top_k)
    if ep_axis is not None:
        ep_ax = mesh.axis(ep_axis)

        def ep_moe(mp, flat):
            return ep.ep_moe_local(mp, flat, ep_ax, cfg.capacity_factor, top_k=cfg.moe_top_k)

        block_kw["moe_fn"] = ep_moe
    seq = mesh.axis(seq_axis) if seq_axis is not None else None
    aux_scale = cfg.moe_aux_weight / (seq.size if seq is not None else 1)
    instr = obs.enabled() if instrument is None else bool(instrument)

    def chunk_fn(c):
        def apply(x):
            kw = dict(block_kw)
            if seq is not None:
                Ll = x.shape[1]
                pos = seq.index * Ll + torch.arange(Ll, device=x.device)
                kw.update(pos=pos, attn_fn=sp.make_sp_attn_fn(cfg, seq, sp_mode, pos))
            out, aux = stage_forward(c, x, cfg, with_aux=True, **kw)
            if moe and instr:
                obs.counters.emit("pipeline.moe_aux", aux, force=True)
            return (out, aux_scale * aux) if moe else out

        return apply

    shard = {}  # the last stage's valid-position mask, set per step

    if seq is None:
        def loss_fn(logits, micro):
            return causal_lm_loss(logits, micro["tokens"])
    else:
        def loss_fn(logits, micro):
            mb, Ll = micro["tokens"].shape
            return (sp.sp_local_ce_sum(logits, micro["targets"], shard["valid"])
                    / (mb * (seq.size * Ll - 1)))

    data_sharded = ([p for b in stage.blocks for k, p in b.moe.named_parameters()
                     if k in ep.EXPERT_KEYS] if ep_axis is not None else ())
    model_copies = None
    if tp_axis is not None:
        split, T = tp._split_dims(False, cfg.n_experts), mesh.axis(tp_axis).size

        def model_copies(path):
            return 1 if split[".".join(path)] is not None else T

    step = make_schedule_train_step(
        [chunk_fn(c) for c in chunks], stage, optimizer, mesh,
        num_microbatches, schedule,
        in_shape=lambda micro: (*micro["tokens"].shape, cfg.dmodel),
        hop_dtype=getattr(torch, cfg.dtype), inject_fn=lambda micro: micro["tokens"],
        loss_fn=loss_fn, extra_loss=moe, bucket_bytes=bucket_bytes, share_axis=seq_axis,
        data_sharded=data_sharded, instrument=instr, sentinel=sentinel,
        model_copies=model_copies)
    last = mesh.coords[1] == mesh.grid.size - 1

    def tokens_step(tokens):
        if seq is None:
            return step({"tokens": tokens})
        L = tokens.shape[1]
        if L % seq.size:
            raise ValueError(f"sequence length {L} does not split over {seq.size} seq shards")
        Ll = L // seq.size
        batch = {"tokens": tokens[:, seq.index * Ll:(seq.index + 1) * Ll]}
        if last:
            # the targets of the shard's last position, from the next index,
            # once for the whole batch before the schedule runs
            mine = batch["tokens"].to(mesh.device)
            targets, shard["valid"] = sp.sp_shifted_targets(mine, seq)
            batch = {"tokens": mine, "targets": targets}
        return step(batch)

    tokens_step.stats = step.stats
    tokens_step.guard = step.guard
    return tokens_step


def make_grad_accum_step(model: torch.nn.Module, loss_fn, optimizer: torch.optim.Optimizer,
                         num_microbatches: int):
    """Single-process microbatch gradient accumulation (the JAX
    ``make_grad_accum_step``, ``pipeline.py:1576``): the capability of
    ``s01_b1_microbatches.py``'s accumulation (the homework's unzeroed
    ``.grad``) without the stage split.

    ``step(batch, generators)``: every tensor of ``batch`` (a tensor, or a
    tuple, list or dict of them) is chunked on dim 0 into ``M`` pieces;
    ``loss_fn(model, microbatch, generators[m])`` and its backward run per
    microbatch, the gradients adding up in ``.grad``; then the sum is scaled
    by ``1/M``, ``optimizer`` takes one step, and the step returns the mean
    loss.  The ``M`` generators stand in for ``jax.random.split(key, M)``:
    draw them per ``(seed, step, m)`` with :func:`~ddl25spring_tpu_torch.
    utils.prng.seeded_generator`.  With a DP mesh, give it the rows of this
    replica (:func:`~ddl25spring_tpu_torch.parallel.dp.shard_rows`) and
    average the gradients before the step, as ``make_dp_train_step`` does."""
    M = num_microbatches

    def chunk(x, m):
        if isinstance(x, dict):
            return {k: chunk(v, m) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(chunk(v, m) for v in x)
        if x.shape[0] % M:
            raise ValueError(f"batch of {x.shape[0]} rows not divisible by {M} microbatches")
        n = x.shape[0] // M
        return x[m * n:(m + 1) * n]

    def step(batch, generators):
        if len(generators) != M:
            raise ValueError(f"{len(generators)} generators for {M} microbatches")
        optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for m in range(M):
            loss = loss_fn(model, chunk(batch, m), generators[m])
            loss.backward()
            total = total + loss.detach()
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(M)
        optimizer.step()
        return total / M

    return step


WARMUP_STEPS = 2  # eager steps before a capture: builds, cuDNN's search, optimizer state


def graph_refusal(device, comm=None) -> Exception | None:
    """Why the train steps of a rank on ``device`` whose transport is
    ``comm`` (None: a process alone, nothing to exchange) cannot be captured
    as one CUDA graph: the exception :func:`fuse_train_steps` raises, or
    None.  On the CPU there is nothing to capture (fusion is a loop there),
    so nothing is refused."""
    if torch.device(device).type != "cuda" or comm is None:
        return None
    if comm.staged:
        return ValueError(
            "K train steps per dispatch are one CUDA graph on the card, and this rank's "
            "transport stages through the host (gloo over a card's tensors: pinned host "
            "buffers, Comm.staged); a CUDA graph cannot hold a host copy")
    return NotImplementedError(
        f"capturing a multi-rank step over {comm.backend} (its collectives inside a CUDA "
        "graph) is not ported yet (ROADMAP A14, the multi-card items)")


def _map(fn, window, *like):
    """``fn`` over the tensors of a window (a tensor, or a dict, tuple or list
    of them), with the matching tensors of windows ``like`` it."""
    if isinstance(window, dict):
        return {key: _map(fn, window[key], *(w[key] for w in like)) for key in window}
    if isinstance(window, (tuple, list)):
        return type(window)(_map(fn, *parts) for parts in zip(window, *like))
    return fn(window, *like)


def _leading(window) -> int:
    sizes = set()
    _map(lambda t: sizes.add(t.shape[0]), window)
    if len(sizes) != 1:
        raise ValueError(f"window tensors lead with different sizes {sorted(sizes)}")
    return sizes.pop()


def _row(window, i: int):
    """Batch ``i`` of a window: row ``i`` of every tensor in it."""
    return _map(lambda t: t[i], window)


def _copy_in(static: torch.Tensor, t: torch.Tensor):
    if t.shape != static.shape or t.dtype != static.dtype:
        raise ValueError(f"the graph was captured for a window tensor of "
                         f"{tuple(static.shape)} {static.dtype}, got {tuple(t.shape)} {t.dtype}")
    static.copy_(t)


def _losses(outs: list):
    """The ``[k]`` losses of ``k`` steps, or None where the steps return None
    (a pipeline rank that does not hold the loss)."""
    return None if outs[0] is None else torch.stack(outs)


class _Snapshot:
    """``module``'s parameters and buffers and ``optimizer``'s state, kept
    so that the warm-up steps before a capture leave no trace.  Restoring
    writes in place, so every tensor keeps its address (a captured graph
    reads and writes them there).  State that the warm-up created is set to
    zeros: a fresh Adam state (step 0, zero moments) and a zero SGD
    momentum (``0.9 * 0 + g`` is ``g``, the first step's buffer) both take
    the first step the optimizer would take from nothing."""

    def __init__(self, module: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.module, self.optimizer = module, optimizer
        self.tensors = [t.detach().clone() for t in module.state_dict().values()]
        self.state = {p: {key: v.detach().clone() if torch.is_tensor(v) else v
                          for key, v in st.items()}
                      for p, st in optimizer.state.items()}

    @torch.no_grad()
    def restore(self):
        for t, saved in zip(self.module.state_dict().values(), self.tensors):
            t.copy_(saved)
        for p, st in self.optimizer.state.items():
            before = self.state.get(p)
            for key, v in st.items():
                if torch.is_tensor(v) and before:
                    v.copy_(before[key])
                elif torch.is_tensor(v):
                    v.zero_()
                elif before:
                    st[key] = before[key]


class FusedSteps:
    """``k`` train steps per call: see :func:`fuse_train_steps`."""

    def __init__(self, step_fn, k: int, module, optimizer, device, comm=None,
                 dump_graph: str | None = None):
        if k < 1:
            raise ValueError(f"fusing needs k >= 1 steps, got {k}")
        refusal = graph_refusal(device, comm)
        if refusal is not None:
            raise refusal
        self.step_fn, self.k, self.module, self.optimizer = step_fn, k, module, optimizer
        self.device, self.dump_graph = torch.device(device), dump_graph
        self.name = getattr(step_fn, "__qualname__", repr(step_fn))
        self.guard = getattr(step_fn, "guard", None)
        self.graph = None

    def __call__(self, window):
        n = _leading(window)
        if n != self.k:
            raise ValueError(f"fused for {self.k} steps but got a window of {n} batches: "
                             "the caller's step accounting would silently drift")
        if self.device.type != "cuda":
            return _losses([self.step_fn(_row(window, i)) for i in range(self.k)])
        if self.guard is not None:
            sentinels.flush(block=self.guard.mode == "halt")
        if self.graph is None:
            self._capture(window)
        _map(_copy_in, self.static, window)
        self.graph.replay()
        if self.guard is not None:
            self.guard.window_done()
        return None if self.out is None else self.out.clone()

    def _capture(self, window):
        dev = self.device
        self.static = _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), window)
        _map(_copy_in, self.static, window)
        snapshot = _Snapshot(self.module, self.optimizer)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # the warm-up's steps are undone below, and a guard records none of them
        muted = self.guard.muted() if self.guard is not None else contextlib.nullcontext()
        with torch.cuda.stream(stream), muted:
            for i in range(min(WARMUP_STEPS, self.k)):
                self.step_fn(_row(self.static, i))
            snapshot.restore()
        torch.cuda.current_stream(dev).wait_stream(stream)
        # a graph kept past its instantiation, for the dump
        graph = torch.cuda.CUDAGraph(keep_graph=bool(self.dump_graph))
        if self.dump_graph:
            graph.enable_debug_mode()
        # a guarded step writes its facts into row i of a static [k, n] buffer
        window = (self.guard.capture(self.k) if self.guard is not None
                  else contextlib.nullcontext())
        try:
            with window, torch.cuda.graph(graph, stream=stream):
                self.out = _losses([self.step_fn(_row(self.static, i))
                                    for i in range(self.k)])
        except Exception as e:  # a host sync, a host copy, a non-capturable optimizer
            raise RuntimeError(f"capturing {self.k} steps of {self.name} as one CUDA graph "
                               f"failed: {e}") from e
        if self.dump_graph:
            graph.debug_dump(self.dump_graph)
            graph.instantiate()
        self.graph = graph


def fuse_train_steps(step_fn, k: int, *, module: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, device, comm=None,
                     dump_graph: str | None = None) -> FusedSteps:
    """Fuse ``k`` train steps into one dispatch: the counterpart of the JAX
    ``fuse_train_steps`` (``pipeline.py:1379``), whose ``lax.scan`` of ``k``
    steps is one compiled program.

    ``step_fn(batch)`` is one of the port's steps, which update ``module``
    and ``optimizer`` in place and return the loss (``make_train_step``,
    ``make_grad_accum_step`` with its generators bound,
    ``build_resnet_step``'s step).  The result ``multi(window)`` takes ``k``
    stacked batches (a ``[k, B, ...]`` tensor, or a dict, tuple or list of
    them) and returns the ``[k]`` losses on the device (None where the step
    returns None); a window that does not lead with ``k`` raises
    ``ValueError``, as in JAX.

    On CUDA (``device``) the ``k`` steps are one ``torch.cuda.CUDAGraph``
    that reads a static ``[k, ...]`` input buffer: each call copies the
    window in and replays the graph once.  The first call builds it: a
    snapshot of ``module`` and ``optimizer``, :data:`WARMUP_STEPS` eager
    steps on a side stream on the window's first batches (they build the
    kernels, set their shared-memory attributes, run cuDNN's algorithm
    search and create the optimizer state), the snapshot restored in place,
    then the capture, which runs nothing; so every replay, the first
    included, takes ``k`` real steps from where the caller left the model.
    One graph holds the whole window, as one dispatch holds ``k`` steps in
    JAX; within a capture the memory a step frees returns to the graph's
    pool for the next, so the graph needs about one step's memory.  A
    capture that fails raises ``RuntimeError`` naming the step; nothing
    falls back to eager steps.  An optimizer that keeps host state per step
    cannot be captured: Adam needs ``capturable=True``.  A step whose
    transport stages through the host raises ``ValueError``, and a
    multi-rank step over NCCL ``NotImplementedError``, here, before anything
    runs (:func:`graph_refusal`).  ``dump_graph``: a path to write the
    captured graph to (``CUDAGraph.debug_dump``), to count its nodes.

    A step built with the sentinel on (``step_fn.guard``): the warm-up steps
    record nothing, each captured step writes its facts into its row of a
    static ``[k, n]`` buffer the graph fills, and each call stages the
    window's ``k`` records after its replay and folds the previous
    window's (in step order) before it; the ``skip`` select is captured
    with the step, so a poisoned step inside the window is undone on the
    card.

    On the CPU ``multi`` is a loop of ``k`` calls of ``step_fn``.  Nothing
    on CUDA takes that loop."""
    return FusedSteps(step_fn, k, module, optimizer, device, comm, dump_graph)


def describe(mesh, num_microbatches: int = 4, stage_axis: str = "stage",
             params: dict | None = None):
    """The ``describe()`` of ``pipeline`` (JAX ``parallel/pipeline.py:1505``):
    one GPipe step of a 4-layer tiny LLaMA over ``mesh``'s stages (``M = 4``
    microbatches of 2 rows), its inputs and its collective signature, for
    :mod:`~ddl25spring_tpu_torch.obs.comm_analytics`.

    Signature, from what the executor issues on each rank of an ``S``-stage
    pipeline: every microbatch's boundary activation ``[mb, L, dmodel]``
    travels once downstream in the forward and its gradient once upstream in
    the backward, each of ``boundary_bytes``, all over the stage axis; no
    other kind.  A send and a receive posted in one exchange are one
    ``collective-permute`` (the turn of the schedule on stage 0 pairs the
    last forward send with the first backward receive), so an end stage
    counts ``2 M - 1`` or ``2 M``, an interior one between ``2 M`` and
    ``4 M``.

    Where JAX's compiled inventory differs (``meta["differs_from_jax"]``):

    - collective-permute, count and bytes: the JAX program moves the boundary
      buffer around the whole stage ring at every one of the ``M + S - 1``
      ticks, bubbles included, forward and back (``2 (M + S - 1)`` permutes);
      the port sends only the ``M`` real hops each way;
    - all-reduce, present in JAX only: every JAX device holds the replicated
      embedding, final norm and head and the loss, whose gradients and value
      the program sums over the stage ring; the port's stage 0 alone holds
      the embedding and the last stage the norm, the head and the loss."""
    from ddl25spring_tpu_torch.models.llama import export_params
    from ddl25spring_tpu_torch.parallel.dp import tiny_llama, tiny_tokens

    S = mesh.axis(stage_axis).size
    M, mb = num_microbatches, 2
    cfg, model = tiny_llama(mesh, 4, params)
    stage = shard_staged_params(export_params(model), cfg, mesh)
    opt = torch.optim.SGD(stage.parameters(), lr=0.1)
    step = make_pipeline_train_step(stage, cfg, opt, mesh, M, "gpipe", instrument=False,
                                    sentinel=False)
    T = M + S - 1
    boundary_bytes = mb * cfg.ctx_size * cfg.dmodel * 4
    s = mesh.coords[1]
    lo, hi = 2 * M - 1, (2 * M if s in (0, S - 1) else 4 * M)
    return {
        "fn": step, "args": (tiny_tokens(M * mb, cfg),), "lowered": "train_step",
        "meta": {"num_stages": S, "num_microbatches": M, "ticks": T,
                 "boundary_bytes": boundary_bytes, "bubble_fraction": (S - 1) / T,
                 "differs_from_jax": {"collective-permute": ("count", "bytes"),
                                      "all-reduce": ("absent",)}},
        "expected": {
            "scalar_bytes": 64,
            "collective-permute": {"min_count": lo, "max_count": hi,
                                   "min_bytes": lo * boundary_bytes,
                                   "max_bytes": hi * boundary_bytes, "axes": [stage_axis]},
            "forbidden": ["all-to-all", "reduce-scatter", "all-gather", "all-reduce"],
        },
    }
