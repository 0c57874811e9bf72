"""Megatron tensor parallelism for the LLaMA blocks: the counterpart of the
JAX package's ``parallel/tp.py``.

Layout over the ``model`` axis of a ``data x model`` grid (the standard
column/row split):

- column slices (output dim): ``wq``, ``wk``, ``wv`` (whole heads per rank),
  ``w_gate``, ``w_up``;
- row slices (input dim): ``wo``, ``w_down``, whose partial products are
  summed over the axis;
- replicated: the norms;
- ``embed`` and ``unembed`` vocab-sharded with ``shard_vocab=True`` (index
  ``i`` holds vocab ids ``[i V/n, (i+1) V/n)``): each rank gathers its own
  rows and one sum assembles the activations (:func:`vocab_sharded_embed`);
  the head projects onto the rank's ``V/n`` logit columns, and the loss is
  assembled from one all-gather of the per-shard log-sum-exps and one sum of
  the picked target logit (:func:`vocab_sharded_lm_loss`), so the full ``[B,
  L, V]`` logits never exist on a rank.  Replicated otherwise.

:func:`~ddl25spring_tpu_torch.models.llama.block_forward` (``tp_axis=``) holds
the sharded arithmetic; this module slices the parameters and builds the
loss and the step.

Gradient convention.  The loss is replicated over the model group: every
rank computes the same value.  Each normed input enters the rank-local
products through ``copy_in``, whose backward sums the cotangent over the
axis, and each sum of partial products leaves through ``reduce_out``, whose
backward is the identity.  So a sliced leaf's gradient is this rank's slice
of the full gradient, and a replicated leaf (the norms; ``embed`` and
``unembed`` when not vocab-sharded) gets the full gradient, the same on every
rank of the group.  The gradients are averaged over the data group.

Switch-MoE blocks (``cfg.n_experts > 0``) shard their expert stacks over
the same model axis (:func:`make_tp_moe_fn`): the tokens are replicated
over it, so every rank computes the same global routing, capacity and
drops, runs its ``E/n`` experts and returns a partial output that the
block's ``reduce_out`` completes; the result is the serial
:func:`~ddl25spring_tpu_torch.parallel.ep.moe_ffn`, drops included.  The
router is replicated.  Its gradient has two paths: the aux loss, computed
the same on every rank (full share, not summed), and the combine tensor, of
which each rank uses only its experts' slice (summed: JAX sums the combine
tensor's cotangent over the axis; here the gates, the only part of it that
has a gradient, enter it through ``copy_in``, which sums ``[T, k]`` floats in
place of ``[T, E, C]``, the same gradient).  The tokens the local experts
take enter through ``copy_in`` too.  The loss adds ``cfg.moe_aux_weight *
aux``.

``describe()`` is not ported (ROADMAP A12).
"""

from __future__ import annotations

import numpy as np
import torch

from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
from ddl25spring_tpu_torch.parallel.bucketing import (
    default_bucket_bytes,
    flatten,
    plan_buckets,
)
from ddl25spring_tpu_torch.parallel import ep
from ddl25spring_tpu_torch.parallel.comm import Axis, all_gather, copy_in, reduce_out
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.parallel.dp import grad_leaves, group_guard, param_leaves, shard_rows
from ddl25spring_tpu_torch.utils.config import LlamaConfig

_COL = ("wq", "wk", "wv", "w_gate", "w_up")  # split the output (last) dim
_ROW = ("wo", "w_down")                      # split the input dim


def tp_param_specs(shard_vocab: bool = True, n_experts: int = 0) -> dict:
    """The dim each leaf of the reference pytree is split on over the model
    axis, or None where it is replicated (JAX ``tp_param_specs``,
    ``tp.py:63``).  Blocks are stacked ``[L, ...]``, so their weight dims
    shift right by one.  ``n_experts > 0`` swaps the dense FFN leaves for
    the ``moe`` subtree: the router replicated, the expert stacks ``[L, E,
    ...]`` split on E."""
    block = {"ln1": None, "ln2": None, **{k: 2 for k in _COL}, **{k: 1 for k in _ROW}}
    if n_experts > 0:
        for k in ep.EXPERT_KEYS:
            del block[k]
        block["moe"] = {"router": None, **{k: 1 for k in ep.EXPERT_KEYS}}
    return {"embed": 0 if shard_vocab else None, "blocks": block, "ln_f": None,
            "unembed": 1 if shard_vocab else None}


def _n_experts(params: dict) -> int:
    moe = params["blocks"].get("moe")
    return np.shape(moe["router"])[-1] if moe is not None else 0


def _split_dims(shard_vocab: bool, n_experts: int = 0) -> dict[str, int | None]:
    return dict(flatten(tp_param_specs(shard_vocab, n_experts)))


def shard_tp_params(params: dict, n: int, index: int, shard_vocab: bool = True) -> dict:
    """Index ``index``'s slice of the reference pytree (numpy leaves) over a
    model axis of ``n``: the JAX ``shard_tp_params`` (``tp.py:100``) for one
    rank, a MoE pytree's expert stacks included.  Every split dim must
    divide by ``n``."""
    dims = _split_dims(shard_vocab, _n_experts(params))

    def cut(path, leaf):
        leaf, dim = np.asarray(leaf), dims[path]
        if dim is None:
            return leaf.copy()
        if leaf.shape[dim] % n:
            raise ValueError(f"{path}: dim {dim} of {leaf.shape} does not split over {n}")
        size = leaf.shape[dim] // n
        return np.take(leaf, np.arange(index * size, (index + 1) * size), axis=dim)

    return _unflatten({path: cut(path, leaf) for path, leaf in flatten(params)})


def merge_tp_params(shards: list[dict], shard_vocab: bool = True) -> dict:
    """The full pytree from the slices of indices ``0..n-1``, in order (the
    inverse of :func:`shard_tp_params`; a replicated leaf is index 0's).  The
    slices may hold part of the tree, as a pipeline stage's do: the result
    holds the same keys, blocks stacked ``[L/S, ...]`` as the slices' are."""
    dims = _split_dims(shard_vocab, _n_experts(shards[0]))
    flat = [dict(flatten(s)) for s in shards]
    return _unflatten({path: (leaf.copy() if dims[path] is None
                              else np.concatenate([f[path] for f in flat], axis=dims[path]))
                       for path, leaf in flat[0].items()})


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *outer, last = path.split(".")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def load_tp_params(model: llama.Llama, local: dict) -> llama.Llama:
    """Give ``model``'s parameters this rank's slices (numpy leaves, from
    :func:`shard_tp_params`): each parameter takes the slice's shape.  Build
    the optimizer after."""
    return llama.load_jax_params(model, local, resize=True)


def _vocab_shard_ownership(tokens: torch.Tensor, Vl: int, axis: Axis):
    """``(t_local, mine)`` for vocab ids under the contiguous-shard convention
    (index ``i`` owns ``[i Vl, (i+1) Vl)``): the clamped local row and the
    ownership mask.  The embedding gather and the loss's target pick share it
    (JAX ``tp.py:119``)."""
    off = axis.index * Vl
    return (tokens - off).clamp(0, Vl - 1), (tokens >= off) & (tokens < off + Vl)


def vocab_sharded_embed(table_local: torch.Tensor, tokens: torch.Tensor, axis: Axis,
                        dtype: torch.dtype) -> torch.Tensor:
    """The embedding from a vocab-sharded ``[V/n, D]`` slice: each rank gathers
    its own rows (a foreign token hits a clamped row, zeroed by the ownership
    mask), and one sum over the axis (``reduce_out``) assembles ``[B, L, D]``.
    The sum's backward hands every rank the full cotangent, whose scatter
    touches only its own rows."""
    t_local, mine = _vocab_shard_ownership(tokens, table_local.shape[0], axis)
    return reduce_out(table_local.to(dtype)[t_local] * mine[..., None].to(dtype), axis)


def vocab_sharded_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, axis: Axis) -> torch.Tensor:
    """:func:`~ddl25spring_tpu_torch.ops.losses.causal_lm_loss` over a
    vocab-sharded logits slice ``[B, L, V/n]``: the log-partition from one
    all-gather of the per-shard log-sum-exps, the target logit from one sum
    of each rank's pick, both ``[B, L-1]``, whatever V.  Every rank returns
    the same loss."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    Vl = logits.shape[-1]
    logz = torch.logsumexp(all_gather(torch.logsumexp(logits, -1), axis), 0)
    t_local, mine = _vocab_shard_ownership(targets, Vl, axis)
    picked_l = logits.gather(-1, t_local[..., None])[..., 0]
    picked = reduce_out(torch.where(mine, picked_l, 0.0), axis)
    return (logz - picked).mean()


def make_tp_moe_fn(axis: Axis, capacity_factor: float = 1.25, top_k: int = 1):
    """The switch-MoE FFN under TP (JAX ``make_tp_moe_fn``, ``tp.py:170``):
    ``f(mp, x) -> (y_partial, aux)`` with ``mp`` this rank's slice (router
    whole, experts ``[i E/n, (i+1) E/n)`` of index ``i``) and ``x [T, D]`` the
    tokens, the same on every rank of ``axis``.  The routing, capacity ``T
    cf k / E`` and drops are global and computed on every rank; the rank
    takes its experts' slice of the dispatch and combine tensors, and its
    partial combine goes to :func:`~ddl25spring_tpu_torch.models.llama.
    block_forward`'s ``reduce_out``.  The gates (the combine tensor's
    differentiable part) and the tokens the experts take enter through
    ``copy_in``: see the module docstring."""
    def tp_moe(mp, x):
        T, _ = x.shape
        E = mp["router"].shape[1]
        E_local = mp["w_gate"].shape[0]
        C = ep.capacity(T, capacity_factor, top_k, E)
        disp, combine, aux, _ = ep._dispatch_tensors(
            ep.router_logits(mp["router"], x), C, top_k, gate_fn=lambda g: copy_in(g, axis))
        e0 = axis.index * E_local
        expert_in = ep.dispatch(disp[:, e0:e0 + E_local], copy_in(x, axis))
        return ep.combine_out(combine[:, e0:e0 + E_local], ep._expert_ffn(mp, expert_in)), aux

    return tp_moe


def make_tp_loss(cfg: LlamaConfig, mesh, model_axis: str = "model",
                 data_axis: str | None = None, shard_vocab: bool = True):
    """``loss(model, tokens) -> scalar`` with TP(xDP) blocks (JAX
    ``make_tp_loss``, ``tp.py:208``): ``model`` holds this rank's slices
    (:func:`load_tp_params`); the rank takes its replica's rows of the global
    batch (all of them when ``data_axis`` is None).  The loss is the same on
    every rank of the model group; a switch-MoE config's blocks run
    :func:`make_tp_moe_fn` and the loss adds ``cfg.moe_aux_weight`` times
    their aux, summed over the layers."""
    axis = mesh.axis(model_axis)
    if cfg.n_experts > 0 and cfg.n_experts % axis.size:
        raise ValueError(f"n_experts ({cfg.n_experts}) not divisible by "
                         f"{model_axis}={axis.size}")
    moe_fn = (make_tp_moe_fn(axis, cfg.capacity_factor, cfg.moe_top_k)
              if cfg.n_experts > 0 else None)
    rows = mesh.axis(data_axis) if data_axis is not None else None
    dtype = getattr(torch, cfg.dtype)

    def loss(model, tokens):
        if rows is not None:
            tokens = shard_rows(tokens, rows.index, rows.size, mesh.device)
        tokens = tokens.to(mesh.device)
        if shard_vocab:
            x = vocab_sharded_embed(model.embed, tokens, axis, dtype)
        else:
            x = llama.embed(model, tokens, cfg)
        x, aux = llama.apply_blocks(model.blocks, x, cfg, tp_axis=axis,
                                    moe_fn=moe_fn)
        if shard_vocab:
            loss = vocab_sharded_lm_loss(llama.unembed(model, x, cfg, tp_axis=axis), tokens,
                                         axis)
        else:
            loss = causal_lm_loss(llama.unembed(model, x, cfg), tokens)
        if cfg.n_experts > 0:
            loss = loss + cfg.moe_aux_weight * aux
        return loss

    return loss


def make_tp_train_step(model, cfg: LlamaConfig, optimizer: torch.optim.Optimizer, mesh,
                       model_axis: str = "model", data_axis: str | None = None,
                       shard_vocab: bool = True, sentinel: bool | None = None):
    """The TP(xDP) train step (JAX ``make_tp_train_step``, ``tp.py:237``):
    ``model`` holds this rank's slices and keeps them across steps.
    ``step(tokens)`` takes the global batch, averages the gradients over the
    data group (one all-reduce per bucket of ``DDL25_BUCKET_BYTES``, 4 MiB
    when unset, as :func:`~ddl25spring_tpu_torch.parallel.dp.
    make_dp_train_step`), steps ``optimizer`` and returns the loss, the same
    on every rank.

    JAX's ``donate`` has no counterpart (the optimizer updates the
    parameters in place).  ``sentinel``: the in-step numerics sentinels,
    strategy ``"tp"``, their facts summed over the model axis (and the data
    axis when given): a sliced leaf's squared norm counts whole on each
    member, a replicated one ``1 / T``, so the sum is the global norm;
    recorded by the first rank."""
    s_on, s_policy = sentinels.resolve(sentinel)
    loss_fn = make_tp_loss(cfg, mesh, model_axis, data_axis, shard_vocab)
    data = mesh.axis(data_axis) if data_axis is not None else None
    bb = default_bucket_bytes()
    leaves = param_leaves(model)
    plan = plan_buckets(leaves, bb) if bb else None
    comm = mesh.comm
    guard = None
    if s_on:
        T = mesh.axis(model_axis).size
        ax = mesh.axis(("data", model_axis) if data is not None else model_axis)
        split = _split_dims(shard_vocab, cfg.n_experts)
        named = sentinels.named_leaves(model)
        guard = group_guard("tp", s_on, s_policy, named, optimizer, ax,
                            weights={p: (1.0 if split[".".join(p)] is not None else 1.0 / T)
                                     * T / ax.size for p, _ in named},
                            loss_weight=1.0 / ax.size)

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        loss = loss.detach().clone()
        if data is not None:
            comm.bucketed_all_reduce_mean_(grad_leaves(leaves), data.group, plan)
            comm.all_reduce_mean_([loss], data.group)
        if guard is not None:
            guard.begin()
        optimizer.step()
        if guard is not None:
            guard.end(loss)
        return loss

    step.guard = guard
    return step
