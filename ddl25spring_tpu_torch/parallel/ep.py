"""Expert parallelism: a switch-style MoE FFN over an ``expert`` axis, the
counterpart of the JAX package's ``parallel/ep.py``.

The same formulation as the reference:

- top-1 (switch) or top-k (Mixtral-style) routing with a capacity-bucketed
  dense dispatch: the token -> expert assignment becomes one-hot ``[T, E,
  C]`` dispatch and combine tensors, so dispatch, the experts and the
  combine are products of fixed shapes (here cuBLAS GEMMs, where the JAX
  package leaves them to XLA).  In bf16 the dispatch product is exact: each
  output is one input element or 0;
- tokens over capacity are dropped (their residual passes through); top-k
  fills the buckets choice-major, so second choices drop first;
- the experts are bias-free SwiGLU blocks stacked ``[E, ...]``;
- the switch load-balancing loss (``E * sum_e fraction_e * mean_prob_e``,
  on the first choices before any drop) comes out beside the output.

:func:`moe_ffn` is the single-process layer.  :func:`make_ep_moe_fn` is the
expert-parallel one over a ``data x expert`` rank grid
(:func:`~ddl25spring_tpu_torch.utils.mesh.init_mesh` with ``expert=``): a
rank holds ``E/ep`` experts (:func:`shard_moe_params`) and dispatches its
own token shard; two all-to-alls over the expert axis carry the buckets to
the ranks of their experts and back (:func:`ep_moe_local`).  With ample
capacity it equals :func:`moe_ffn`; under overflow it equals
:func:`moe_ffn` applied to each shard's token group.

The router logits are float32 (``x.float() @ router``) whatever the compute
dtype, with TF32 off for that product on the card whatever the global flag
says: a routing decision must not depend on it.

Gradient convention of :func:`make_ep_moe_fn` (the port's TP convention,
where a replicated leaf gets its full gradient, the same on every rank that
holds it): the JAX transposes sum the router's gradient over every rank that
holds other tokens (the expert axis, and the data axis on the 2-D grid) and
an expert stack's over the data axis.  Here the router and the tokens enter
the layer through ``copy_in`` over the token ranks and the expert stacks
through ``copy_in`` over the data axis, whose backwards make those sums; an
expert stack's gradient already holds every token of its expert group (the
all-to-all's backward brings them).

:func:`describe` is the registry hook of ``ep``
(:mod:`~ddl25spring_tpu_torch.obs.comm_analytics`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.parallel.comm import (
    Axis,
    all_gather,
    all_to_all,
    copy_in,
    reduce_out,
)
from ddl25spring_tpu_torch.utils.device import backend_flags

MOE_KEYS = ("router", "w_gate", "w_up", "w_down")
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


class MoeParams(nn.Module):
    """Router ``[D, E]`` and the stacked bias-free SwiGLU experts (``w_gate``,
    ``w_up [E, D, F]``, ``w_down [E, F, D]``).  ``p[key]`` reads a parameter,
    so the functions below take this module or a plain dict of tensors."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate = nn.Parameter(router), nn.Parameter(w_gate)
        self.w_up, self.w_down = nn.Parameter(w_up), nn.Parameter(w_down)

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)


def init_moe_params(generator: torch.Generator, dmodel: int, ffn_dim: int, n_experts: int,
                    device="cpu") -> MoeParams:
    """``normal(0, 0.02)`` draws from ``generator`` (on the CPU, then moved:
    the same seed gives the same weights on every device), in the order
    router, ``w_gate``, ``w_up``, ``w_down`` (JAX ``init_moe_params``,
    ``ep.py:43``; bias-free, so a zero capacity-padding row maps to zero)."""
    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator, dtype=torch.float32)).to(device)

    return MoeParams(dense(dmodel, n_experts), dense(n_experts, dmodel, ffn_dim),
                     dense(n_experts, dmodel, ffn_dim), dense(n_experts, ffn_dim, dmodel))


def capacity(tokens: int, capacity_factor: float, top_k: int, n_experts: int) -> int:
    """Bucket slots per expert, ``max(1, int(T cf k / E))``: the JAX
    expression, float truncation included."""
    return max(1, int(tokens * capacity_factor * top_k / n_experts))


def router_logits(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x.float() @ router``, float32 in full precision (TF32 off)."""
    with backend_flags(matmul_tf32=False):
        return x.float() @ router.float()


def _expert_ffn(p, x: torch.Tensor) -> torch.Tensor:
    """Every expert on its buckets, ``x [E, C, D] -> [E, C, D]``: one batched
    product per matmul over the expert dim."""
    dtype = x.dtype
    gate = F.silu(torch.bmm(x, p["w_gate"].to(dtype)))
    up = torch.bmm(x, p["w_up"].to(dtype))
    return torch.bmm(gate * up, p["w_down"].to(dtype))


def _slots(pos: torch.Tensor, capacity: int) -> torch.Tensor:
    """One-hot ``[N, C]`` of each row's bucket slot ``pos`` (``jax.nn.one_hot``:
    all zeros where ``pos >= C``)."""
    return (pos[:, None] == torch.arange(capacity, device=pos.device)).float()


def _dispatch_tensors(router_logits: torch.Tensor, capacity: int, top_k: int = 1,
                      gate_fn=None):
    """``(disp [T, E, C], combine [T, E, C], aux, kept [E])`` from float32
    router logits (JAX ``_dispatch_tensors``, ``ep.py:73``): the one-hot
    dispatch mask, the gate-weighted combine tensor, the switch aux loss on
    the first choices before any drop, and the kept slots per expert.

    ``top_k == 1``: the gate is the winning softmax prob, ``argmax`` takes the
    first maximum as ``jnp.argmax`` does.  ``top_k > 1``: the k highest
    probs (``torch.topk``, which on a tie may order otherwise than
    ``lax.top_k``), their gates renormalized over the k, the bucket slots
    filled choice-major: every first choice before any second.

    ``gate_fn`` maps the gates before they weight the combine tensor (the
    only path by which the combine tensor's gradient reaches the router):
    TP-MoE passes ``copy_in``, whose backward sums that gradient over the
    model axis at ``[T, k]`` floats rather than ``[T, E, C]``."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    if top_k == 1:
        expert = probs.argmax(-1)
        gate = probs.gather(-1, expert[:, None])[:, 0]
        if gate_fn is not None:
            gate = gate_fn(gate)
        onehot = F.one_hot(expert, E).float()                    # [T, E]
        pos = (onehot.cumsum(0) - 1.0) * onehot                   # arrival order
        keep = onehot * (pos < capacity)
        disp = keep[:, :, None] * _slots(pos.sum(-1).long(), capacity)[:, None, :]
        combine = disp * gate[:, None, None]
        first_choice = onehot
        kept = keep.sum(0)
    else:
        gates, experts = torch.topk(probs, top_k, dim=-1)         # [T, k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        if gate_fn is not None:
            gates = gate_fn(gates)
        onehots = F.one_hot(experts, E).float()                   # [T, k, E]
        oh_flat = onehots.transpose(0, 1).reshape(top_k * T, E)   # choice-major
        pos = (oh_flat.cumsum(0) - 1.0) * oh_flat
        keep = oh_flat * (pos < capacity)
        disp_flat = keep[:, :, None] * _slots(pos.sum(-1).long(), capacity)[:, None, :]
        disp_k = disp_flat.reshape(top_k, T, E, capacity)
        # the k experts of a token differ, so the sums never collide slots
        disp = disp_k.sum(0)
        combine = (disp_k * gates.t()[:, :, None, None]).sum(0)
        first_choice = onehots[:, 0]
        kept = keep.reshape(top_k, T, E).sum((0, 1))
    # the ASSIGNED first-choice fraction: kept saturates at C under overflow
    frac = first_choice.sum(0) / first_choice.sum().clamp_min(1.0)
    aux = E * (frac * probs.mean(0)).sum()
    return disp, combine, aux, kept


def dispatch(disp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("tec,td->ecd")``: the buckets ``[E, C, D]`` in ``x``'s dtype."""
    T, E, C = disp.shape
    return (disp.to(x.dtype).reshape(T, E * C).t() @ x).reshape(E, C, x.shape[-1])


def combine_out(combine: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """``einsum("tec,ecd->td")``: the gate-weighted sum of each token's slots."""
    T, E, C = combine.shape
    return combine.to(expert_out.dtype).reshape(T, E * C) @ expert_out.reshape(E * C, -1)


def moe_ffn(p, x: torch.Tensor, capacity_factor: float = 1.25, return_stats: bool = False,
            top_k: int = 1):
    """The single-process MoE layer, ``x [T, D] -> (y [T, D], aux)`` (JAX
    ``moe_ffn``, ``ep.py:135``).  ``return_stats=True`` appends ``{"kept": [E],
    "assigned": T * top_k}``, both counted in slots."""
    T, _ = x.shape
    E = p["router"].shape[1]
    C = capacity(T, capacity_factor, top_k, E)
    disp, combine, aux, kept = _dispatch_tensors(router_logits(p["router"], x), C, top_k)
    y = combine_out(combine, _expert_ffn(p, dispatch(disp, x)))
    if return_stats:
        return y, aux, {"kept": kept, "assigned": float(T * top_k)}
    return y, aux


def ep_moe_local(p, x: torch.Tensor, axis: Axis, capacity_factor: float = 1.25,
                 return_stats: bool = False, top_k: int = 1):
    """The expert-parallel layer on one rank (JAX ``ep_moe_local``,
    ``ep.py:159``): ``x [T_local, D]`` is this rank's token shard, ``p`` holds
    the replicated router and this rank's ``[E/ep, ...]`` expert stacks
    (index ``i`` of ``axis`` holds experts ``[i E/ep, (i+1) E/ep)``).  The
    rank dispatches its tokens to all ``E`` experts at capacity ``T_local cf
    k / E``; one all-to-all over ``axis`` hands the buckets of expert group
    ``g`` to index ``g`` (received ``[ep, E/ep, C, D]``, dim 0 the source:
    ``lax.all_to_all(..., 0, 0, tiled=False)`` on a leading dim of ``ep``),
    the local experts run on ``ep C`` rows each, and the inverse all-to-all
    brings the outputs back.  Returns ``(y, aux)``, ``aux`` this shard's
    alone, and the local kept counts with ``return_stats``."""
    T_local, D = x.shape
    E = p["router"].shape[1]
    ep = axis.size
    E_local = E // ep
    C = capacity(T_local, capacity_factor, top_k, E)
    disp, combine, aux, kept = _dispatch_tensors(router_logits(p["router"], x), C, top_k)
    expert_in = dispatch(disp, x)
    got = all_to_all(expert_in.reshape(ep, E_local, C, D), axis, 0, 0)  # dim 0: source
    mine = got.transpose(0, 1).reshape(E_local, ep * C, D)
    out = _expert_ffn(p, mine)
    back = all_to_all(out.reshape(E_local, ep, C, D).transpose(0, 1), axis, 0, 0)
    y = combine_out(combine, back.reshape(E, C, D))
    if return_stats:
        return y, aux, kept
    return y, aux


def _token_axis(mesh, axis: str = "expert", data_axis: str | None = None) -> Axis:
    """The ranks the tokens shard over: ``axis``, or with ``data_axis`` the
    whole ``data x expert`` grid, index ``d * ep + e`` (the order of the JAX
    token spec ``P((data, expert))``), whose group is the world's."""
    if data_axis is None:
        return mesh.axis(axis)
    mesh.axis(data_axis)  # the grid must have it
    world = mesh.grid.world
    return Axis(f"{data_axis},{axis}", mesh.comm, None, tuple(range(world)), mesh.rank)


def make_ep_moe_fn(mesh, axis: str = "expert", capacity_factor: float = 1.25,
                   return_stats: bool = False, data_axis: str | None = None, top_k: int = 1):
    """The EP layer over ``mesh``'s ``axis`` (JAX ``make_ep_moe_fn``,
    ``ep.py:215``): ``f(p, x) -> (y, aux)`` with ``p`` this rank's slice
    (:func:`shard_moe_params`) and ``x [T, D]`` the global tokens, the same
    on every rank, as the JAX function takes them.  Token shard ``i`` of
    :func:`_token_axis` (``T/n`` contiguous rows; ``n = ep``, or ``D ep`` with
    ``data_axis``, where each data row is an expert group of its own) goes
    through :func:`ep_moe_local`; the shards' outputs are gathered into the
    global ``y``, and ``aux`` is the mean of the shards' losses (the JAX
    ``pmean``), the same on every rank.  ``return_stats=True`` appends
    ``{"kept": [E] summed over the shards, "assigned": T * top_k}``.

    Differentiable, with every rank's gradients full (see the module
    docstring): the gather's backward hands each rank its own rows'
    cotangent, the mean's backward ``1/n`` to every shard's aux, and the
    ``copy_in`` of the router and the tokens (over the token ranks) and of
    the expert stacks (over ``data_axis``) sum the shares."""
    ep_axis = mesh.axis(axis)
    toks = _token_axis(mesh, axis, data_axis)
    data = mesh.axis(data_axis) if data_axis is not None else None
    n = toks.size

    def f(p, x):
        T = x.shape[0]
        if T % n:
            raise ValueError(f"{T} tokens do not split over {n} shards")
        Tl = T // n
        lp = {"router": copy_in(p["router"], toks),
              **{k: p[k] if data is None else copy_in(p[k], data) for k in EXPERT_KEYS}}
        x_local = copy_in(x, toks)[toks.index * Tl:(toks.index + 1) * Tl]
        res = ep_moe_local(lp, x_local, ep_axis, capacity_factor, return_stats, top_k)
        y = all_gather(res[0], toks).reshape(T, -1)
        aux = reduce_out(res[1], toks) / n
        if return_stats:
            kept = res[2].detach().clone()
            if n > 1:
                toks.comm.all_reduce_sum_([kept], toks.group)
            return y, aux, {"kept": kept, "assigned": float(T * top_k)}
        return y, aux

    return f


def shard_moe_params(p, n: int, index: int, device=None) -> MoeParams:
    """Index ``index``'s slice over an expert axis of ``n`` (JAX
    ``shard_moe_params``, ``ep.py:307``, for one rank): the router whole,
    experts ``[index E/n, (index+1) E/n)`` of each stack.  ``p`` is a dict
    or :class:`MoeParams` of tensors or numpy arrays; the slice is a new
    :class:`MoeParams` of copies."""
    def t(v):
        v = torch.as_tensor(v, dtype=torch.float32)
        return v.to(device) if device is not None else v

    E = p["router"].shape[1]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks")
    El = E // n
    return MoeParams(t(p["router"]).detach().clone(),
                     *(t(p[k])[index * El:(index + 1) * El].detach().clone()
                       for k in EXPERT_KEYS))


def make_ep_train_step(p: MoeParams, optimizer: torch.optim.Optimizer, mesh,
                       axis: str = "expert", capacity_factor: float = 1.25,
                       sentinel: bool | None = None):
    """The train step of the standalone EP layer (JAX ``make_ep_train_step``,
    ``ep.py:318``): regression of the layer's output onto a target plus the
    aux loss.  ``p`` holds this rank's slice (:func:`shard_moe_params`);
    ``step((x, y))`` takes the global ``x``, ``y [T, D]``, steps
    ``optimizer`` and returns the loss, the same on every rank (the layer's
    ``copy_in`` has summed the router's gradient over the expert axis).

    JAX's ``donate`` has no counterpart (the optimizer updates in place).
    ``sentinel``: the in-step numerics sentinels, strategy ``"ep"``, their
    facts summed over ``axis``: the expert stacks' squared norms count whole
    on each rank (each holds its own experts), the router's and the loss
    ``1 / n``; recorded by the axis' index 0."""
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.parallel.dp import group_guard

    s_on, s_policy = sentinels.resolve(sentinel)
    moe = make_ep_moe_fn(mesh, axis, capacity_factor)
    guard = None
    if s_on:
        ax = mesh.axis(axis)
        guard = group_guard("ep", s_on, s_policy, [((k,), p[k]) for k in MOE_KEYS], optimizer,
                            ax, weights={("router",): 1.0 / ax.size}, loss_weight=1.0 / ax.size)

    def step(batch):
        x, y = (t.to(mesh.device) for t in batch)
        optimizer.zero_grad(set_to_none=True)
        out, aux = moe(p, x)
        loss = ((out - y) ** 2).mean() + aux
        loss.backward()
        if guard is None:
            optimizer.step()
            return loss.detach()
        guard.begin()
        optimizer.step()
        loss = loss.detach()
        guard.end(loss)
        return loss

    step.guard = guard
    return step


def describe(mesh, axis: str = "expert", params: dict | None = None):
    """The ``describe()`` of ``ep`` (JAX ``parallel/ep.py:356``): one step of the
    expert-parallel MoE layer (``E`` = the axis size, one expert a rank,
    ``D = 16``, ``F = 32``, ``16 E`` tokens), its inputs and its collective
    signature, for :mod:`~ddl25spring_tpu_torch.obs.comm_analytics`.
    ``params`` is JAX's ``init_moe_params`` pytree in numpy, else seeded.

    Signature, from what :func:`make_ep_moe_fn` issues, all over the expert
    axis: the dispatch and the combine all-to-all forward and the combine's
    inverse backward (3, each of the ``[E, C, D]`` buckets: the tokens need
    no gradient, so autograd never reaches the dispatch's inverse); the
    all-gather of the shards' outputs (``[T, D]`` in all); the all-reduce of
    the aux's mean forward and of the router's ``copy_in`` cotangent
    backward (4 B and ``[D, E]``); no permute, no reduce-scatter.

    Where JAX's compiled inventory differs (``meta["differs_from_jax"]``):

    - all-gather, present in the port only: the port's layer takes the
      global tokens and gathers every shard's output, where JAX's
      ``shard_map`` leaves the outputs sharded in place;
    - all-reduce, count and bytes: XLA fuses the router's gradient with two
      4-byte scalars (1 op of 264 B); the port sums the router's gradient and
      the aux (2 ops, 260 B).
    The all-to-alls equal JAX's: 3 of 3,840 B in all at ``E = 4``."""
    import numpy as np


    ax = mesh.axis(axis)
    E, D, F_, T = ax.size, 16, 32, 16 * ax.size
    full = params if params is not None else \
        init_moe_params(torch.Generator().manual_seed(0), D, F_, E)
    p = shard_moe_params(full, E, ax.index, device=mesh.device)
    opt = torch.optim.SGD(p.parameters(), lr=0.1)
    step = make_ep_train_step(p, opt, mesh, axis, sentinel=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    C = capacity(T // E, 1.25, 1, E)
    bucket_bytes = E * C * D * 4
    router_bytes = D * E * 4
    tokens_bytes = T * D * 4
    return {
        "fn": step, "args": ((x, y),), "lowered": "train_step",
        "meta": {"n_experts": E, "tokens": T, "dmodel": D, "router_bytes": router_bytes,
                 "capacity": C,
                 "differs_from_jax": {"all-gather": ("absent",),
                                      "all-reduce": ("count", "bytes")}},
        "expected": {
            "scalar_bytes": 64,
            "all-to-all": {"count": 3, "min_bytes": 3 * bucket_bytes,
                           "max_bytes": 3 * bucket_bytes, "axes": [axis]},
            "all-gather": {"count": 1, "min_bytes": tokens_bytes, "max_bytes": tokens_bytes,
                           "axes": [axis]},
            "all-reduce": {"count": 2, "min_bytes": router_bytes + 4,
                           "max_bytes": router_bytes + 4, "axes": [axis]},
            "forbidden": ["collective-permute", "reduce-scatter"],
        },
    }
