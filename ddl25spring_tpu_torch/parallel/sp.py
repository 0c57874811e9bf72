"""Sequence parallelism over a ``seq`` axis: the counterpart of the JAX
package's ``parallel/sp.py`` (ring attention and Ulysses).

Tokens shard over the ``seq`` axis of a ``data x seq`` grid
(:func:`~ddl25spring_tpu_torch.utils.mesh.init_mesh`): index ``s`` of ``n``
holds the positions ``[s Ll, (s+1) Ll)`` of its replica's rows, ``Ll = L /
n``, and the activations of a rank never hold the full length outside
attention.  Three attentions join the shards:

- :func:`ring_attention`, the dense ring: the local queries meet every KV
  block in turn, masked per (query, key) pair by global positions that
  travel with the block, in a float32 online softmax;
- :func:`ring_flash_attention`, the ring over the flash kernels: the own
  block causal (:func:`~ddl25spring_tpu_torch.ops.flash_attention.
  flash_attention_with_lse`), each received block non-causal with Lq == Lk,
  merged by log-sum-exp.  Its backward feeds the kernels a nonzero lse
  cotangent;
- :func:`ulysses_attention`: one all-to-all turns the sequence shards into
  head shards of the full length, causal flash attention runs over ``H/n``
  heads, and the inverse all-to-all restores the sequence shards.

The KV blocks of a ring come from :func:`~ddl25spring_tpu_torch.parallel.
comm.ring_pass`: after ``t`` hops index ``s`` holds the block of index ``(s -
t) % n``.  The causal loss needs one more hop, of one token per row
(:func:`sp_shifted_targets`).

Gradient convention.  Parameters are replicated over the seq axis, and
every rank holds a different share of the loss: its own positions' cross-
entropy summed, over the global count of predicted positions, so the shares
of a replica sum to its loss (:func:`sp_causal_lm_loss`).  Each rank
backprops its share; the gradients are then summed over the seq group and
averaged over the data group (:func:`make_sp_train_step`).  The loss it
returns is the global one, the same on every rank.

Switch-MoE configs: each rank's blocks dispatch its own ``[B Ll, D]``
token group (:func:`~ddl25spring_tpu_torch.parallel.ep.moe_ffn`), and the
loss adds ``cfg.moe_aux_weight`` times the mean over the seq shards of
their aux losses (the JAX ``pmean``, the standard sharded-MoE estimator, not
bitwise the unsharded aux under overflow): a rank's share carries ``w
aux_local / n``, so that the shares sum to it.

On the CPU ``flash_attention_with_lse`` runs the kernels' plain versions, so
the flash ring runs there as it does on the card; the JAX package's dense
stand-in for it (``_dense_attention_with_lse``) has no counterpart here.

``describe()`` (the XLA compile-report hook) is not ported (ROADMAP A12).
"""

from __future__ import annotations

import math

import torch

from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
)
from ddl25spring_tpu_torch.parallel.bucketing import default_bucket_bytes, plan_buckets
from ddl25spring_tpu_torch.parallel.comm import Axis, all_to_all, ring_pass
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.parallel.dp import grad_leaves, group_guard, param_leaves, shard_rows
from ddl25spring_tpu_torch.utils.config import LlamaConfig

MODES = ("ring", "ulysses")


def ring_attention(q, k, v, axis: Axis, q_pos, kv_pos, dtype):
    """Causal ring attention (JAX ``ring_attention``, ``sp.py:53``).
    ``q/k/v``: ``[B, Ll, H, hd]`` local shards; ``q_pos``/``kv_pos``: ``[Ll]``
    global positions of the local queries and of the local KV block (which
    travel with it).  Returns ``[B, Ll, H, hd]`` in ``dtype``."""
    B, Ll, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float()
    ks, vs, ps = ring_pass(axis, k, v, kv_pos)
    m = torch.full((B, H, Ll), -math.inf, device=q.device)
    l = torch.zeros((B, H, Ll), device=q.device)
    o = torch.zeros((B, H, Ll, hd), device=q.device)
    for t in range(axis.size):
        s = torch.einsum("blhd,bmhd->bhlm", q32, ks[t].float()) * scale
        s = s.masked_fill(~(q_pos[:, None] >= ps[t][None, :]), -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # where a row has seen nothing yet, m is -inf: make the correction
        # factor 0, and keep masked scores at exp(-inf) = 0, not nan
        corr = torch.where(m == -math.inf, 0.0, torch.exp(m - m_new))
        p = torch.exp(torch.where(s == -math.inf, -math.inf, s - m_new[..., None]))
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhlm,bmhd->bhld", p, vs[t].float())
        m = m_new
    # every causal row has at least its own diagonal, so l > 0
    return (o / l[..., None]).transpose(1, 2).to(dtype)


def ring_flash_attention(q, k, v, axis: Axis, dtype):
    """Ring attention with a flash local step (JAX ``ring_flash_attention``,
    ``sp.py:128``).  Needs what :func:`make_sp_loss` guarantees: index ``s``
    holds the positions ``[s Ll, (s+1) Ll)``.  Hop 0 is the own block,
    causal; at hop ``t > 0`` index ``s`` holds the block of index ``s - t (mod
    n)``, fully visible when ``s >= t`` and fully masked otherwise.  Each
    visible block's ``(o_t, lse_t)`` folds into the accumulator by
    log-sum-exp: ``o <- (o e^(lse - m) + o_t e^(lse_t - m)) / (e^(lse - m) +
    e^(lse_t - m))``.

    A masked block is skipped: JAX merges it with ``lse_t = -inf``, weight
    exactly 0, which leaves ``o`` and ``lse`` as they were, so the result is
    the same.  It is still passed on along the ring.  So index ``s`` launches
    each flash kernel ``1 + s`` times per call (once forward, once each of dq
    and dk/dv backward): ``(1 + s) * n_layers`` per step.

    Hop 0 takes its block from slot 0 of the ring pass, not from ``k``/``v``
    themselves, so every rank uses the pass's output and so runs its
    backward (index 0 uses no received block)."""
    s = axis.index
    ks, vs = ring_pass(axis, k, v)
    o_acc, lse_acc = flash_attention_with_lse(q, ks[0], vs[0], causal=True)
    o_acc = o_acc.float()
    for t in range(1, s + 1):
        o_t, lse_t = flash_attention_with_lse(q, ks[t], vs[t], causal=False)
        m = torch.maximum(lse_acc, lse_t)
        a, b = torch.exp(lse_acc - m), torch.exp(lse_t - m)
        denom = a + b
        aw = (a / denom).transpose(1, 2)[..., None]  # [B, Ll, H, 1]
        bw = (b / denom).transpose(1, 2)[..., None]
        o_acc = o_acc * aw + o_t.float() * bw
        lse_acc = m + torch.log(denom)
    return o_acc.to(dtype)


def ulysses_attention(q, k, v, axis: Axis, dtype, use_flash: bool = True):
    """All-to-all sequence parallelism (JAX ``ulysses_attention``,
    ``sp.py:196``).  ``q/k/v``: ``[B, Ll, H, hd]`` sequence shards, RoPE
    already at global positions.  One all-to-all of the stacked q/k/v turns
    them into ``[B, n Ll, H/n, hd]`` head shards (index ``s``'s positions come
    ``s``-th, the :func:`make_sp_loss` layout), full-length causal attention
    runs on them (flash when ``use_flash``, else dense), and the inverse
    all-to-all restores ``[B, Ll, H, hd]``."""
    n, H = axis.size, q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs heads divisible by the seq axis: H={H}, n={n}")
    qkv = all_to_all(torch.stack((q, k, v)), axis, split=3, concat=2)
    qg, kg, vg = qkv.unbind(0)
    o = flash_attention(qg, kg, vg) if use_flash else llama.causal_attention(qg, kg, vg, dtype)
    return all_to_all(o.to(dtype), axis, split=1, concat=2)


def sp_shifted_targets(tokens: torch.Tensor, axis: Axis):
    """``(targets, valid)`` of a shard's ``tokens [B, Ll]``: the target of its
    last position is the next index's first token, fetched by one hop of one
    token per row; the last index's last position has none (``valid`` 0), as
    the serial loss predicts ``L - 1`` positions."""
    n, Ll = axis.size, tokens.shape[-1]
    nxt, = axis.shift([tokens[..., :1].contiguous()], step=-1)
    targets = torch.cat([tokens[..., 1:], nxt], dim=-1)
    valid = torch.ones(Ll, device=tokens.device)
    if axis.index == n - 1:
        valid[-1] = 0.0
    return targets, valid


def sp_local_ce_sum(logits, targets, valid) -> torch.Tensor:
    """A shard's cross-entropy summed over its valid positions (``logits [B,
    Ll, V]``, ``targets [B, Ll]``, ``valid [Ll]``), in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(picked * valid[None, :]).sum()


def sp_causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This index's share of the replica's causal-LM loss over sequence-
    sharded ``logits [B, Ll, V]`` / ``tokens [B, Ll]``: its cross-entropy sum
    over the global count ``B (n Ll - 1)`` of predicted positions.  The
    shares sum over the seq axis to the mean the JAX ``sp_causal_lm_loss``
    returns (there one ``psum`` pair)."""
    B, Ll = tokens.shape
    targets, valid = sp_shifted_targets(tokens, axis)
    return sp_local_ce_sum(logits, targets, valid) / (B * (axis.size * Ll - 1))


def make_sp_attn_fn(cfg: LlamaConfig, axis: Axis, mode: str, pos: torch.Tensor):
    """The attention a sequence-sharded forward gives
    :func:`~ddl25spring_tpu_torch.models.llama.block_forward`: Ulysses, or the
    ring (the flash ring when ``cfg.use_flash``, else the dense ring, which
    masks by ``pos``, the shard's global positions)."""
    if mode == "ulysses":
        def attn(q, k, v, dtype):
            return ulysses_attention(q, k, v, axis, dtype, use_flash=cfg.use_flash)
    elif cfg.use_flash:
        def attn(q, k, v, dtype):
            return ring_flash_attention(q, k, v, axis, dtype)
    else:
        def attn(q, k, v, dtype):
            return ring_attention(q, k, v, axis, pos, pos, dtype)
    return attn


def make_sp_loss(cfg: LlamaConfig, mesh, seq_axis: str = "seq", data_axis: str | None = None,
                 mode: str = "ring"):
    """``loss(model, tokens) -> this rank's share`` (:func:`sp_causal_lm_loss`)
    of the full LLaMA forward over the global batch ``tokens [B, L]``: the rank
    takes its replica's rows (all of them when ``data_axis`` is None) and its
    index's positions, and every block attends through ``mode``, ``"ring"``
    or ``"ulysses"`` (which needs ``num_heads % n == 0``).  The shares of a
    replica sum to :func:`~ddl25spring_tpu_torch.models.llama.llama_forward` +
    causal-LM loss on the unsharded model; with ``cfg.n_experts > 0``, plus
    ``cfg.moe_aux_weight`` times the shards' mean aux (see the module
    docstring)."""
    axis = mesh.axis(seq_axis)
    n = axis.size
    if mode not in MODES:
        raise ValueError(f"unknown SP mode {mode!r}")
    if mode == "ulysses" and cfg.num_heads % n:
        raise ValueError(f"ulysses SP needs num_heads ({cfg.num_heads}) divisible by the "
                         f"{seq_axis!r} axis size ({n})")
    rows = mesh.axis(data_axis) if data_axis is not None else None

    def loss(model, tokens):
        if rows is not None:
            tokens = shard_rows(tokens, rows.index, rows.size, mesh.device)
        L = tokens.shape[1]
        if L % n:
            raise ValueError(f"sequence length {L} does not split over {n} seq shards")
        Ll = L // n
        mine = tokens[:, axis.index * Ll:(axis.index + 1) * Ll].to(mesh.device)
        pos = axis.index * Ll + torch.arange(Ll, device=mesh.device)
        logits, aux = llama.llama_forward_with_aux(
            model, mine, cfg, pos=pos, attn_fn=make_sp_attn_fn(cfg, axis, mode, pos))
        share = sp_causal_lm_loss(logits, mine, axis)
        if cfg.n_experts > 0:
            share = share + cfg.moe_aux_weight * aux / n
        return share

    return loss


def make_sp_train_step(model, cfg: LlamaConfig, optimizer: torch.optim.Optimizer, mesh,
                       seq_axis: str = "seq", data_axis: str | None = None,
                       mode: str = "ring", sentinel: bool | None = None):
    """The SP(xDP) train step (JAX ``make_sp_train_step``, ``sp.py:375``):
    parameters replicated, tokens sequence-sharded (and row-sharded over
    ``data_axis``).  ``step(tokens)`` takes the global batch, steps
    ``optimizer`` and returns the global loss, the same on every rank.

    Each rank backprops ``n`` times its share, and the gradients and the
    scaled shares are averaged over every rank that holds other data (the
    whole grid with ``data_axis``, else the seq group), one all-reduce per
    bucket of ``DDL25_BUCKET_BYTES`` (4 MiB when unset) as in
    :func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step`: the mean
    over ``D n`` ranks of ``n`` times the shares' gradients is their sum
    over the seq group averaged over the data group.

    JAX's ``donate`` has no counterpart (the optimizer updates the
    parameters in place).  ``sentinel``: the in-step numerics sentinels,
    strategy ``"sp"``, their facts summed over the ranks that average the
    gradients (every rank holds the whole, averaged gradients, so each
    counts ``1 / size``), recorded by the first."""
    s_on, s_policy = sentinels.resolve(sentinel)
    loss_fn = make_sp_loss(cfg, mesh, seq_axis, data_axis, mode)
    n = mesh.axis(seq_axis).size
    group = None if data_axis is not None else mesh.axis(seq_axis).group
    bb = default_bucket_bytes()
    leaves = param_leaves(model)
    plan = plan_buckets(leaves, bb) if bb else None
    comm = mesh.comm
    guard = None
    if s_on:
        ax = mesh.axis(("data", seq_axis) if data_axis is not None else seq_axis)
        named = sentinels.named_leaves(model)
        guard = group_guard("sp", s_on, s_policy, named, optimizer, ax,
                            weights={p: 1.0 / ax.size for p, _ in named},
                            loss_weight=1.0 / ax.size)

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        scaled = n * loss_fn(model, tokens)
        scaled.backward()
        comm.bucketed_all_reduce_mean_(grad_leaves(leaves), group, plan)
        if guard is not None:
            guard.begin()
        optimizer.step()
        loss = scaled.detach().clone()
        comm.all_reduce_mean_([loss], group)
        if guard is not None:
            guard.end(loss)
        return loss

    step.guard = guard
    return step
