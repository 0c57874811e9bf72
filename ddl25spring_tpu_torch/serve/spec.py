"""Speculative decoding: an early-exit drafter and a verify pass over the
paged KV cache, the counterpart of the JAX package's ``serve/spec.py``.

Decode is memory-bound: every generated token streams the whole model's
weights for one token of work.  A cheap drafter proposes ``k`` tokens and
the target scores all of them in one verify program; greedy acceptance (a
draft is kept iff it equals the target's argmax, the first rejection is
replaced by that argmax, a full accept earns a bonus token) makes the
emitted stream exactly the target's own.  The engine
(:mod:`~ddl25spring_tpu_torch.serve.engine`) runs the round;
``serve/driver.py``'s ``spec_ab_compare`` prices it on the virtual clock.

- **drafter** (:func:`early_exit_drafter`): the target's first
  ``draft_layers`` blocks under the target's own embed, ``ln_f`` and
  unembed -- the SAME tensors (with ``draft_dim``, sliced views), in its
  own paged pool of the target pool's geometry;
- **draft program** (:func:`make_draft`): ``steps`` single-token drafter
  steps (``k``, or ``k + 1`` when a slot owes the drafter two catch-up
  tokens after a full accept);
- **verify program** (:func:`make_verify`): ``k + 1`` single-token target
  steps that write KV optimistically; the engine rolls both pools back to
  the accepted prefix with :func:`.kv_pages.truncate_to`.

Every step of both programs is :func:`_position_step`, which is also the
body of the engine's decode tick: the same ops at the same ``[S, 1, D]``
shapes, so the verify pass's argmax is the tick's, bitwise.  Python loops
stand in for ``lax.scan``; no body reads the host, so each program captures
as one CUDA graph.

The virtual clock prices a verify pass as one tick (one weight stream) and
each drafter step at :func:`flop_ratio` ticks -- JAX's cost model.  The
verify pass here is ``k + 1`` single-token steps, each streaming the
weights again, so on the card a round costs about ``(k + 1) + steps *
flop_ratio`` ticks of wall time.

Under tensor parallelism (``tp_axis``) both programs run on the rank's
Megatron slices and the head-split pools, as the tick does: the drafter is
built from the unsharded target, then sliced the same way.

``describe()`` (the TP lowering registry hook) waits for A12 and raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ddl25spring_tpu_torch.models import decode as decode_mod
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.serve import kv_pages
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace

__all__ = [
    "Drafter", "early_exit_drafter", "flop_ratio", "matmul_param_count",
    "make_draft", "make_verify", "describe",
]


# ------------------------------------------------------------ the drafter


class Drafter:
    """A drafter built from a target's tensors, shaped like
    :class:`~ddl25spring_tpu_torch.models.llama.Llama` for the serve
    programs (``embed``, ``blocks``, ``ln_f``, ``unembed``,
    :meth:`parameters`).  It owns no tensor.  The serve engine holds a TP
    rank's slices of a model (or of a drafter) in one too."""

    def __init__(self, cfg: LlamaConfig, embed, blocks, ln_f, unembed):
        self.cfg = cfg
        self.embed, self.blocks, self.ln_f, self.unembed = embed, list(blocks), ln_f, unembed

    def parameters(self):
        yield self.embed
        for b in self.blocks:
            yield from (b.parameters() if isinstance(b, torch.nn.Module) else vars(b).values())
        yield self.ln_f
        yield self.unembed


def early_exit_drafter(model: llama.Llama, cfg: LlamaConfig, draft_layers: int,
                       draft_dim: int | None = None) -> tuple[Drafter, LlamaConfig]:
    """The self-drafting LLaMA: ``model``'s first ``draft_layers`` blocks
    under its own embed / ``ln_f`` / unembed.  Early exit needs no training
    and keeps real argmax agreement with the target.  ``draft_dim``
    additionally slices the model dimension to the leading ``draft_dim``
    channels (every projection sliced consistently).

    Returns ``(drafter, draft_cfg)``: the drafter's tensors ARE the
    target's (views, no copy)."""
    if not 1 <= draft_layers <= cfg.n_layers:
        raise ValueError(
            f"draft_layers={draft_layers} must sit in [1, n_layers={cfg.n_layers}]")
    d = cfg.dmodel if draft_dim is None else int(draft_dim)
    if not 1 <= d <= cfg.dmodel:
        raise ValueError(f"draft_dim={draft_dim} must sit in [1, dmodel={cfg.dmodel}]")
    if d % cfg.num_heads or (d // cfg.num_heads) % 2:
        raise ValueError(
            f"draft_dim={d} must keep an even head_dim over {cfg.num_heads} heads "
            "(RoPE rotates channel pairs)")
    draft_cfg = replace(cfg, n_layers=draft_layers, dmodel=d)
    blocks = list(model.blocks)[:draft_layers]
    if d == cfg.dmodel:
        return Drafter(draft_cfg, model.embed, blocks, model.ln_f, model.unembed), draft_cfg
    _refuse_moe(cfg)
    f = draft_cfg.ffn_dim
    sliced = [SimpleNamespace(
        ln1=b.ln1[:d], wq=b.wq[:d, :d], wk=b.wk[:d, :d], wv=b.wv[:d, :d], wo=b.wo[:d, :d],
        ln2=b.ln2[:d], w_gate=b.w_gate[:d, :f], w_up=b.w_up[:d, :f], w_down=b.w_down[:f, :d],
    ) for b in blocks]
    return Drafter(draft_cfg, model.embed[:, :d], sliced, model.ln_f[:d],
                   model.unembed[:d, :]), draft_cfg


def matmul_param_count(model) -> int:
    """Parameters a decode step streams through matmuls: everything but the
    embedding table (a gather; unembed IS counted).  ``2 *`` this is the
    per-token decode FLOP estimate behind :func:`flop_ratio`."""
    return sum(p.numel() for p in model.parameters() if p is not model.embed)


def flop_ratio(drafter, model) -> float:
    """The drafter's per-token decode FLOPs as a fraction of the target's:
    what the virtual clock charges each drafter step."""
    return matmul_param_count(drafter) / matmul_param_count(model)


# ------------------------------------------------------ program bodies


def _position_step(cfg: LlamaConfig, tp_axis=None, layer_stack=None):
    """One single-token step over a paged pool: reserve a page where the
    position opens one, write the token's KV (rows not ``writing``
    trash-route), run the block stack, return the fp32 logits.  ``tp_axis``
    and ``layer_stack`` go to the engine's layer walk (``serve/engine.py``'s
    ``_layers``).

    ``step(model, pool, tok, pos, writing) -> (pool, logits [S, V], ok)``.
    The decode tick, the draft and the verify programs all run this one
    body, so 'verify agrees with the tick' is structural, not a copy kept
    in step by hand."""
    from ddl25spring_tpu_torch.serve.engine import _layers

    def step(model, pool, tok, pos, writing):
        page_len = pool["k"].shape[2]
        n_pages = pool["free"].shape[0]
        slots = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
        need = writing & (pos % page_len == 0)
        pool, ok = kv_pages.reserve_pages(pool, slots, pos, need)
        pages, offs = kv_pages.write_page_ids(pool, slots, pos, writing)
        rows = pool["page_table"].long().clamp(0, n_pages - 1)  # [S, P]

        x = decode_mod.embed_tokens(model, tok[:, None], cfg)
        cos, sin = llama.rope_angles(1, cfg.head_dim, pos=pos.float())
        x = _layers(model, x, pool, rows, pages, offs, pos, cos, sin, cfg, tp_axis,
                    layer_stack)
        return pool, llama.unembed(model, x, cfg)[:, 0], ok

    return step


def _greedy(logits, active):
    """The argmax of each row (the first maximum, as JAX's) and the max
    |logit| over the live rows (the sentinel's loss)."""
    absmax = torch.where(active, logits.abs().amax(-1), 0.0).amax()
    return logits.argmax(-1).to(torch.int32), absmax


def _spec_guard(strategy, out, pool, absmax, s_on, s_policy, sink):
    """The drafter's / verifier's sentinel: a non-finite logit on a live row
    poisons the round (JAX: ``updates={"logits_absmax": absmax}``)."""
    return sentinels.guard(
        strategy, (out, pool), names=[("logits_absmax",)], loss=absmax.amax(),
        updates=[[absmax]], enabled=s_on, policy=s_policy, sink=sink,
    )


def _refuse_moe(cfg: LlamaConfig):
    if cfg.n_experts > 0:
        raise NotImplementedError("serve/ decodes dense-FFN configs only")


def make_draft(cfg: LlamaConfig, *, k: int, steps: int | None = None, tp_axis=None,
               sentinel: bool | None = None, strategy: str = "serve-draft"):
    """Build the draft program: ``k`` greedy drafter tokens for every active
    slot, over the drafter's own pool.

    ``draft(model, pool, ctx, n_ctx, limits, sink=None) -> (pool, drafts,
    ok)``: ``ctx [S, 2]`` int32 holds each slot's catch-up tokens (committed
    tokens the drafter has not written: the last committed token, plus after
    a full accept the final draft it sampled but never wrote), ``n_ctx
    [S]`` how many are valid (0 marks an idle slot), ``limits [S]`` each
    slot's write bound (``prompt_len + max_new - 1``, the verify pass's:
    a drafter write past it would open a page admission never billed).
    Step ``j`` (of ``steps``, ``k`` or ``k + 1``) feeds catch-up token ``j``
    while ``j < n_ctx``, its own previous sample after, writing at
    ``seq_len + j`` (masked from ``n_ctx + k - 1`` on: the final draft is
    sampled, never written).  Slot ``s``'s drafts are the samples of steps
    ``n_ctx[s] - 1 .. n_ctx[s] + k - 2``, gathered into ``drafts [S, k]``.
    ``tp_axis``: the drafter's Megatron slices and head-split pool."""
    if k < 1:
        raise ValueError(f"k={k} draft tokens must be >= 1")
    if steps is None:
        steps = k + 1
    if not k <= steps <= k + 1:
        # steps = k serves n_ctx <= 1 rounds; k + 1 the 2-token catch-up
        raise ValueError(f"steps={steps} must be k={k} or k+1")
    _refuse_moe(cfg)
    s_on, s_policy = sentinels.resolve(sentinel)
    step = _position_step(cfg, tp_axis)

    def draft(model, pool, ctx, n_ctx, limits, sink=None):
        active = pool["active"]
        base = pool["seq_len"]  # [S]: the frontier at the round's start
        write_upto = n_ctx + (k - 1)
        cur = torch.zeros_like(base)
        samps, absmax, oks = [], [], []
        for j in range(steps):
            tok = torch.where(j < n_ctx, ctx[:, min(j, ctx.shape[1] - 1)], cur)
            pos = base + j
            writing = active & (j < write_upto) & (pos < limits)
            pool, logits, ok = step(model, pool, tok, pos, writing)
            cur, m = _greedy(logits, active)
            samps.append(cur)
            absmax.append(m)
            oks.append(ok)
        samps = torch.stack(samps, dim=1)  # [S, steps]
        idx = ((n_ctx - 1)[:, None]
               + torch.arange(k, dtype=torch.int32, device=n_ctx.device)[None, :])
        drafts = torch.gather(samps, 1, idx.clamp(0, steps - 1).long())
        pool = {**pool, "seq_len": torch.where(active, base + write_upto, base)}
        drafts, pool = _spec_guard(strategy, drafts, pool, torch.stack(absmax), s_on,
                                   s_policy, sink)
        return pool, drafts, torch.stack(oks).all()

    return draft


def make_verify(cfg: LlamaConfig, *, k: int, tp_axis=None, sentinel: bool | None = None,
                strategy: str = "serve-verify"):
    """Build the verify program: the target scores all ``k + 1`` positions
    of each slot's draft window.

    ``verify(model, pool, toks, limits, sink=None) -> (pool, greedy, ok)``:
    ``toks [S, k+1]`` is each slot's last committed token followed by its
    ``k`` drafts, ``limits [S]`` the write bound (writes at or past it
    trash-route, so speculation never opens a page admission did not
    bill).  ``greedy [S, k+1]`` is the target's argmax after each position:
    ``greedy[:, j]`` is the token a decode tick would emit from the same
    context, computed by the tick's own step.  KV is written optimistically
    and ``seq_len`` advanced to ``min(base + k + 1, max(limits, base))``;
    the engine truncates both pools to the accepted prefix right after.
    ``tp_axis``: the target's Megatron slices and head-split pool."""
    if k < 1:
        raise ValueError(f"k={k} draft tokens must be >= 1")
    _refuse_moe(cfg)
    s_on, s_policy = sentinels.resolve(sentinel)
    step = _position_step(cfg, tp_axis)

    def verify(model, pool, toks, limits, sink=None):
        active = pool["active"]
        base = pool["seq_len"]
        gs, absmax, oks = [], [], []
        for j in range(k + 1):
            pos = base + j
            pool, logits, ok = step(model, pool, toks[:, j], pos, active & (pos < limits))
            g, m = _greedy(logits, active)
            gs.append(g)
            absmax.append(m)
            oks.append(ok)
        frontier = torch.minimum(base + (k + 1), torch.maximum(limits, base))
        pool = {**pool, "seq_len": torch.where(active, frontier, base)}
        greedy, pool = _spec_guard(strategy, torch.stack(gs, dim=1), pool,
                                   torch.stack(absmax), s_on, s_policy, sink)
        return pool, greedy, torch.stack(oks).all()

    return verify


# ------------------------------------------------------ registry hook


def describe(mesh=None, program: str = "verify", **_kw):
    """The compile-analytics hook of the JAX package's registry entries
    ``serve-draft`` / ``serve-verify``: waits for A12 of ROADMAP.md."""
    raise NotImplementedError(
        f"describe() of the speculative {program!r} program waits for A12 of ROADMAP.md "
        "(the compile-analytics registry)")
