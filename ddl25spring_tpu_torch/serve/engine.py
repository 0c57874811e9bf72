"""Continuous-batching LLaMA decode engine over the paged KV cache: the
counterpart of the JAX package's ``serve/engine.py`` on one card.

- **prefill/decode disaggregation**: separately built static-shape
  programs.  ``prefill`` runs a padded prompt batch through the cached
  single-token step, writing KV pages and emitting each request's first
  sampled token; ``decode`` packs every active slot into ONE
  ``[max_slots]`` tick (inactive slots ride along masked).
- **one capture per program**: where JAX jits each program once per key, the
  port captures each program of each engine ONCE as a ``torch.cuda.CUDAGraph``
  on the engine's own pool (the decode tick, each prefill start offset, the
  release) and replays it: the replay reads static input buffers and updates
  the pool in place (JAX's donated pool).  The program bodies are shared per key
  (``_BODIES``) but a graph is bound to its buffers' addresses, so every
  engine captures its own.  ``warmup()`` captures them all before the clock
  starts; a program that cannot be captured raises.  On the CPU, and on the
  card with ``graphs=False``, the same bodies run eagerly (so a graph's
  replay can be held bitwise against eager).
- **continuous batching**: a sequence that stops mid-flight releases its
  slot and its pages; the next scheduler iteration admits queued requests
  into the freed capacity.  ``admission="static"`` admits a new batch only
  when every slot is idle — the A/B ``bench --serve`` prices.
- **admission control**: a bounded queue, a queued-token budget and
  reject-with-reason, every rejection counted by cause.
- **the radix prefix cache** (:mod:`.prefix`): matched prompt pages are
  shared by reference, a partial tail page copied on write, and the prefill
  starts at the page-aligned match (one program per start offset).
- **speculative decoding** (``spec_k > 0``, :mod:`.spec`): a drafter with
  its own pool proposes ``spec_k`` tokens a round, one verify program scores
  them, both pools roll back to the accepted prefix (a truncate program per
  pool); greedy acceptance keeps the stream the sequential engine's.
- **elastic handoff**: :meth:`ServeEngine.begin_drain` hands the queue back
  and :meth:`ServeEngine.retire` gives a drained replica's device memory
  back (``serve/driver.py``'s ``elastic_serve_run``).
- **TP-sharded serving** (``tp > 1``, ``mesh=``): one process per rank of the
  mesh's ``model`` axis, each running a whole engine over its shard: the
  pool's heads ``H/tp`` (dim :data:`KV_POOL_HEAD_DIM`), the Megatron slices
  of the blocks with the vocabulary replicated, and the same host scheduler.
  Each block sums its attention and its FFN output over the axis in
  ``cfg.dtype`` (JAX's two ``psum``s), so every rank holds the same logits
  and samples the same tokens; the wall clock is rank 0's, broadcast once per
  scheduler iteration, and :meth:`ServeEngine.check_lockstep` raises if the
  ranks' streams or counters differ.  ``weight_stream=True`` keeps the blocks
  as ZeRO-3 rows (:func:`~ddl25spring_tpu_torch.parallel.zero.
  zero_stream_llama_params`) and gathers one layer at a time inside the tick,
  the next layer's gather issued before the current layer computes; a
  prefill gathers the whole stack once.  Ranks that share a card are not
  graphed: the TP engine runs its programs eagerly and refuses
  ``graphs=True``.

The decode sentinel guards each program's logits through
:func:`~ddl25spring_tpu_torch.obs.sentinels.guard` (a graph's facts fold
after its replay), each scheduler iteration lands in the flight ring, and
the ``serve_*`` timeline events carry each request's life.

``describe()`` waits for A12 (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import json
import math
import random
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ddl25spring_tpu_torch.analysis import host_sanitizer as _sanitizer
from ddl25spring_tpu_torch.models import decode as decode_mod
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.obs import memscope as _memscope
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.obs import spans as _spans
from ddl25spring_tpu_torch.obs import state as _obs_state
from ddl25spring_tpu_torch.obs.recorder import flight
from ddl25spring_tpu_torch.obs.timeline import timeline as _timeline
from ddl25spring_tpu_torch.serve import kv_pages
from ddl25spring_tpu_torch.serve import spec as spec_mod
from ddl25spring_tpu_torch.serve.prefix import Match, PrefixCache
from ddl25spring_tpu_torch.utils.config import LlamaConfig

# submit()-time rejection reasons — the admission-control contract the
# serving telemetry counts by cause
REJECT_QUEUE_FULL = "queue_full"
REJECT_TOKEN_BUDGET = "token_budget"
REJECT_TOO_LONG = "too_long"
REJECT_POOL_EXHAUSTED = "pool_exhausted"
REJECT_BAD_REQUEST = "bad_request"  # empty prompt / non-positive max_new
REJECT_DRAINING = "draining"  # a draining replica admits nothing

# the dim of the pool's k/v ([n_pages + 1, L, page_len, H, hd]) a TP engine
# splits over its model axis (JAX's KV_POOL_HEAD_DIM)
KV_POOL_HEAD_DIM = 3


# ------------------------------------------------------------ the programs


def _rope_rows(x, cos, sin):
    """RoPE for a single-token batch whose POSITION varies per row: ``x [B,
    1, H, hd]``, ``cos/sin [B, hd/2]``.  The arithmetic of
    :func:`~ddl25spring_tpu_torch.models.llama.apply_rope` with the position
    on the batch axis, so fp32 values match the dense decode bitwise."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[:, None, None, :]
    s = sin[:, None, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _paged_block(p, x, kp, vp, layer: int, rows, pages, offs, pos, cos, sin,
                 cfg: LlamaConfig, tp_axis=None):
    """One block on a single-token slice ``x [B, 1, D]`` against the PAGE
    POOL — the paged twin of :func:`~ddl25spring_tpu_torch.models.decode.
    _block_decode`, op for op (same products, float32 softmax, ``-1e30``
    mask fill), so greedy fp32 paged decode equals dense.  ``rows`` is the
    clamped page table ``[B, P]`` of the batch's sequences; ``pages``/
    ``offs`` the write coordinates of position ``pos`` (trash-routed where
    masked).  ``tp_axis``: ``p`` is the rank's Megatron slice and the pool
    holds its heads; the attention and FFN outputs are summed over the axis
    in ``cfg.dtype``, as JAX's ``psum``s."""
    dtype = llama._dtype(cfg)
    B = x.shape[0]
    hd = cfg.head_dim

    h = llama.rms_norm(x, p.ln1)
    q = (h @ p.wq.to(dtype)).view(B, 1, -1, hd)
    k = (h @ p.wk.to(dtype)).view(B, 1, -1, hd)
    v = (h @ p.wv.to(dtype)).view(B, 1, -1, hd)
    q = _rope_rows(q, cos, sin)
    k = _rope_rows(k, cos, sin)

    kv_pages.append_layer_kv(kp, vp, layer, pages, offs, k[:, 0], v[:, 0])
    ks = kp[:, layer][rows]  # [B, P, page_len, H, hd]
    vs = vp[:, layer][rows]
    P, page_len = ks.shape[1], ks.shape[2]
    ks = ks.reshape(B, P * page_len, -1, hd)
    vs = vs.reshape(B, P * page_len, -1, hd)

    s = torch.einsum("bqhd,bmhd->bhqm", q, ks).float() / math.sqrt(hd)
    live = torch.arange(P * page_len, device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], -1e30)
    probs = torch.softmax(s, dim=-1).to(dtype)
    attn = torch.einsum("bhqm,bmhd->bqhd", probs, vs)
    x = x + decode_mod._psum(attn.reshape(B, 1, -1) @ p.wo.to(dtype), tp_axis)

    h = llama.rms_norm(x, p.ln2)
    gate = F.silu(h @ p.w_gate.to(dtype))
    return x + decode_mod._psum((gate * (h @ p.w_up.to(dtype))) @ p.w_down.to(dtype), tp_axis)


def _layers(model, x, pool, rows, pages, offs, pos, cos, sin, cfg, tp_axis=None,
            layer_stack=None):
    """The block stack on ``x``: ``model``'s resident blocks in order, or the
    walk ``layer_stack(model, run_layer, x) -> x`` with ``run_layer(block,
    li, x)`` one block's paged step (the weight-streaming decode's hook)."""
    def run_layer(block, li, x):
        return _paged_block(block, x, pool["k"], pool["v"], li, rows, pages, offs, pos,
                            cos, sin, cfg, tp_axis)

    if layer_stack is not None:
        return layer_stack(model, run_layer, x)
    for li, block in enumerate(model.blocks):
        x = run_layer(block, li, x)
    return x


def _guard(strategy, new_tok, pool, live, logits, s_on, s_policy, sink):
    """The decode sentinel: a non-finite logit on a live row is the serving
    analogue of a NaN loss (the max |logit| of the live rows is the "loss",
    their logits the "updates"; dead rows carry garbage and are masked)."""
    return sentinels.guard(
        strategy, (new_tok, pool), names=[("logits",)],
        loss=torch.where(live, logits.abs().amax(-1), 0.0).amax(),
        updates=[[torch.where(live[:, None], logits, 0.0)]],
        enabled=s_on, policy=s_policy, sink=sink,
    )


def _refuse_moe(cfg: LlamaConfig):
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "serve/ decodes dense-FFN configs only (MoE decode exists in "
            "models/decode.py; paging it is future work)")


def make_decode_tick(cfg: LlamaConfig, *, temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, tp_axis=None, sentinel: bool | None = None,
                     strategy: str = "serve-decode", layer_stack=None):
    """Build the decode program body: one token for EVERY active slot.

    ``tick(model, pool, tokens, noise, sink=None) -> (pool, new_tokens, ok)``
    — ``tokens [max_slots]`` int32 are appended at each slot's current
    position (the previous tick's samples), ``new_tokens`` the next ones,
    ``ok`` the pool-exhaustion backstop flag (a bool tensor); ``noise [S,
    V]`` the uniforms a sampled tick draws from (None when greedy).  Static
    shapes, no host read.  The sentinel's gate and policy resolve at BUILD
    time; ``sink`` takes its facts (a captured graph's).

    ``tp_axis``: ``model`` holds the rank's Megatron slices and the pool its
    heads (:class:`ServeEngine` with ``tp > 1``).  ``layer_stack`` replaces
    the walk over resident blocks (:func:`_layers`): the weight-streaming
    decode's :func:`_stream_layer_stack` rides it; None keeps the resident
    walk."""
    _refuse_moe(cfg)
    s_on, s_policy = sentinels.resolve(sentinel)
    step = spec_mod._position_step(cfg, tp_axis, layer_stack)

    def tick(model, pool, tokens, noise, sink=None):
        active = pool["active"]
        pos = pool["seq_len"]  # [S] — the position this tick writes
        pool, logits, ok = step(model, pool, tokens, pos, active)  # logits [S, V] fp32
        new_tok = decode_mod.sample_from_uniform(logits, noise, temperature, top_k, top_p)
        pool = {**pool, "seq_len": torch.where(active, pos + 1, pos)}
        new_tok, pool = _guard(strategy, new_tok, pool, active, logits, s_on, s_policy, sink)
        return pool, new_tok, ok

    return tick


def make_prefill(cfg: LlamaConfig, *, max_prompt_len: int, start: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 tp_axis=None, sentinel: bool | None = None,
                 strategy: str = "serve-prefill"):
    """Build the prefill program body: write a padded prompt batch into the
    pool and sample each request's FIRST generated token.

    ``prefill(model, pool, prompts, lens, starts, slot_ids, noise, sink=None)
    -> (pool, first_tokens, ok)`` — ``prompts [B, max_prompt_len]`` int32
    (pad beyond ``lens``), ``slot_ids [B]`` the target slots (``-1`` = a
    padding row, which writes only to the trash page).  The prompt positions
    run through the SAME cached single-token step as decode, positions
    ``[start, max_prompt_len)``.  On exit the target slots are active with
    ``seq_len = lens``.

    ``start`` is the prefix cache's STATIC start offset: the skipped
    positions are the prefill work a radix hit saves, and the offset being
    fixed at build time keeps every position absolute (one program per
    offset; the engine quantizes offsets to page multiples).  ``starts
    [B]`` carries each row's own matched length (``>= start``): rows never
    write positions below it — those positions' KV already sit in the pages
    ``kv_pages.adopt_prefix`` seated — and a row whose ``starts`` exceeds
    ``start`` replays the gap's compute with its writes trash-routed.
    ``tp_axis`` as :func:`make_decode_tick`'s."""
    _refuse_moe(cfg)
    if not 0 <= start < max_prompt_len:
        raise ValueError(
            f"start={start} must sit in [0, max_prompt_len={max_prompt_len})")
    s_on, s_policy = sentinels.resolve(sentinel)

    def prefill(model, pool, prompts, lens, starts, slot_ids, noise, sink=None):
        B = prompts.shape[0]
        S = pool["page_table"].shape[0]
        n_pages = pool["free"].shape[0]
        page_len = pool["k"].shape[2]
        valid_row = slot_ids >= 0
        pool = kv_pages.activate_slots(pool, slot_ids, valid_row)
        last_logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                                  device=prompts.device)
        ok_all = torch.ones((), dtype=torch.bool, device=prompts.device)
        for i in range(start, max_prompt_len):
            tok = prompts[:, i]
            pos = torch.full((B,), i, dtype=torch.int32, device=prompts.device)
            writing = valid_row & (i >= starts) & (i < lens)
            need = writing & (i % page_len == 0)
            pool, ok = kv_pages.reserve_pages(pool, slot_ids, pos, need)
            pages, offs = kv_pages.write_page_ids(pool, slot_ids, pos, writing)
            rows = pool["page_table"][slot_ids.long().clamp(0, S - 1)].long().clamp(
                0, n_pages - 1)  # [B, P]

            x = decode_mod.embed_tokens(model, tok[:, None], cfg)
            cos, sin = llama.rope_angles(1, cfg.head_dim, pos=pos.float())
            x = _layers(model, x, pool, rows, pages, offs, pos, cos, sin, cfg, tp_axis)
            logits = llama.unembed(model, x, cfg)[:, 0]
            last_logits = torch.where((i == lens - 1)[:, None], logits, last_logits)
            ok_all = ok_all & ok
        first = decode_mod.sample_from_uniform(last_logits, noise, temperature, top_k, top_p)
        pool = {**pool, "seq_len": kv_pages._drop_set(pool["seq_len"], slot_ids, valid_row,
                                                     lens)}
        first, pool = _guard(strategy, first, pool, valid_row, last_logits, s_on, s_policy,
                             sink)
        return pool, first, ok_all

    return prefill


def _release(model, pool, mask, sink=None):
    return (kv_pages.release_slots(pool, mask),)


def _truncate(model, pool, new_lens, mask, sink=None):
    return (kv_pages.truncate_to(pool, new_lens, mask),)


# One set of program BODIES per build key: the ramp engine and both A/B
# engines of a `bench --serve` run (and every same-config test engine) reuse
# them.  Keyed on everything that shapes the built body — cfg, prompt width,
# start offset, sampling and the RESOLVED sentinel gate + policy.  A body is
# a function; each engine captures its own graph of it on its own pool.
_BODIES: dict[tuple, Any] = {}


def _body(key: tuple, build):
    """The body cached under ``key``, built by ``build()`` on first use."""
    if key not in _BODIES:
        _BODIES[key] = build()
    return _BODIES[key]


def _compiled_programs(cfg: LlamaConfig, *, max_prompt_len: int, temperature: float,
                       sentinel: bool | None):
    """``(tick, prefill at start 0, release)`` bodies for one build key."""
    tick = _body(("tick", cfg, temperature, sentinels.resolve(sentinel)),
                 lambda: make_decode_tick(cfg, temperature=temperature, sentinel=sentinel))
    return (tick,
            _prefill_variant(cfg, max_prompt_len=max_prompt_len, start=0,
                             temperature=temperature, sentinel=sentinel),
            _release)


def _prefill_variant(cfg: LlamaConfig, *, max_prompt_len: int, start: int,
                     temperature: float, sentinel: bool | None):
    """The prefill body for one STATIC start offset."""
    return _body(("prefill", cfg, max_prompt_len, start, temperature,
                  sentinels.resolve(sentinel)),
                 lambda: make_prefill(cfg, max_prompt_len=max_prompt_len, start=start,
                                      temperature=temperature, sentinel=sentinel))


def _spec_programs(cfg: LlamaConfig, draft_cfg: LlamaConfig, *, k: int,
                   max_prompt_len: int, sentinel: bool | None) -> dict:
    """The speculative bodies for one build key: the ``k``- and ``k +
    1``-step drafts, the verify pass and the drafter's prefill (start 0,
    greedy).  Rollback rides :func:`_truncate`."""
    gate = sentinels.resolve(sentinel)
    return {
        "draft_k": _body(("draft", draft_cfg, k, k, gate), lambda: spec_mod.make_draft(
            draft_cfg, k=k, steps=k, sentinel=sentinel)),
        "draft_k1": _body(("draft", draft_cfg, k, k + 1, gate), lambda: spec_mod.make_draft(
            draft_cfg, k=k, steps=k + 1, sentinel=sentinel)),
        "verify": _body(("verify", cfg, k, gate), lambda: spec_mod.make_verify(
            cfg, k=k, sentinel=sentinel)),
        "draft_prefill": _prefill_variant(draft_cfg, max_prompt_len=max_prompt_len, start=0,
                                          temperature=0.0, sentinel=sentinel),
    }


# ------------------------------------------------------------ TP programs


def _block_leaves(block) -> dict:
    """A dense block's leaves by name (a module's or a namespace's)."""
    return {k: getattr(block, k) for k in (*llama.ATTN_BLOCK_KEYS, *llama.FFN_KEYS)}


def _tp_slice_block(p: dict, index: int, n: int) -> SimpleNamespace:
    """Index ``index``'s Megatron slice of a WHOLE block's leaves ``p``: the
    column leaves (``wq``/``wk``/``wv``/``w_gate``/``w_up``) cut on their last
    dim, the row leaves (``wo``/``w_down``) on their first, the norms whole
    (JAX ``_tp_slice_block``, ``engine.py:546``).  These are the chunks
    :func:`~ddl25spring_tpu_torch.parallel.tp.shard_tp_params` places, each in
    a fresh tensor as a resident rank holds it, so the compute after a
    streamed gather is the resident program's, bit for bit."""
    from ddl25spring_tpu_torch.parallel.tp import _COL, _ROW

    out = {}
    for name, w in p.items():
        if name in _COL:
            c = w.shape[-1] // n
            out[name] = w[..., index * c:(index + 1) * c].clone(
                memory_format=torch.contiguous_format)
        elif name in _ROW:
            c = w.shape[0] // n
            out[name] = w[index * c:(index + 1) * c].clone(memory_format=torch.contiguous_format)
        else:
            out[name] = w
    return SimpleNamespace(**out)


@torch.no_grad()
def _tp_shard(model, cfg: LlamaConfig, axis, device) -> spec_mod.Drafter:
    """This rank's resident TP shard of ``model`` (a ``Llama`` or a drafter)
    on ``device``: its blocks' Megatron slices, the vocabulary (``embed``,
    ``unembed``) and the norms replicated (``shard_tp_params(...,
    shard_vocab=False)``)."""
    blocks = [_tp_slice_block({k: t.detach().to(device) for k, t in _block_leaves(b).items()},
                              axis.index, axis.size) for b in model.blocks]
    return spec_mod.Drafter(cfg, model.embed.detach().to(device), blocks,
                            model.ln_f.detach().to(device), model.unembed.detach().to(device))


def _stream_layer_stack(axis, plan, paths):
    """The ZeRO-3 streaming walk over the block stack, a ``layer_stack`` for
    :func:`make_decode_tick` (JAX ``_stream_layer_stack``, ``engine.py:572``):
    ``model`` is a :class:`~ddl25spring_tpu_torch.parallel.zero.StreamRows`,
    ``plan`` its per-layer bucket plan and ``paths`` one block's leaf paths.
    Layer ``i + 1``'s bucketed all-gather is issued before layer ``i``
    computes; each gathered layer is TP-sliced here and run through the
    row-parallel paged block; the last layer is peeled (nothing left to
    prefetch).  ``plan.n_buckets * n_layers`` all-gathers a tick."""
    from ddl25spring_tpu_torch.parallel import zero

    def gathered(bufs, i, pending=None):
        leaves = zero.stream_gather_layer(plan, [b[i] for b in bufs], axis, pending)
        return _tp_slice_block(dict(zip(paths, leaves)), axis.index, axis.size)

    def layer_stack(model, run_layer, x):
        bufs = model.bufs
        L = len(model.blocks)
        cur = gathered(bufs, 0)
        for i in range(L):
            nxt = (zero.stream_start_layer([b[i + 1] for b in bufs], axis)
                   if i + 1 < L else None)
            x = run_layer(cur, i, x)
            if nxt is not None:
                cur = gathered(bufs, i + 1, nxt)
        return x

    return layer_stack


def _tp_compiled_programs(cfg: LlamaConfig, axis, *, max_prompt_len: int, temperature: float,
                          sentinel: bool | None, stream=None):
    """``(tick, prefill at start 0, release)`` bodies of a TP engine on
    ``axis`` (JAX ``_tp_compiled_programs``, ``engine.py:702``); ``stream``
    is the weight-streaming decode's ``(plan, paths)``, None for resident
    weights.  The release touches only the replicated accounting."""
    tick = _body(("tp tick", cfg, axis, temperature, sentinels.resolve(sentinel), stream),
                 lambda: make_decode_tick(
                     cfg, temperature=temperature, tp_axis=axis, sentinel=sentinel,
                     layer_stack=None if stream is None else _stream_layer_stack(axis, *stream)))
    return (tick,
            _tp_prefill_variant(cfg, axis, max_prompt_len=max_prompt_len, start=0,
                                temperature=temperature, sentinel=sentinel, stream=stream),
            _release)


def _tp_prefill_variant(cfg: LlamaConfig, axis, *, max_prompt_len: int, start: int,
                        temperature: float, sentinel: bool | None, stream=None):
    """A TP engine's prefill body for one STATIC start offset (JAX
    ``_tp_prefill_variant``, ``engine.py:660``).  Streamed, it gathers the
    whole block stack once per call (transient), where a per-layer walk
    would gather every layer once per prompt position."""
    def build():
        body = make_prefill(cfg, max_prompt_len=max_prompt_len, start=start,
                            temperature=temperature, tp_axis=axis, sentinel=sentinel)
        if stream is None:
            return body
        from ddl25spring_tpu_torch.parallel import zero

        plan, paths = stream

        def streamed(model, pool, *rest, sink=None):
            blocks = [_tp_slice_block(dict(zip(paths, leaves)), axis.index, axis.size)
                      for leaves in zero.stream_gather_blocks(plan, model.bufs, axis)]
            whole = spec_mod.Drafter(cfg, model.embed, blocks, model.ln_f, model.unembed)
            return body(whole, pool, *rest, sink=sink)

        return streamed

    return _body(("tp prefill", cfg, axis, max_prompt_len, start, temperature,
                  sentinels.resolve(sentinel), stream), build)


def _tp_spec_programs(cfg: LlamaConfig, draft_cfg: LlamaConfig, axis, *, k: int,
                      max_prompt_len: int, sentinel: bool | None) -> dict:
    """:func:`_spec_programs` on ``axis`` (JAX ``_tp_spec_programs``,
    ``engine.py:750``): the drafter's and the target's slices, each with its
    head-split pool."""
    gate = sentinels.resolve(sentinel)
    return {
        "draft_k": _body(("tp draft", draft_cfg, axis, k, k, gate), lambda: spec_mod.make_draft(
            draft_cfg, k=k, steps=k, tp_axis=axis, sentinel=sentinel)),
        "draft_k1": _body(("tp draft", draft_cfg, axis, k, k + 1, gate),
                          lambda: spec_mod.make_draft(draft_cfg, k=k, steps=k + 1, tp_axis=axis,
                                                      sentinel=sentinel)),
        "verify": _body(("tp verify", cfg, axis, k, gate), lambda: spec_mod.make_verify(
            cfg, k=k, tp_axis=axis, sentinel=sentinel)),
        "draft_prefill": _tp_prefill_variant(draft_cfg, axis, max_prompt_len=max_prompt_len,
                                             start=0, temperature=0.0, sentinel=sentinel),
    }


def _assign(pool: dict, new: dict) -> None:
    """Write a body's result pool into ``pool``'s own tensors, in place (the
    K/V pages were written in place already)."""
    for name, t in new.items():
        if t is not pool[name]:
            pool[name].copy_(t)


def _reset_pool(pool: dict) -> None:
    """Empty ``pool`` in place, keeping its tensors (a graph is bound to
    their addresses)."""
    pool["k"].zero_()
    pool["v"].zero_()
    pool["page_table"].fill_(-1)
    pool["seq_len"].zero_()
    pool["active"].fill_(False)
    pool["free"].fill_(True)
    pool["refcount"].zero_()


def _mute(facts, meta) -> None:
    """A sentinel sink that keeps nothing (a capture's warm-up call)."""


class _Program:
    """One serve program of one engine.

    Eager on the CPU (and on the card when ``graphs`` is off): the body runs
    and its pool is assigned into the engine's.  Otherwise the first call
    runs the body once on a scratch copy of the pool (lazy initialisations,
    the allocator's blocks, the sentinel's constants), captures it as a CUDA
    graph on the engine's pool and static copies of the inputs, and every
    call copies its inputs in and replays; the outputs are the graph's own
    tensors, valid until the next replay.  ``__call__`` returns ``(pool,
    *outputs)``."""

    def __init__(self, name: str, body, graphs: bool):
        self.name, self.body, self.graphs = name, body, graphs
        self.drop()

    def drop(self) -> None:
        """Release the captured graph (with its private memory pool), its
        static inputs and its outputs; a later call captures again."""
        self.graph = self.static = self.outs = self._bound = None
        self._facts = self._meta = None

    def __call__(self, model, pool, *inputs):
        dev = pool["k"].device
        if not (self.graphs and dev.type == "cuda"):
            outs = self.body(model, pool,
                             *(None if x is None else x.to(dev) for x in inputs))
            _assign(pool, outs[0])
            return (pool, *outs[1:])
        if self.graph is None:
            self._capture(model, pool, inputs)
        elif self._bound is not pool["k"]:
            raise RuntimeError(f"the serve program {self.name} is captured on another pool")
        for buf, x in zip(self.static, inputs):
            if buf is not None:
                buf.copy_(x, non_blocking=True)
        self.graph.replay()
        if self._facts is not None:
            sentinels.stage(self._facts, self._meta)
        return (pool, *self.outs)

    def _sink(self, facts, meta) -> None:
        # the facts tensor is the graph's own: every replay rewrites it
        self._facts, self._meta = facts, meta

    def _capture(self, model, pool, inputs):
        dev = pool["k"].device
        self.static = [None if x is None else x.to(dev).clone() for x in inputs]
        current = torch.cuda.current_stream(dev)
        stream = _capture_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            scratch = {name: t.clone() for name, t in pool.items()}
            self.body(model, scratch, *self.static, sink=_mute)
        current.wait_stream(stream)
        del scratch
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                outs = self.body(model, pool, *self.static, sink=self._sink)
                _assign(pool, outs[0])
        except Exception as e:  # a host read or copy inside the body
            raise RuntimeError(
                f"capturing the serve program {self.name} as a CUDA graph failed: {e}"
            ) from e
        self.graph, self.outs, self._bound = graph, outs[1:], pool["k"]


_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev):
    """The one side stream every serve program on ``dev`` is captured on.
    Each (cuBLAS handle, stream) pair keeps a workspace (32 MiB on Hopper)
    for the life of the process, so one stream for every capture costs one
    workspace, where a new stream per capture added one each, up to the
    stream pool's 32."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(torch.device("cuda", index))
    return _CAPTURE_STREAMS[index]


# ------------------------------------------------------------ host engine


def _pct(xs, q):
    """Nearest-rank percentile over any sample iterable (None when empty)."""
    xs = sorted(xs)
    if not xs:
        return None
    k = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
    return xs[k]


@dataclass
class Request:
    """One inference request (host side)."""

    rid: int
    prompt: Any  # 1-D list of token ids
    max_new_tokens: int
    arrival_t: float = 0.0
    # filled by the engine
    admitted_t: float | None = None
    # TTFT decomposition stamps (engine clock): when the admitting prefill
    # dispatch began, and what that prefill pass cost
    prefill_start_t: float | None = None
    prefill_s: float | None = None
    first_token_t: float | None = None
    done_t: float | None = None
    tokens: list = field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


# default sample cap for the engine's per-run host reservoirs
RESERVOIR_CAP = 4096


class Reservoir:
    """Bounded uniform sample of a per-run series + exact summary (Algorithm
    R with a dedicated seeded ``random.Random``, so token streams never
    depend on it), with exact ``count``/``max``/``min``/``total`` over the
    FULL series.  Below ``cap`` it is exactly an insertion-ordered list."""

    __slots__ = ("cap", "count", "max", "min", "total", "_xs", "_rng", "_seed")

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0):
        self.cap = int(cap)
        self._seed = int(seed)
        self._xs: list = []
        self._rng = random.Random(self._seed)
        self.count = 0
        self.max = None
        self.min = None
        self.total = 0.0

    def append(self, x) -> None:
        self.count += 1
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            self.total += x
            if self.max is None or x > self.max:
                self.max = x
            if self.min is None or x < self.min:
                self.min = x
        if len(self._xs) < self.cap:
            self._xs.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._xs[j] = x

    def clear(self) -> None:
        self._xs.clear()
        self._rng = random.Random(self._seed)
        self.count = 0
        self.max = None
        self.min = None
        self.total = 0.0

    def summary(self) -> dict:
        """The exact-count cell (telemetry)."""
        return {
            "count": self.count,
            "sampled": len(self._xs),
            "cap": self.cap,
            "max": self.max,
            "min": self.min,
            "mean": round(self.total / self.count, 6) if self.count else None,
        }

    def __len__(self) -> int:
        return len(self._xs)

    def __bool__(self) -> bool:
        return bool(self._xs)

    def __iter__(self):
        return iter(self._xs)

    def __getitem__(self, i):
        return self._xs[i]


class ServeEngine:
    """The scheduler loop: admission -> prefill -> packed decode ticks.

    Host-side state (queue, per-slot request records, page accounting)
    stays in Python; everything per token runs in the programs, on the
    device of ``params`` (a :class:`~ddl25spring_tpu_torch.models.llama.
    Llama`).  Admission reserves each request's WORST-CASE page need
    (``ceil((prompt + max_new) / page_len)``), so a request admitted can
    always finish; the device-side ``ok`` flag is the backstop.

    ``clock="wall"`` uses real time (the bench path); ``clock="virtual"``
    advances ``tick_s`` per program call — deterministic, which the
    continuous-vs-static A/B and the admission tests pin.  ``graphs``: on
    the card, capture each program as a CUDA graph, or run it eagerly (the
    TP engine's only way: ``tp > 1`` needs ``graphs=False``).  ``seed``
    seeds the sampling generator (on the model's device).

    ``tp > 1``: this process is one rank of ``mesh``'s ``model`` axis (of
    ``tp`` ranks) and serves its shard of ``params`` (the whole model, on any
    device) on ``mesh.device``; every rank of the axis must build the engine
    with the same arguments and drive it with the same calls.
    ``weight_stream=True`` keeps the blocks as ZeRO-3 rows and gathers them
    layer by layer (greedy or sampled decode; not with ``spec_k``).
    """

    def __init__(
        self,
        params: llama.Llama,
        cfg: LlamaConfig,
        *,
        page_len: int = 16,
        n_pages: int = 64,
        max_slots: int = 4,
        pages_per_seq: int | None = None,
        prefill_batch: int = 2,
        max_prompt_len: int = 32,
        max_queue: int = 64,
        token_budget: int | None = None,
        temperature: float = 0.0,
        eos_id: int | None = None,
        admission: str = "continuous",
        sentinel: bool | None = None,
        clock: str = "wall",
        tick_s: float = 1e-3,
        seed: int = 0,
        prefix_cache: bool = False,
        spec_k: int = 0,
        draft_layers: int = 1,
        draft_params=None,
        draft_cfg: LlamaConfig | None = None,
        tp: int = 1,
        weight_stream: bool = False,
        mesh=None,
        trace_label: str | None = "serve",
        graphs: bool = True,
    ):
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission={admission!r} is not 'continuous' or 'static'")
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock={clock!r} is not 'wall' or 'virtual'")
        if prefill_batch < 1:
            # a 0-width prefill admits nothing and the virtual clock never
            # advances — run() would spin to max_steps
            raise ValueError(f"prefill_batch={prefill_batch} must be >= 1")
        if spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0 (0 = off)")
        if spec_k and temperature != 0.0:
            raise ValueError(
                "speculative decoding is greedy-only "
                f"(temperature={temperature} with spec_k={spec_k})")
        if tp < 1:
            raise ValueError(f"tp={tp} must be >= 1")
        if weight_stream and tp == 1:
            raise ValueError(
                "weight_stream streams ZeRO-3 rows over the model mesh axis — it "
                "requires tp > 1 (tp=1 holds the whole model per rank by construction)")
        if weight_stream and spec_k:
            raise ValueError(
                "weight_stream serves the plain decode path only: the drafter's rounds "
                "would re-stream the target stack per round (spec_k must be 0)")
        self.tp = int(tp)
        self.weight_stream = bool(weight_stream)
        self.mesh = mesh if self.tp > 1 else None
        self.axis = None
        if self.tp > 1:
            have = (mesh.axis("model").size
                    if mesh is not None and "model" in mesh.grid.names else 0)
            if have != self.tp:
                raise ValueError(
                    f"tp={self.tp} needs {self.tp} ranks on the 'model' axis of a mesh "
                    f"(one process per shard, as bench --serve --serve-tp starts them); "
                    f"the mesh given has {have}")
            if cfg.num_heads % self.tp:
                raise ValueError(f"{cfg.num_heads} heads not divisible by tp={self.tp}")
            if graphs:
                raise ValueError(
                    "a TP engine is not graphed: its ranks share a card over gloo, whose "
                    "collectives a CUDA graph cannot hold (NCCL gives one rank per card); "
                    "pass graphs=False")
            self.axis = mesh.axis("model")
        self.cfg = cfg
        self.device = mesh.device if self.tp > 1 else next(params.parameters()).device
        self.page_len = page_len
        self.n_pages = n_pages
        self.max_slots = max_slots
        if pages_per_seq is None:  # explicit 0 must FAIL in the pool
            pages_per_seq = max(1, -(-cfg.ctx_size // page_len))
        self.pages_per_seq = pages_per_seq
        self.max_seq_len = self.pages_per_seq * page_len
        self.prefill_batch = prefill_batch
        self.max_prompt_len = max_prompt_len
        self.max_queue = max_queue
        self.token_budget = token_budget
        self.eos_id = eos_id
        self.admission = admission
        self.clock = clock
        self.tick_s = tick_s
        # the timeline track this engine's request events land on; None
        # keeps an engine off the timeline (the driver's A/B arms)
        self.trace_label = trace_label
        self.replica_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._temperature = temperature
        self._sentinel = sentinel
        self._graphs = graphs

        # TP: every rank holds its shard (the tensors split over the axis are
        # listed, for the global memory bill); the stream plan, when streaming
        self._stream = None
        if self.tp > 1 and self.weight_stream:
            from ddl25spring_tpu_torch.parallel import zero

            self.params = zero.zero_stream_llama_params(params, mesh, "model")
            self._stream = (self.params.plan, self.params.paths)
            self._split = {id(buf) for buf in self.params.bufs}
        elif self.tp > 1:
            self.params = _tp_shard(params, cfg, self.axis, self.device)
            self._split = {id(t) for b in self.params.blocks for k, t in vars(b).items()
                           if k not in ("ln1", "ln2")}
        else:
            self.params = params
            self._split = set()
        heads = cfg.num_heads // self.tp
        self.pool = kv_pages.init_page_pool(
            cfg, n_pages=n_pages, page_len=page_len, max_slots=max_slots,
            pages_per_seq=self.pages_per_seq, num_heads=heads, device=self.device,
        )
        if self.tp > 1:
            tick, prefill, release = _tp_compiled_programs(
                cfg, self.axis, max_prompt_len=max_prompt_len, temperature=temperature,
                sentinel=sentinel, stream=self._stream)
        else:
            tick, prefill, release = _compiled_programs(
                cfg, max_prompt_len=max_prompt_len, temperature=temperature, sentinel=sentinel)
        self._tick = _Program("decode_tick", tick, graphs)
        self._prefill_programs = {0: _Program("prefill@0", prefill, graphs)}
        self._release = _Program("release", release, graphs)
        # radix prefix cache (opt-in): host index over cached prompt pages;
        # device sharing runs through kv_pages.adopt_prefix / ref_pages /
        # unref_pages and the per-offset prefill programs
        self.prefix: PrefixCache | None = PrefixCache(page_len) if prefix_cache else None
        # speculative decoding (opt-in): a drafter with its OWN pool proposes
        # spec_k tokens a round, one verify pass scores them, truncate_to
        # rolls both pools back to the accepted prefix.  The default drafter
        # is the early-exit one; draft_params + draft_cfg give another.
        self.spec_k = int(spec_k)
        self.draft_pool: dict | None = None
        if self.spec_k:
            if draft_params is None:
                draft_params, draft_cfg = spec_mod.early_exit_drafter(params, cfg, draft_layers)
            elif draft_cfg is None:
                raise ValueError("explicit draft_params need their draft_cfg")
            # what each drafter step costs on the virtual clock, as a
            # fraction of a target decode tick (unsharded, as JAX's)
            self.spec_flop_ratio = spec_mod.flop_ratio(draft_params, params)
            if self.tp > 1:
                # the drafter derives from the UNSHARDED target and is sliced
                # the same way; its pool splits its heads likewise
                if draft_cfg.num_heads % self.tp:
                    raise ValueError(
                        f"draft {draft_cfg.num_heads} heads not divisible by tp={self.tp}")
                draft_params = _tp_shard(draft_params, draft_cfg, self.axis, self.device)
                self._split |= {id(t) for b in draft_params.blocks for k, t in vars(b).items()
                                if k not in ("ln1", "ln2")}
            self.draft_params, self.draft_cfg = draft_params, draft_cfg
            # the drafter pool has the target pool's geometry and shares
            # NOTHING (no prefix cache claims its pages), so spec admission
            # bills every request its full worst case (see _admittable)
            self.draft_pool = kv_pages.init_page_pool(
                draft_cfg, n_pages=n_pages, page_len=page_len, max_slots=max_slots,
                pages_per_seq=self.pages_per_seq, num_heads=draft_cfg.num_heads // self.tp,
                device=self.device,
            )
            if self.tp > 1:
                bodies = _tp_spec_programs(cfg, draft_cfg, self.axis, k=self.spec_k,
                                           max_prompt_len=max_prompt_len, sentinel=sentinel)
            else:
                bodies = _spec_programs(cfg, draft_cfg, k=self.spec_k,
                                        max_prompt_len=max_prompt_len, sentinel=sentinel)
            # a graph binds its pool's addresses: each pool's truncate and
            # release are programs of their own
            self._draft_k = _Program("draft_k", bodies["draft_k"], graphs)
            self._draft_k1 = _Program("draft_k1", bodies["draft_k1"], graphs)
            self._verify = _Program("verify", bodies["verify"], graphs)
            self._draft_prefill = _Program("draft_prefill@0", bodies["draft_prefill"], graphs)
            self._truncate = _Program("truncate", _truncate, graphs)
            self._draft_truncate = _Program("draft_truncate", _truncate, graphs)
            self._draft_release = _Program("draft_release", _release, graphs)
        # the pools' k/v hold the rank's heads
        self._split |= {id(pool[n]) for pool in (self.pool, self.draft_pool)
                        if pool is not None for n in ("k", "v")}
        self._flops_per_token = 2 * sum(p.numel() for p in params.parameters())

        # elastic handoff state: a draining replica admits nothing new
        self.draining = False

        # host state
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_slots
        self._slot_last_tok: list[int] = [0] * max_slots
        self._reserved: list[int] = [0] * max_slots  # pages per slot
        self._release_mask: list[bool] = [False] * max_slots
        # pages a completed slot still holds on device until the next
        # release flush — part of the exact free-mask mirror
        self._pending_pages: list[int] = [0] * max_slots
        # prefix-cache mirrors: pages each live slot shares by reference and
        # pages the cache claimed OUT of the slot's own prompt at insert —
        # both pin their pages against eviction while the slot lives
        self._adopted_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._cached_pages: list[list[int]] = [[] for _ in range(max_slots)]
        # spec: committed tokens the drafter has not appended yet (the last
        # committed token; after a full accept also the final draft it
        # sampled but never wrote) -- at most 2
        self._pending: list[list[int]] = [[] for _ in range(max_slots)]
        self._t0 = time.perf_counter()
        self._vtime = 0.0
        self._ticks = 0
        self._prefills = 0
        self._spec_rounds = 0
        self._draft_steps = 0  # drafter steps charged
        self._next_rid = 0
        # telemetry
        self.admitted = 0
        self.completed = 0
        self.rejected: dict[str, int] = {}
        self.generated_tokens = 0
        self.pool_ok_failures = 0
        self.peak_pages = 0
        self.prefill_tokens_saved = 0
        self.prefill_flops_saved = 0
        # spec counters: proposals = spec_k per live slot per round; accepted
        # = draft-origin tokens actually emitted; the accepted-prefix
        # histogram (a -> rounds)
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        self.spec_accept_counts: dict[int, int] = {}
        self.queue_depths = Reservoir()
        self.ttft_s = Reservoir()
        self.tick_wall_s = Reservoir()
        self.ttft_decomp = Reservoir()
        self.done: list[Request] = []
        # cumulative generated-token timeline [(t, tokens)], one point per
        # scheduler iteration — the A/B's "tokens delivered by time B"
        self.token_log: list[tuple[float, int]] = []
        # the per-engine memory observatory: sampling gates on
        # memscope.enabled() AND a trace label (the A/B arms stay silent),
        # one tick in memscope.CPU_EVERY on the CPU, whose reading walks the
        # live tensors
        self.memscope = _memscope.MemScope(label=trace_label or "serve",
                                           every=_memscope.default_every(self.device),
                                           device=self.device)
        # the last rid seated in each device slot — how a drain-time pool
        # residue is named (memscope.pool_leak_check attribution)
        self._slot_last_rid: list[int | None] = [None] * max_slots
        self.mem_leak: dict[str, Any] | None = None
        # DDL25_SANITIZE=1 asserts the host<->device page mirror at every
        # step boundary (a device sync — debug mode only)
        self._sanitize = _sanitizer.enabled()

    # ---- programs ------------------------------------------------------

    def _prefill_at(self, start: int) -> _Program:
        """This engine's prefill program for a STATIC start offset."""
        if start not in self._prefill_programs:
            if self.tp > 1:
                body = _tp_prefill_variant(
                    self.cfg, self.axis, max_prompt_len=self.max_prompt_len, start=start,
                    temperature=self._temperature, sentinel=self._sentinel,
                    stream=self._stream)
            else:
                body = _prefill_variant(
                    self.cfg, max_prompt_len=self.max_prompt_len, start=start,
                    temperature=self._temperature, sentinel=self._sentinel)
            self._prefill_programs[start] = _Program(f"prefill@{start}", body, self._graphs)
        return self._prefill_programs[start]

    def _noise(self, rows: int):
        """The uniforms a sampled program draws from (None when greedy)."""
        if self._temperature == 0.0:
            return None
        return decode_mod.uniform_noise((rows, self.cfg.vocab_size), self._gen, self.device)

    def _pool_op(self, fn, *args):
        """Run a sharing op of :mod:`.kv_pages` eagerly on the engine's pool
        (in place); returns its other outputs."""
        out = fn(self.pool, *(torch.as_tensor(a, device=self.device) for a in args))
        new, rest = (out, ()) if isinstance(out, dict) else (out[0], out[1:])
        _assign(self.pool, new)
        return rest

    # ---- time ----------------------------------------------------------

    def now(self) -> float:
        if self.clock == "virtual":
            return self._vtime
        return time.perf_counter() - self._t0

    def _agreed_now(self) -> float:
        """:meth:`now` as every rank of a TP engine sees it: on the wall
        clock, rank 0's reading, broadcast (the scheduler's decisions --
        arrivals, the budget -- must come out the same on every rank)."""
        if self.tp == 1 or self.clock == "virtual":
            return self.now()
        import torch.distributed as dist

        # an NCCL group takes tensors on the rank's card only
        dev = self.device if self.axis.comm.backend == "nccl" else "cpu"
        t = torch.tensor([self.now()], dtype=torch.float64, device=dev)
        dist.broadcast(t, src=self.axis.ranks[0], group=self.axis.group)
        return float(t)

    def check_lockstep(self) -> None:
        """Raise unless every rank of a TP engine finished the same requests
        with the same tokens and holds the same counters: a rank that drifted
        is a fault (a no-op at ``tp=1``)."""
        if self.tp == 1:
            return
        import torch.distributed as dist

        state = {
            "done": sorted((r.rid, list(r.tokens)) for r in self.done),
            "live": [(r.rid, list(r.tokens)) if r is not None else None for r in self.slots],
            "queue": [r.rid for r in self.queue],
            **{k: getattr(self, k) for k in (
                "admitted", "completed", "generated_tokens", "pool_ok_failures", "peak_pages",
                "prefill_tokens_saved", "draft_tokens_proposed", "draft_tokens_accepted",
                "_ticks", "_prefills")},
            "rejected": sorted(self.rejected.items()),
        }
        digest = hashlib.sha256(json.dumps(state, sort_keys=True).encode()).hexdigest()
        got: list = [None] * self.tp
        dist.all_gather_object(got, (digest, state), group=self.axis.group)
        if len({d for d, _ in got}) > 1:
            diff = {k: [st[k] for _, st in got] for k in state
                    if any(st[k] != got[0][1][k] for _, st in got)}
            raise RuntimeError(f"the TP ranks {list(self.axis.ranks)} drifted apart: {diff}")

    def _tl(self, kind: str, **fields) -> None:
        """One timeline event on this engine's track: host-side only, and a
        no-op unless obs is enabled AND the engine is labelled."""
        if self.trace_label is None or not _obs_state.enabled():
            return
        _timeline.emit(kind, vt=self.now(), engine=self.trace_label,
                       replica=self.replica_id, **fields)

    def warmup(self) -> None:
        """Capture every program (prefill, decode tick, release, and with the
        prefix cache every start offset) before the clock starts, then reset
        every piece of host state and telemetry and empty the pool in place:
        a serving bench must not bill captures as the first requests' TTFT.
        Admission knobs and EOS are suspended for the probe request, so the
        decode tick is always reached."""
        saved_eos, saved_budget = self.eos_id, self.token_budget
        self.eos_id, self.token_budget = None, None
        saved_label, self.trace_label = self.trace_label, None
        try:
            req = self.make_request([1], 2)  # 2nd token needs a decode tick
            if self.submit(req) is not None:
                import warnings

                warnings.warn(
                    f"serve warmup probe rejected ({list(self.rejected)}); the first "
                    "real request will pay the captures", stacklevel=2)
            for _ in range(8):
                if not self.step():
                    break
        finally:
            self.eos_id, self.token_budget = saved_eos, saved_budget
            self.trace_label = saved_label
        if self.spec_k:
            # the probe ran the drafter prefill, the k-step draft, verify
            # and both truncates and releases; the (k+1)-step draft runs
            # only after a full accept.  A graph is bound to its pool, so
            # capture it on the drafter's OWN pool with every slot idle
            # (n_ctx = 0: nothing is written)
            S = self.max_slots
            self._draft_k1(self.draft_params, self.draft_pool,
                           torch.zeros((S, 2), dtype=torch.int32),
                           torch.zeros((S,), dtype=torch.int32),
                           torch.zeros((S,), dtype=torch.int32))
            _reset_pool(self.draft_pool)
        _reset_pool(self.pool)
        self.queue.clear()
        self.slots = [None] * self.max_slots
        self._slot_last_tok = [0] * self.max_slots
        self._reserved = [0] * self.max_slots
        self._release_mask = [False] * self.max_slots
        self._pending_pages = [0] * self.max_slots
        self._adopted_pages = [[] for _ in range(self.max_slots)]
        self._cached_pages = [[] for _ in range(self.max_slots)]
        self._pending = [[] for _ in range(self.max_slots)]
        if self.prefix is not None:  # drop the probe's cached prompt
            self.prefix = PrefixCache(self.page_len)
            # the sharing ops at the exact shapes the engine calls them with
            # (all-padding args: no state changes)
            B, P = self.prefill_batch, self.pages_per_seq
            self._pool_op(kv_pages.ref_pages, np.full((P * B,), -1, np.int32))
            self._pool_op(kv_pages.unref_pages, np.full((self.n_pages,), -1, np.int32))
            self._pool_op(kv_pages.adopt_prefix, np.full((B,), -1, np.int32),
                          np.full((B, P), -1, np.int32), np.full((B,), -1, np.int32))
            # every start offset a radix hit can ride (page multiples)
            self.warm_prefill_starts(range(self.page_len, self.max_prompt_len, self.page_len))
        self._vtime = 0.0
        self._ticks = self._prefills = self._spec_rounds = self._draft_steps = 0
        self.draft_tokens_proposed = self.draft_tokens_accepted = 0
        self.spec_accept_counts = {}
        self.admitted = self.completed = self.generated_tokens = 0
        self.rejected = {}
        self.pool_ok_failures = 0
        self.peak_pages = 0
        self.prefill_tokens_saved = self.prefill_flops_saved = 0
        self.queue_depths.clear()
        self.ttft_s.clear()
        self.tick_wall_s.clear()
        self.ttft_decomp.clear()
        self.done, self.token_log = [], []
        self.memscope.reset()
        self._slot_last_rid = [None] * self.max_slots
        self.mem_leak = None
        self._t0 = time.perf_counter()

    def warm_prefill_starts(self, starts) -> None:
        """Capture start-offset prefill programs OFF the clock.  Each runs one
        all-padding batch on the engine's pool: every write lands on the
        trash page, no engine state changes."""
        B = self.prefill_batch
        for start in sorted({int(s) for s in starts}):
            if not 0 < start < self.max_prompt_len:
                continue  # 0 is the base program warmup() already ran
            self._prefill_at(start)(
                self.params, self.pool,
                torch.zeros((B, self.max_prompt_len), dtype=torch.int32),
                torch.zeros((B,), dtype=torch.int32),
                torch.full((B,), start, dtype=torch.int32),
                torch.full((B,), -1, dtype=torch.int32),
                self._noise(B),
            )
        # the captures ran after warmup() reset _t0: re-zero the wall clock
        self._t0 = time.perf_counter()

    def _advance(self, dt: float) -> None:
        if self.clock == "virtual":
            self._vtime += dt

    # ---- admission -----------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        return -(-(req.prompt_len + req.max_new_tokens) // self.page_len)

    def _reserved_total(self) -> int:
        return sum(self._reserved)

    def make_request(self, prompt, max_new_tokens: int,
                     arrival_t: float | None = None) -> Request:
        rid = self._next_rid
        self._next_rid += 1
        return Request(rid=rid, prompt=list(map(int, prompt)),
                       max_new_tokens=int(max_new_tokens),
                       arrival_t=self.now() if arrival_t is None else arrival_t)

    def submit(self, req: Request) -> str | None:
        """Admission control at the door.  Returns None on acceptance
        (queued), else the rejection reason (also counted)."""
        self._tl("serve_submit", rid=req.rid, prompt_len=req.prompt_len,
                 max_new=req.max_new_tokens, arrival_t=round(req.arrival_t, 6))
        reason = None
        total = req.prompt_len + req.max_new_tokens
        if self.draining:
            reason = REJECT_DRAINING
        elif req.prompt_len < 1 or req.max_new_tokens < 1:
            # an empty prompt would decode from the zero logits buffer
            reason = REJECT_BAD_REQUEST
        elif req.prompt_len > self.max_prompt_len:
            # over the prefill program's STATIC prompt width: no program of
            # this engine can run it
            reason = REJECT_BAD_REQUEST
        elif total > self.max_seq_len:
            reason = REJECT_TOO_LONG
        elif self._pages_needed(req) > self.n_pages:
            reason = REJECT_POOL_EXHAUSTED
        elif len(self.queue) >= self.max_queue:
            reason = REJECT_QUEUE_FULL
        elif self.token_budget is not None and (
            sum(r.prompt_len + r.max_new_tokens for r in self.queue) + total
            > self.token_budget
        ):
            reason = REJECT_TOKEN_BUDGET
        if reason is not None:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
            self._tl("serve_reject", rid=req.rid, reason=reason)
            return reason
        self.queue.append(req)
        return None

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _committed_pages(self) -> int:
        """Worst-case pages spoken for: live-slot reservations plus every
        page the prefix cache holds."""
        held = self.prefix.held_pages if self.prefix is not None else 0
        return self._reserved_total() + held

    def _pinned_pages(self) -> set[int]:
        """Cached pages eviction must not touch: shared into a live slot's
        table or claimed out of one."""
        pinned: set[int] = set()
        for pages in self._adopted_pages:
            pinned.update(pages)
        for pages in self._cached_pages:
            pinned.update(pages)
        return pinned

    def _evict_for(self, shortfall: int, protect: set[int]) -> int:
        """LRU-evict cached pages to free ``shortfall`` pool pages; returns
        how many were freed (0 when the evictable set is too small)."""
        assert self.prefix is not None
        pinned = self._pinned_pages() | protect
        if self.prefix.evictable_pages(pinned) < shortfall:
            return 0
        evicted = self.prefix.evict(shortfall, pinned)
        if evicted:
            pages = np.full((self.n_pages,), -1, np.int32)
            pages[: len(evicted)] = evicted
            self._pool_op(kv_pages.unref_pages, pages)
        return len(evicted)

    def _match(self, req: Request) -> Match:
        if self.prefix is None:
            return Match()
        return self.prefix.match(req.prompt)

    def _scan_start(self, m: Match) -> int:
        """The program offset a match rides: the page-aligned floor of its
        matched length."""
        return (m.matched // self.page_len) * self.page_len

    def _admittable(self) -> list[tuple[int, Request, Match]]:
        """(slot, request, prefix-match) triples the scheduler can admit now:
        bounded by free slots, the prefill width and the pool's uncommitted
        pages (only the SUFFIX pages of a matched request count).  Batches
        are homogeneous in their page-aligned match, so a batch rides one
        start-offset program; when pages are short, LRU eviction of unpinned
        cached pages runs before backpressure."""
        if self.draining:
            return []
        if self.admission == "static" and any(r is not None for r in self.slots):
            return []  # static batching: wait for the batch to drain
        free = self._free_slots()
        budget = self.n_pages - self._committed_pages()
        out: list[tuple[int, Request, Match]] = []
        protect: set[int] = set()
        while self.queue and free and len(out) < self.prefill_batch:
            m = self._match(self.queue[0])
            if out and self._scan_start(m) != self._scan_start(out[0][2]):
                break  # next batch: different start offset
            # under spec the prefix discount is forfeit at the bill (the
            # adoption and the prefill it saves still happen): the drafter
            # pool shares nothing, so a slot costs it the full worst case,
            # and that one bill covers both pools
            need = self._pages_needed(self.queue[0]) - (0 if self.spec_k else m.n_ref)
            if need > budget:
                if self.prefix is None:
                    break  # head-of-line blocks until pages free
                got = self._evict_for(
                    need - budget,
                    protect | set(m.pages) | ({m.cow_src} if m.cow_src >= 0 else set()),
                )
                if got < need - budget:
                    break  # backpressure: nothing evictable enough
                budget += got
            req = self.queue.popleft()
            slot = free.pop(0)
            budget -= need
            protect.update(m.pages)
            if m.cow_src >= 0:
                protect.add(m.cow_src)
            out.append((slot, req, m))
        return out

    # ---- the scheduler iteration ---------------------------------------

    def _adopt_batch(self, batch: list[tuple[int, Request, Match]]) -> None:
        """Seat every matched prefix before the suffix prefill (full pages by
        reference, the partial tail page as a copy) and bill the adopted
        pages to the host mirror in the same method."""
        for slot, _req, m in batch:
            self._adopted_pages[slot] = list(m.pages)
        if not any(m.matched for _, _, m in batch):
            return
        B = self.prefill_batch
        slots = np.full((B,), -1, np.int32)
        adopt = np.full((B, self.pages_per_seq), -1, np.int32)
        cow = np.full((B,), -1, np.int32)
        for row, (slot, _req, m) in enumerate(batch):
            slots[row] = slot
            adopt[row, : m.n_ref] = m.pages
            cow[row] = m.cow_src
        (ok,) = self._pool_op(kv_pages.adopt_prefix, slots, adopt, cow)
        if not bool(ok):
            self.pool_ok_failures += 1

    def _insert_prefixes(self, batch: list[tuple[int, Request, Match]]) -> None:
        """Index the just-prefilled prompts in the radix tree and take the
        cache's device references on every NEWLY claimed page; those pages
        move from the slot's bill to the cache's."""
        assert self.prefix is not None
        table = self.pool["page_table"].cpu().numpy()
        claimed: list[int] = []
        for slot, req, _m in batch:
            new_pages = self.prefix.insert(req.prompt, table[slot])
            claimed.extend(new_pages)
            self._cached_pages[slot] = new_pages
            n_new = len(new_pages)
            if self.slots[slot] is None:  # completed at its first token
                self._pending_pages[slot] = max(0, self._pending_pages[slot] - n_new)
            else:
                self._reserved[slot] = max(0, self._reserved[slot] - n_new)
        if claimed:
            pages = np.full((self.pages_per_seq * self.prefill_batch,), -1, np.int32)
            pages[: len(claimed)] = claimed
            self._pool_op(kv_pages.ref_pages, pages)

    def _run_prefill(self, batch: list[tuple[int, Request, Match]]) -> None:
        B = self.prefill_batch
        # the program starts at the PAGE-ALIGNED floor of the batch's matched
        # length; rows replay the [start, matched) gap with writes masked
        start = self._scan_start(batch[0][2])
        prompts = np.zeros((B, self.max_prompt_len), np.int32)
        lens = np.zeros((B,), np.int32)
        starts = np.zeros((B,), np.int32)
        slot_ids = np.full((B,), -1, np.int32)
        for row, (slot, req, m) in enumerate(batch):
            prompts[row, : req.prompt_len] = req.prompt
            lens[row] = req.prompt_len
            starts[row] = m.matched
            slot_ids[row] = slot
        # TTFT decomposition stamp: the moment this batch left the queue
        t_pre = self.now()
        for slot, req, _m in batch:
            self._tl("serve_admit", rid=req.rid, slot=slot)
        self._adopt_batch(batch)
        prefill = self._prefill_at(start)
        t0 = time.perf_counter()
        with _spans.span("serve.prefill", cat="serve", batch=len(batch), start=start):
            self.pool, first, ok = prefill(
                self.params, self.pool, torch.from_numpy(prompts), torch.from_numpy(lens),
                torch.from_numpy(starts), torch.from_numpy(slot_ids), self._noise(B))
            first = first.tolist()
            ok = bool(ok)
        if not ok:
            self.pool_ok_failures += 1
        if self.spec_k:
            # the drafter prefills its OWN pool over the same batch, always
            # from position 0 (the radix cache shares target pages only);
            # its sampled token is discarded
            with _spans.span("serve.draft_prefill", cat="serve", batch=len(batch)):
                self.draft_pool, _first, ok_d = self._draft_prefill(
                    self.draft_params, self.draft_pool, torch.from_numpy(prompts),
                    torch.from_numpy(lens), torch.zeros((B,), dtype=torch.int32),
                    torch.from_numpy(slot_ids), None)
                if not bool(ok_d):
                    self.pool_ok_failures += 1
        wall = time.perf_counter() - t0
        self._prefills += 1
        # the virtual clock charges prefill for the positions it ran, and
        # the drafter's full-prompt pass at its FLOP ratio
        prefill_cost = (self.tick_s * (self.max_prompt_len - start) / self.max_prompt_len
                        if self.clock == "virtual" else wall)
        self._advance(self.tick_s * (self.max_prompt_len - start) / self.max_prompt_len)
        if self.spec_k:
            self._advance(self.tick_s * self.spec_flop_ratio)
        now = self.now()
        for row, (slot, req, m) in enumerate(batch):
            req.admitted_t = now
            req.prefill_start_t = t_pre
            req.prefill_s = prefill_cost
            self.slots[slot] = req
            self._slot_last_rid[slot] = req.rid
            self._cached_pages[slot] = []
            # the admission bill's mirror: the full worst case under spec
            self._reserved[slot] = self._pages_needed(req) - (0 if self.spec_k else m.n_ref)
            self.admitted += 1
            if self.prefix is not None:
                self.prefix.lookups += 1
                if m.matched > 0:
                    self.prefix.hits += 1
                    self.prefix.hit_tokens += m.matched
            # saved = the positions actually skipped (the aligned floor)
            self.prefill_tokens_saved += start
            self.prefill_flops_saved += start * self._flops_per_token
            # the drafter owes this first committed token its KV
            self._pending[slot] = [int(first[row])]
            req.first_token_t = now
            ttft = now - req.arrival_t
            self.ttft_s.append(ttft)
            queue_wait = t_pre - req.arrival_t
            first_decode = now - t_pre - prefill_cost
            self.ttft_decomp.append((queue_wait, prefill_cost, first_decode))
            self._tl("serve_prefill", rid=req.rid, slot=slot, start=start,
                     prefix_hit_tokens=int(m.matched), wall_s=round(wall, 6))
            self._tl("serve_first_token", rid=req.rid, ttft_s=round(ttft, 6),
                     queue_wait_s=round(queue_wait, 6), prefill_s=round(prefill_cost, 6),
                     first_decode_s=round(first_decode, 6))
            self._emit_token(slot, req, int(first[row]), now)
        if self.prefix is not None:
            self._insert_prefixes(batch)
        self._track_pages()
        flight.record(kind="serve_prefill", step=self._prefills, wall_s=round(wall, 6),
                      admitted=len(batch), queue=len(self.queue),
                      **({"prefix_start": start} if start else {}))

    def _emit_token(self, slot: int, req: Request, tok: int, now: float) -> None:
        req.tokens.append(tok)
        self._slot_last_tok[slot] = tok
        self.generated_tokens += 1
        if (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)):
            req.done_t = now
            self.completed += 1
            self.done.append(req)
            self._tl("serve_done", rid=req.rid, tokens=len(req.tokens))
            self.slots[slot] = None
            self._reserved[slot] = 0
            self._release_mask[slot] = True
            # the device keeps this sequence's pages until the release
            # flush; mirror only the slot's EXCLUSIVE pages
            written = req.prompt_len + len(req.tokens) - 1
            self._pending_pages[slot] = self._slot_fresh_pages(slot, written)

    def _run_decode_tick(self) -> None:
        toks = torch.tensor(self._slot_last_tok, dtype=torch.int32)
        t0 = time.perf_counter()
        with _spans.span("serve.decode_tick", cat="serve",
                         active=sum(r is not None for r in self.slots)):
            self.pool, new_tok, ok = self._tick(self.params, self.pool, toks,
                                                self._noise(self.max_slots))
            new_tok = new_tok.tolist()
            ok = bool(ok)
        wall = time.perf_counter() - t0
        if not ok:
            self.pool_ok_failures += 1
        self.tick_wall_s.append(wall)
        self._ticks += 1
        self._advance(self.tick_s)
        now = self.now()
        for slot, req in enumerate(self.slots):
            if req is not None:
                self._emit_token(slot, req, int(new_tok[slot]), now)
        self._track_pages()
        if self._ticks % 8 == 0 or self._ticks <= 2:
            flight.record(kind="serve_tick", step=self._ticks, wall_s=round(wall, 6),
                          active=sum(r is not None for r in self.slots),
                          queue=len(self.queue), pages_used=self._host_pages_used())

    def _run_spec_round(self) -> None:
        """One speculative round over every active slot: the drafter
        proposes ``spec_k`` tokens on its own pool, one verify pass scores
        all ``spec_k + 1`` positions, the accepted prefix commits (each
        accepted draft is the target's argmax, the first rejection is
        replaced by it, a full accept earns the bonus token) and both pools
        roll back to the committed frontier.  Greedy acceptance makes the
        stream exactly the sequential engine's.  The virtual clock charges
        1 tick for the verify pass plus ``flop_ratio`` per drafter step."""
        k, S = self.spec_k, self.max_slots
        ctx = np.zeros((S, 2), np.int32)
        n_ctx = np.zeros((S,), np.int32)
        limits = np.zeros((S,), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            pend = self._pending[slot]
            assert 1 <= len(pend) <= 2, (slot, pend)
            ctx[slot, : len(pend)] = pend
            n_ctx[slot] = len(pend)
            # the last position a non-speculative decode writes for this
            # request: later writes trash-route, inside the admission bill
            limits[slot] = req.prompt_len + req.max_new_tokens - 1
        # the (k+1)-step draft only serves 2-token catch-up rounds (after a
        # full accept); the clock bills the steps the program ran
        steps = k + 1 if int(n_ctx.max(initial=0)) > 1 else k
        draft = self._draft_k1 if steps == k + 1 else self._draft_k
        lim = torch.from_numpy(limits)
        last = torch.tensor(self._slot_last_tok, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        with _spans.span("serve.draft", cat="serve", steps=steps):
            self.draft_pool, drafts_dev, ok_d = draft(
                self.draft_params, self.draft_pool, torch.from_numpy(ctx),
                torch.from_numpy(n_ctx), lim)
        # the verify window is assembled ON THE DEVICE from the draft
        # program's output: no host sync between draft and verify, one copy
        # of drafts and greedy to the host after both
        toks = torch.cat([last[:, None], drafts_dev], dim=1)
        with _spans.span("serve.verify", cat="serve"):
            self.pool, greedy_dev, ok_v = self._verify(self.params, self.pool, toks, lim)
            host = torch.cat([drafts_dev, greedy_dev], dim=1).cpu().numpy()
        drafts, greedy = host[:, :k], host[:, k:]  # [S, k], [S, k+1]
        wall = time.perf_counter() - t0
        if not bool(ok_d):
            self.pool_ok_failures += 1
        if not bool(ok_v):
            self.pool_ok_failures += 1
        self.tick_wall_s.append(wall)
        self._spec_rounds += 1
        # a round is the engine's decode-family pass: it counts as a tick
        self._ticks += 1
        self._draft_steps += steps
        self._advance(self.tick_s * (1.0 + steps * self.spec_flop_ratio))
        now = self.now()

        new_lens = np.zeros((S,), np.int32)
        mask = np.zeros((S,), bool)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            mask[slot] = True
            self.draft_tokens_proposed += k
            # the accepted prefix: draft i is the target's own choice iff it
            # equals greedy[i]
            a = 0
            while a < k and drafts[slot, a] == greedy[slot, a]:
                a += 1
            self.spec_accept_counts[a] = self.spec_accept_counts.get(a, 0) + 1
            # committed token t0 sits at position p0; each emission extends
            # the written frontier by one
            p0 = req.prompt_len + len(req.tokens) - 1
            emitted = 0
            for j in range(a + 1):
                self._emit_token(slot, req, int(greedy[slot, j]), now)
                emitted += 1
                if self.slots[slot] is None:
                    break  # max_new or EOS inside the window
            self.draft_tokens_accepted += min(a, emitted)
            self._tl("serve_spec_round", rid=req.rid, round=self._spec_rounds, accepted=a,
                     rejected=k - a, emitted=emitted)
            new_lens[slot] = p0 + emitted
            if self.slots[slot] is not None:
                if emitted == k + 1:
                    # full accept: the drafter never wrote its final draft,
                    # and the bonus token is new to it
                    self._pending[slot] = [int(drafts[slot, k - 1]), int(greedy[slot, k])]
                else:
                    self._pending[slot] = [int(greedy[slot, emitted - 1])]
        # roll BOTH pools back to the committed frontier: rejected
        # positions' pages return to the free set, stale values in kept
        # pages are overwritten before they become readable
        new_lens_t, mask_t = torch.from_numpy(new_lens), torch.from_numpy(mask)
        self.pool, = self._truncate(self.params, self.pool, new_lens_t, mask_t)
        self.draft_pool, = self._draft_truncate(self.draft_params, self.draft_pool,
                                                new_lens_t, mask_t)
        self._track_pages()
        if self._spec_rounds % 8 == 0 or self._spec_rounds <= 2:
            flight.record(kind="serve_spec", step=self._spec_rounds, wall_s=round(wall, 6),
                          active=int(mask.sum()), draft_steps=steps,
                          accepted=self.draft_tokens_accepted,
                          proposed=self.draft_tokens_proposed, queue=len(self.queue),
                          pages_used=self._host_pages_used())

    def _slot_fresh_pages(self, slot: int, written: int) -> int:
        """Pages slot ``slot`` holds EXCLUSIVELY after writing ``written``
        positions: its table entries so far, less the prefix pages it shares
        and the own-prompt pages the cache claimed (billed under the cache)."""
        entries = min(-(-written // self.page_len) if written > 0 else 0, self.pages_per_seq)
        shared = len(self._adopted_pages[slot]) + len(self._cached_pages[slot])
        return max(entries - shared, 0)

    def _host_pages_used(self) -> int:
        """Exact host mirror of the device free mask: pages each slot has
        allocated so far plus every page the prefix cache references.  The
        newest sampled token is not yet written, so an active slot's written
        positions are ``prompt + generated - 1``; completed slots keep their
        pages until the release flush."""
        used = self.prefix.held_pages if self.prefix is not None else 0
        for slot, req in enumerate(self.slots):
            if req is None:
                used += self._pending_pages[slot]
                continue
            written = req.prompt_len + max(len(req.tokens) - 1, 0)
            used += self._slot_fresh_pages(slot, written)
        return used

    def _track_pages(self) -> None:
        self.peak_pages = max(self.peak_pages, self._host_pages_used())

    def _flush_releases(self) -> None:
        if not any(self._release_mask):
            return
        mask = torch.tensor(self._release_mask, dtype=torch.bool)
        self.pool, = self._release(self.params, self.pool, mask)
        if self.spec_k:  # the drafter's slot returns its pages in the same flush
            self.draft_pool, = self._draft_release(self.draft_params, self.draft_pool, mask)
        for slot, flushed in enumerate(self._release_mask):
            if flushed:  # the slot stops pinning its shared pages
                self._adopted_pages[slot] = []
                self._cached_pages[slot] = []
                self._pending[slot] = []
        self._release_mask = [False] * self.max_slots
        self._pending_pages = [0] * self.max_slots

    # ---- elastic handoff -----------------------------------------------

    def begin_drain(self) -> list[Request]:
        """Stop admitting and hand back every request still queued (never
        admitted: no tokens, no pages) for re-admission elsewhere; the live
        slots run to completion (:attr:`drained`)."""
        self.draining = True
        handoff = list(self.queue)
        self.queue.clear()
        self._tl("serve_drain", requeued=len(handoff))
        return handoff

    @property
    def drained(self) -> bool:
        """True once every slot is released and nothing is queued."""
        return all(r is None for r in self.slots) and not self.queue

    def step(self) -> bool:
        """One scheduler iteration: flush releases, admit + prefill, then one
        packed decode tick.  Returns True when any program ran."""
        ran = False
        self._flush_releases()
        self.queue_depths.append(len(self.queue))
        batch = self._admittable()
        if batch:
            self._run_prefill(batch)
            ran = True
        # a request that completed DURING prefill must not ride through the
        # decode tick with its device slot still active
        self._flush_releases()
        if any(r is not None for r in self.slots):
            if self.spec_k:
                self._run_spec_round()
            else:
                self._run_decode_tick()
            ran = True
        self.token_log.append((self.now(), self.generated_tokens))
        self._mem_sample()
        if self._sanitize:
            _sanitizer.check_serve_mirror(self)
        return ran

    def _mem_sample(self) -> None:
        """One memory observation per scheduler iteration: live bytes and
        host RSS into the scope's series, pool occupancy, queue depth and
        tokens/s on the timeline's ``mem_sample`` event.  The occupancy is
        the exact host mirror: nothing waits for the card.  Gated as
        :meth:`_tl` is: no trace label (the A/B arms) or obs off samples
        nothing."""
        if self.trace_label is None or not _memscope.enabled():
            return
        wall = self.now()
        self.memscope.sample(
            self._ticks, vt=wall, engine=self.trace_label, replica=self.replica_id,
            pool_used=self._host_pages_used(), pool_pages=self.n_pages,
            queue_depth=len(self.queue),
            tokens_per_s=round(self.generated_tokens / wall, 3) if wall > 0 else 0.0)

    # ---- memory --------------------------------------------------------

    def _bytes(self, tensors, per_chip: bool = True) -> int:
        """Bytes of ``tensors`` as one rank holds them, or (``per_chip=False``)
        as the whole axis does: a tensor split over it counts ``tp`` times."""
        return sum(t.numel() * t.element_size()
                   * (1 if per_chip or id(t) not in self._split else self.tp) for t in tensors)

    def _param_bytes(self, per_chip: bool = True) -> int:
        """Parameter bytes, the drafter's counted again as JAX counts them
        (its tensors are views of the target's)."""
        models = [self.params] + ([self.draft_params] if self.spec_k else [])
        return self._bytes([p for m in models for p in m.parameters()], per_chip)

    def _pool_bytes(self, per_chip: bool = True) -> int:
        pools = [self.pool] + ([self.draft_pool] if self.spec_k else [])
        return self._bytes([t for pool in pools for t in pool.values()], per_chip)

    @property
    def streams(self) -> int:
        """The CUDA streams this engine's programs run on: the caller's and,
        graphed, the capture stream (each may hold one cuBLAS workspace)."""
        return 2 if self._graphs and self.device.type == "cuda" else 1

    def mem_budget_bytes(self, per_chip: bool = True) -> int:
        """The engine's static memory bill: parameters + page pool (+ the
        drafter's parameters and pool under spec), from shapes and dtypes.
        ``per_chip=True`` bills what this rank holds resident (a TP shard's
        slices and head-split pool, or its ZeRO-3 rows; replicated leaves
        whole); ``per_chip=False`` the whole axis's logical bill, which
        sharding does not change (the rows' padding aside).  At ``tp=1`` the
        two are equal.  A streamed layer in flight is transient, not billed."""
        return self._param_bytes(per_chip) + self._pool_bytes(per_chip)

    def mem_pool_snapshot(self) -> dict[str, Any]:
        """Pool telemetry (occupancy, cache-vs-table split, refcount
        histogram, fragmentation) — a small host transfer."""
        held = self.prefix.held_pages if self.prefix is not None else 0
        return _memscope.pool_snapshot(self.pool, cache_held=held)

    def mem_leak_check(self) -> dict[str, Any]:
        """The drain-time leak detector: flush pending releases, then require
        the pool to hold EXACTLY its cache-held pages; residue is attributed
        page by page and kept on :attr:`mem_leak`."""
        self._flush_releases()
        held = self.prefix.held_pages if self.prefix is not None else 0
        out = _memscope.pool_leak_check(self.pool, cache_held_pages=held,
                                        slot_rids=self._slot_last_rid)
        if self.spec_k:
            draft = _memscope.pool_leak_check(self.draft_pool, cache_held_pages=0,
                                              slot_rids=self._slot_last_rid)
            out["draft"] = draft
            out["ok"] = out["ok"] and draft["ok"]
            out["leaked_pages"] += draft["leaked_pages"]
        if not out["ok"]:
            flight.record(kind="mem", source="kv_pool_leak",
                          leaked_pages=out["leaked_pages"], leaks=out["leaks"][:8])
        self.mem_leak = out
        return out

    def retire(self) -> None:
        """Give back this engine's device memory (a drained elastic replica):
        drop both pools and every captured program -- its graph, the graph's
        private memory pool, its static inputs and outputs.  The host
        counters and finished requests stay readable; the engine serves no
        more."""
        self.pool = self.draft_pool = None
        programs = [self._tick, self._release, *self._prefill_programs.values()]
        if self.spec_k:
            programs += [self._draft_k, self._draft_k1, self._verify, self._draft_prefill,
                         self._truncate, self._draft_truncate, self._draft_release]
        for prog in programs:
            prog.drop()

    def tokens_at(self, t: float) -> int:
        """Cumulative generated tokens delivered by time ``t`` (engine
        clock) — the A/B's fixed-budget readout."""
        out = 0
        for when, n in self.token_log:
            if when > t:
                break
            out = n
        return out

    # ---- open-loop run -------------------------------------------------

    def run(self, trace: list[dict], *, budget_s: float | None = None,
            max_steps: int | None = None) -> dict[str, Any]:
        """Drive the engine under an open-loop arrival trace (entries ``{"t",
        "prompt", "max_new"}``): arrivals are submitted when their time comes
        whether or not the engine kept up; the run ends at ``budget_s``,
        after ``max_steps`` iterations, or when everything arrived, drained
        and completed.  Returns :meth:`metrics`."""
        arrivals = sorted(trace, key=lambda r: r["t"])
        i = 0
        steps = 0
        while True:
            now = self._agreed_now()
            if budget_s is not None and now >= budget_s:
                break
            if max_steps is not None and steps >= max_steps:
                break
            while i < len(arrivals) and arrivals[i]["t"] <= now:
                a = arrivals[i]
                self.submit(self.make_request(a["prompt"], a["max_new"], arrival_t=a["t"]))
                i += 1
            if not self.queue and all(r is None for r in self.slots):
                if i >= len(arrivals):
                    break  # drained
                gap = arrivals[i]["t"] - now
                if self.clock == "virtual":
                    self._vtime = arrivals[i]["t"]
                else:
                    time.sleep(min(max(gap, 0.0), 0.05))
                continue
            self.step()
            steps += 1
        self.check_lockstep()
        return self.metrics(budget_s=budget_s)

    # ---- telemetry -----------------------------------------------------

    def ttft_decomp_cell(self) -> dict[str, Any]:
        """Per-request TTFT decomposition: queue_wait + prefill +
        first_decode (exact on the virtual clock)."""
        qs = [d[0] for d in self.ttft_decomp]
        ps = [d[1] for d in self.ttft_decomp]
        fs = [d[2] for d in self.ttft_decomp]

        def r(v):
            return None if v is None else round(v, 6)

        return {
            "clock": self.clock,
            "requests": self.ttft_decomp.count,
            "queue_wait_s_p50": r(_pct(qs, 50)),
            "queue_wait_s_p95": r(_pct(qs, 95)),
            "prefill_s_p50": r(_pct(ps, 50)),
            "prefill_s_p95": r(_pct(ps, 95)),
            "first_decode_s_p50": r(_pct(fs, 50)),
            "first_decode_s_p95": r(_pct(fs, 95)),
        }

    def metrics(self, budget_s: float | None = None) -> dict[str, Any]:
        """The ``telemetry.serve`` cell: throughput, tail latency, admission
        counters and pool occupancy — every key the BENCH contract (and
        ``tools/serve_report.py``) reads.  ``n_chips`` counts the cards the
        engine's ranks compute on (TP ranks that share one card count one);
        ``graphs`` says whether its programs run as CUDA graphs."""
        wall = self.now()
        from ddl25spring_tpu_torch.utils.mesh import cards_used

        n_chips = cards_used(self.tp, self.device.type)
        tok_lat = (self.tick_wall_s if self.clock == "wall"
                   else [self.tick_s] * max(self._ticks, 0))
        return {
            "admission": self.admission,
            "wall_s": round(wall, 4),
            **({"budget_s": budget_s} if budget_s is not None else {}),
            "ticks": self._ticks,
            "prefills": self._prefills,
            "admitted": self.admitted,
            "rejected": sum(self.rejected.values()),
            "rejected_by_reason": dict(self.rejected),
            "completed": self.completed,
            "generated_tokens": self.generated_tokens,
            "tokens_per_sec": round(self.generated_tokens / wall, 3) if wall > 0 else None,
            "tokens_per_sec_per_chip": (round(self.generated_tokens / wall / n_chips, 3)
                                        if wall > 0 else None),
            "n_chips": n_chips,
            "ttft_s_p50": _pct(self.ttft_s, 50),
            "ttft_s_p95": _pct(self.ttft_s, 95),
            "ttft_decomp": self.ttft_decomp_cell(),
            "tok_latency_s_p50": _pct(tok_lat, 50),
            "tok_latency_s_p95": _pct(tok_lat, 95),
            "queue_depth_max": self.queue_depths.max if self.queue_depths.count else 0,
            "queue_depth_p50": _pct(self.queue_depths, 50),
            "host_samples": {
                "ttft_s": self.ttft_s.summary(),
                "queue_depths": self.queue_depths.summary(),
                "tick_wall_s": self.tick_wall_s.summary(),
            },
            "page_pool_pages": self.n_pages,
            "page_pool_peak_pages": self.peak_pages,
            "page_pool_peak_occupancy": round(self.peak_pages / self.n_pages, 4),
            "pool_ok_failures": self.pool_ok_failures,
            "tp": self.tp,
            "weight_stream": self.weight_stream,
            "pool_bytes_per_chip": self._pool_bytes(),
            "param_bytes_per_chip": self._param_bytes(),
            "prefix_hit_rate": (self.prefix.stats()["hit_rate"]
                                if self.prefix is not None else None),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_flops_saved": self.prefill_flops_saved,
            "prefix": self.prefix.stats() if self.prefix is not None else {"enabled": False},
            "acceptance_rate": (round(self.draft_tokens_accepted / self.draft_tokens_proposed, 4)
                                if self.draft_tokens_proposed else None),
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "draft_tokens_rejected": self.draft_tokens_proposed - self.draft_tokens_accepted,
            "spec": {
                "enabled": True,
                "k": self.spec_k,
                "draft_layers": self.draft_cfg.n_layers,
                "draft_dim": self.draft_cfg.dmodel,
                "flop_ratio": round(self.spec_flop_ratio, 4),
                "rounds": self._spec_rounds,
                "draft_steps": self._draft_steps,
                "verify_steps": self._spec_rounds,
                "draft_tokens_proposed": self.draft_tokens_proposed,
                "draft_tokens_accepted": self.draft_tokens_accepted,
                "accept_counts": {str(a): n for a, n in sorted(self.spec_accept_counts.items())},
            } if self.spec_k else {"enabled": False},
            "config": {
                "page_len": self.page_len,
                "pages_per_seq": self.pages_per_seq,
                "max_slots": self.max_slots,
                "prefill_batch": self.prefill_batch,
                "max_prompt_len": self.max_prompt_len,
                "max_queue": self.max_queue,
                "token_budget": self.token_budget,
                "clock": self.clock,
                "prefix_cache": self.prefix is not None,
                "spec_k": self.spec_k,
                "tp": self.tp,
                "weight_stream": self.weight_stream,
                "graphs": self._graphs and self.device.type == "cuda",
            },
        }
