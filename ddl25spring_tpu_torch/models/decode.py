"""Autoregressive generation with a KV cache for the LLaMA stack: the
counterpart of the JAX package's ``models/decode.py``.

- the KV cache is ONE stacked tensor pair ``[n_layers, B, max_len, H, hd]``,
  written in place at each step's position (JAX: ``dynamic_update_slice``
  on a donated carry);
- each step is a ``[B, 1]``-token pass over all layers; prefill feeds the
  prompt through the same cached step, one position at a time;
- greedy (``temperature=0``) or temperature sampling with ``top_k`` /
  ``top_p`` filters, drawing from an explicit ``torch.Generator``.

Equivalence oracle (``tests/test_torch_decode.py``): greedy generation
reproduces ``argmax(llama_forward(prompt + generated_so_far)[:, -1])`` at
every position in fp32 dense-attention configs, and the JAX package's
``generate`` token for token.  MoE decode runs at ample capacity (C >= B
top_k), so it never drops a token.

Kept divergence: sampled tokens come from ``torch.Generator`` streams,
which differ from ``jax.random``'s; the filtered logits (:func:`filter_logits`)
are the JAX ones, and the draw is the Gumbel-max of
``jax.random.categorical``.

Tensor parallelism (``tp_axis``, an :class:`~ddl25spring_tpu_torch.parallel.
comm.Axis`): the Megatron layout of :mod:`~ddl25spring_tpu_torch.parallel.tp`
(column slices of ``wq``/``wk``/``wv``/``w_gate``/``w_up``, row slices of
``wo``/``w_down``), the KV cache holding the rank's heads, and the two
row-parallel products of each block summed over the axis in ``cfg.dtype``
(JAX's ``psum``s).  ``shard_vocab`` adds the vocab-sharded embedding and one
all-gather of the logits.  Every rank of the axis samples the same stream:
its logits are the same bits after the sums, and its generator is seeded
alike.  :func:`make_tp_generate` is the entry point.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import ep
from ddl25spring_tpu_torch.parallel.comm import all_gather, reduce_out
from ddl25spring_tpu_torch.utils.config import LlamaConfig


def resolve_heads(cfg: LlamaConfig, num_heads: int | None) -> int:
    """The per-shard head count a KV cache is shaped with: ``num_heads``
    overrides the config.  An explicit non-positive override raises instead
    of falling back to ``cfg.num_heads``.  Shared by both cache layouts (the
    dense slab below and :mod:`ddl25spring_tpu_torch.serve.kv_pages`' page
    pool), so they validate identically."""
    if num_heads is None:
        return cfg.num_heads
    if num_heads <= 0:
        raise ValueError(
            f"num_heads={num_heads}: a head-count override must be a "
            "positive per-shard count (pass None to use cfg.num_heads)"
        )
    return num_heads


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  num_heads: int | None = None, device=None):
    """``(k, v)`` stacked over layers: ``[L, B, max_len, H, hd]`` in
    ``cfg.dtype``; explicit non-positive ``num_heads`` raise
    (:func:`resolve_heads`)."""
    shape = (cfg.n_layers, batch, max_len, resolve_heads(cfg, num_heads), cfg.head_dim)
    dtype = llama._dtype(cfg)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def embed_tokens(model: llama.Llama, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """:func:`~ddl25spring_tpu_torch.models.llama.embed` with JAX's gather
    semantics made explicit (a request's ids are not checked against the
    vocab): an id past the vocab reads the last row, a negative id wraps once
    and clamps.  Torch would raise, and CUDA assert."""
    V = cfg.vocab_size
    t = tokens.long()
    return llama.embed(model, torch.where(t < 0, t + V, t).clamp(0, V - 1), cfg)


def _block_decode(p, x, k_cache, v_cache, pos, cos, sin, cfg: LlamaConfig,
                  tp_axis=None):
    """One block on a single-token slice ``x [B, 1, D]`` against the layer's
    cache ``[B, max_len, H, hd]``, which it writes at ``pos`` in place;
    returns ``(x, k_cache, v_cache)``.  The attention follows the training
    path's dtype policy (products in ``cfg.dtype``, float32 softmax), so
    fp32 configs match the full forward.

    ``tp_axis``: ``p`` holds this rank's Megatron slices (its heads fall out
    of the reshape) and the cache its heads; the attention output and the
    FFN output are each summed over the axis, in ``cfg.dtype``."""
    dtype = llama._dtype(cfg)
    B = x.shape[0]
    hd = cfg.head_dim
    max_len = k_cache.shape[1]

    h = llama.rms_norm(x, p.ln1)
    q = (h @ p.wq.to(dtype)).view(B, 1, -1, hd)
    k = (h @ p.wk.to(dtype)).view(B, 1, -1, hd)
    v = (h @ p.wv.to(dtype)).view(B, 1, -1, hd)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]

    s = torch.einsum("bqhd,bmhd->bhqm", q, k_cache).float() / math.sqrt(hd)
    live = torch.arange(max_len, device=x.device) <= pos
    s = s.masked_fill(~live[None, None, None, :], -1e30)
    probs = torch.softmax(s, dim=-1).to(dtype)
    attn = torch.einsum("bhqm,bmhd->bqhd", probs, v_cache)
    x = x + _psum(attn.reshape(B, 1, -1) @ p.wo.to(dtype), tp_axis)

    h = llama.rms_norm(x, p.ln2)
    if cfg.n_experts > 0:
        # ample decode-time capacity: a drop would zero a token's FFN
        E = p.moe["router"].shape[1]
        if tp_axis is not None:
            from ddl25spring_tpu_torch.parallel.tp import make_tp_moe_fn

            # global routing on every rank, its expert slice, a partial
            # combine the sum below completes
            moe_fn = make_tp_moe_fn(tp_axis, capacity_factor=float(E), top_k=cfg.moe_top_k)
        else:
            def moe_fn(mp, t):
                return ep.moe_ffn(mp, t, capacity_factor=float(E), top_k=cfg.moe_top_k)
        y, _ = moe_fn(p.moe, h.reshape(B, -1))
        ffn_out = y.reshape(B, 1, -1).to(dtype)
    else:
        gate = F.silu(h @ p.w_gate.to(dtype))
        ffn_out = (gate * (h @ p.w_up.to(dtype))) @ p.w_down.to(dtype)
    return x + _psum(ffn_out, tp_axis), k_cache, v_cache


def _psum(x: torch.Tensor, tp_axis) -> torch.Tensor:
    """``x`` summed over ``tp_axis`` in its own dtype (JAX's ``lax.psum``);
    ``x`` itself without one."""
    return x if tp_axis is None else reduce_out(x, tp_axis)


def decode_step(model: llama.Llama, cache, tokens_t: torch.Tensor, pos: int,
                cfg: LlamaConfig, tp_axis=None, shard_vocab: bool = False):
    """One incremental step: ``tokens_t [B]`` at position ``pos`` (an int)
    -> ``(logits [B, V] float32, cache)``, the cache written in place.

    Under ``tp_axis`` with ``shard_vocab``, ``model.embed`` is the rank's
    ``[V/n, D]`` slice (one sum assembles the activations) and the head emits
    a ``[B, V/n]`` slice that one all-gather joins in index order: the full
    ``[B, V]`` logits, which sampling needs whole."""
    if shard_vocab and tp_axis is None:
        raise ValueError("shard_vocab needs a tp_axis to shard over")
    k_all, v_all = cache
    if shard_vocab:
        from ddl25spring_tpu_torch.parallel.tp import vocab_sharded_embed

        x = vocab_sharded_embed(model.embed, tokens_t[:, None].long(), tp_axis,
                                llama._dtype(cfg))
    else:
        x = embed_tokens(model, tokens_t[:, None], cfg)
    pos = int(pos)
    cos, sin = llama.rope_angles(
        1, cfg.head_dim,
        pos=torch.full((1,), pos, dtype=torch.float32, device=tokens_t.device))
    for li, block in enumerate(model.blocks):
        x, _, _ = _block_decode(block, x, k_all[li], v_all[li], pos, cos, sin, cfg,
                                tp_axis=tp_axis)
    logits = llama.unembed(model, x, cfg)[:, 0]
    if shard_vocab:
        # index i holds vocab columns [i V/n, (i+1) V/n)
        logits = all_gather(logits, tp_axis).permute(1, 0, 2).reshape(logits.shape[0], -1)
    return logits, (k_all, v_all)


def filter_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The float32 logits ``/ temperature`` with the entries ``top_k`` and
    ``top_p`` prune set to ``-inf`` (JAX ``sample_logits``' filters, k first,
    then p): ``top_k > 0`` keeps the k highest logits; ``top_p < 1`` keeps
    the smallest prefix of the probability-sorted vocab whose mass reaches
    ``top_p``, the highest-probability token always kept."""
    logits = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # mass BEFORE each entry; the first entry always survives (a top_p
        # of 0 gives cutoff 0, clamped to 1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        cutoff = (cum_before < top_p).sum(-1, keepdim=True).clamp_min(1)
        threshold = torch.gather(sorted_logits, -1, cutoff - 1)
        logits = logits.masked_fill(logits < threshold, -math.inf)
    return logits


def sample_from_uniform(logits: torch.Tensor, u: torch.Tensor, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Token ids ``[B]`` int32 from ``logits [B, V]`` and uniform noise ``u``
    of the same shape: greedy argmax at ``temperature=0`` (``u`` unused),
    else the Gumbel-max draw ``argmax(filtered + g)``, ``g = -log(-log u)``,
    which is ``jax.random.categorical``'s.  The serving programs take ``u``
    as an input buffer, so a CUDA graph replays eager's draws."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.float().clamp_min(tiny)))
    return (filter_logits(logits, temperature, top_k, top_p) + g).argmax(-1).to(torch.int32)


def uniform_noise(shape, key: torch.Generator, device) -> torch.Tensor:
    """Float32 uniforms in [0, 1) drawn from ``key`` (on ``key``'s device),
    placed on ``device``."""
    return torch.rand(shape, generator=key, dtype=torch.float32,
                      device=key.device).to(device)


def sample_logits(logits: torch.Tensor, key: torch.Generator | None,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0):
    """Sample token ids ``[B]`` int32 from ``logits [B, V]``:
    ``temperature=0`` is greedy argmax (``top_k``/``top_p`` ignored, no draw);
    otherwise one ``[B, V]`` draw of uniforms from the generator ``key`` and
    :func:`sample_from_uniform`."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    u = uniform_noise(logits.shape, key, logits.device)
    return sample_from_uniform(logits, u, temperature, top_k, top_p)


@torch.no_grad()
def generate(model: llama.Llama, prompt: torch.Tensor, cfg: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0,
             key: torch.Generator | None = None, max_len: int | None = None,
             top_k: int = 0, top_p: float = 1.0, tp_axis=None,
             shard_vocab: bool = False) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt [B, P]``:
    ``[B, max_new_tokens]`` int32.  ``temperature=0`` is greedy; otherwise
    softmax sampling at that temperature from the generator ``key`` (default:
    seed 0 on the prompt's device), optionally truncated by ``top_k`` /
    ``top_p`` (:func:`sample_logits`).

    ``tp_axis``/``shard_vocab``: ``model`` holds this rank's slices
    (:func:`~ddl25spring_tpu_torch.parallel.tp.load_tp_params`), the cache
    its heads; every rank returns the same tokens (:func:`make_tp_generate`)."""
    B, P = prompt.shape
    L_max = max_len or (P + max_new_tokens)
    if L_max < P + max_new_tokens:
        raise ValueError(
            f"max_len={L_max} < prompt {P} + max_new_tokens {max_new_tokens}: "
            "the cache would be written past its end"
        )
    if key is None and temperature != 0.0:
        key = torch.Generator(device=prompt.device).manual_seed(0)
    heads = model.blocks[0].wq.shape[-1] // cfg.head_dim
    cache = init_kv_cache(cfg, B, L_max, num_heads=heads, device=prompt.device)
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=prompt.device)
    for i in range(P):
        logits, cache = decode_step(model, cache, prompt[:, i], i, cfg, tp_axis, shard_vocab)
    out = []
    for j in range(max_new_tokens):
        tok = sample_logits(logits, key, temperature, top_k, top_p)
        logits, cache = decode_step(model, cache, tok, P + j, cfg, tp_axis, shard_vocab)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_tp_generate(cfg: LlamaConfig, mesh, max_new_tokens: int, model_axis: str = "model",
                     shard_vocab: bool = True, temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, max_len: int | None = None):
    """TP-sharded generation (JAX ``make_tp_generate``, ``decode.py:339``):
    ``gen(model, prompt, key=None) -> [B, max_new_tokens]`` on this rank of
    ``mesh``'s ``model_axis``.  ``model`` holds the rank's slices in the layout
    training produced (:func:`~ddl25spring_tpu_torch.parallel.tp.
    shard_tp_params` + :func:`~ddl25spring_tpu_torch.parallel.tp.
    load_tp_params`, vocab-sharded when ``shard_vocab``); the heads and the
    cache are split over the axis, and each step communicates the two
    row-parallel sums per block (plus, with ``shard_vocab``, the embedding's
    sum and one ``[B, V]`` all-gather of the logits).  Every rank runs the
    same sampling chain from ``key`` (seeded alike on every rank), so the
    tokens equal the single-process :func:`generate`'s."""
    axis = mesh.axis(model_axis)
    if cfg.num_heads % axis.size:
        raise ValueError(f"num_heads ({cfg.num_heads}) not divisible by "
                         f"{model_axis}={axis.size}")

    def gen(model, prompt, key: torch.Generator | None = None):
        return generate(model, prompt.to(mesh.device), cfg, max_new_tokens,
                        temperature=temperature, key=key, max_len=max_len, top_k=top_k,
                        top_p=top_p, tp_axis=axis, shard_vocab=shard_vocab)

    return gen
