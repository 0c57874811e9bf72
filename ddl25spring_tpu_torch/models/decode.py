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

Waiting for A9b-3 (TP serving and the ZeRO-3 weight-streaming decode):
``tp_axis`` / ``shard_vocab`` and :func:`make_tp_generate` raise
``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import ep
from ddl25spring_tpu_torch.utils.config import LlamaConfig

A9B = "A9b-3 of ROADMAP.md (TP serving and the ZeRO-3 weight-streaming decode)"


def not_yet(what: str) -> NotImplementedError:
    """The refusal of an option that waits for A9b-3."""
    return NotImplementedError(f"{what} is not ported yet: it comes with {A9B}")


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
    fp32 configs match the full forward."""
    if tp_axis is not None:
        raise not_yet("TP decode (tp_axis)")
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
    x = x + attn.reshape(B, 1, -1) @ p.wo.to(dtype)

    h = llama.rms_norm(x, p.ln2)
    if cfg.n_experts > 0:
        # ample decode-time capacity: a drop would zero a token's FFN
        E = p.moe["router"].shape[1]
        y, _ = ep.moe_ffn(p.moe, h.reshape(B, -1), capacity_factor=float(E),
                          top_k=cfg.moe_top_k)
        ffn_out = y.reshape(B, 1, -1).to(dtype)
    else:
        gate = F.silu(h @ p.w_gate.to(dtype))
        ffn_out = (gate * (h @ p.w_up.to(dtype))) @ p.w_down.to(dtype)
    return x + ffn_out, k_cache, v_cache


def decode_step(model: llama.Llama, cache, tokens_t: torch.Tensor, pos: int,
                cfg: LlamaConfig, tp_axis=None, shard_vocab: bool = False):
    """One incremental step: ``tokens_t [B]`` at position ``pos`` (an int)
    -> ``(logits [B, V] float32, cache)``, the cache written in place."""
    if tp_axis is not None or shard_vocab:
        raise not_yet("TP decode (tp_axis, shard_vocab)")
    k_all, v_all = cache
    x = embed_tokens(model, tokens_t[:, None], cfg)
    pos = int(pos)
    cos, sin = llama.rope_angles(
        1, cfg.head_dim,
        pos=torch.full((1,), pos, dtype=torch.float32, device=tokens_t.device))
    for li, block in enumerate(model.blocks):
        x, _, _ = _block_decode(block, x, k_all[li], v_all[li], pos, cos, sin, cfg)
    return llama.unembed(model, x, cfg)[:, 0], (k_all, v_all)


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
    ``top_p`` (:func:`sample_logits`)."""
    if tp_axis is not None or shard_vocab:
        raise not_yet("TP generation (tp_axis, shard_vocab)")
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
        logits, cache = decode_step(model, cache, prompt[:, i], i, cfg)
    out = []
    for j in range(max_new_tokens):
        tok = sample_logits(logits, key, temperature, top_k, top_p)
        logits, cache = decode_step(model, cache, tok, P + j, cfg)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_tp_generate(*args, **kwargs):
    """TP-sharded generation (JAX ``make_tp_generate``): waits for A9b-3."""
    raise not_yet("make_tp_generate")
