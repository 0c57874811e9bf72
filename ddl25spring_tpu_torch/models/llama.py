"""LLaMA-style decoder, the counterpart of the JAX package's ``models/llama.py``.

The same arithmetic as the reference, in PyTorch: RMSNorm, rotary embeddings
over interleaved (even, odd) pairs, causal attention with a float32 softmax,
SwiGLU FFN, float32 logits.  Parameters are float32 and are cast to
``cfg.dtype`` where they are used, as the reference casts them.

Weights keep the reference's ``[in, out]`` layout and are applied as
``x @ W``, so :func:`load_jax_params` / :func:`export_params` move a parameter
pytree across without transposes.  Blocks are an ``nn.ModuleList`` applied in
a Python loop where the reference scans a stacked ``[L, ...]`` pytree.

A pipeline stage (:class:`LlamaStage`, :func:`stage_forward`) holds a
contiguous slice of the blocks, plus the embedding on the first stage and the
final norm and unembedding on the last; it loads its slice of the
reference's staged pytree (blocks ``[S, L/S, ...]``) and exports it back.
Under the interleaved schedules a rank holds ``V`` such slices
(:class:`LlamaChunkedStage`, blocks ``[S, V, L/(S V), ...]``).

:func:`block_forward` carries the JAX block's parallel hooks: ``tp_axis``
(Megatron tensor parallelism: this rank's column slices of
``wq``/``wk``/``wv``/``w_gate``/``w_up`` and row slices of ``wo``/``w_down``,
the head count read off the slice), ``pos`` (the global positions of a
sequence shard, for RoPE) and ``attn_fn`` (the attention of a sequence-
parallel ring or all-to-all); :mod:`~ddl25spring_tpu_torch.parallel.tp` and
:mod:`~ddl25spring_tpu_torch.parallel.sp` use them.

Switch-MoE configs (``cfg.n_experts > 0``) put a
:class:`~ddl25spring_tpu_torch.parallel.ep.MoeParams` (router, stacked
experts) in each block in place of the dense FFN; the pytree's
``blocks["moe"]`` is then a subtree of stacked ``[L, ...]`` leaves, which
the bridge and the stage splits carry.  :func:`block_forward` returns the
block's switch aux loss beside its output (0.0 for a dense FFN), and
:func:`llama_forward_with_aux` the sum over the layers: a MoE model trains
on ``causal_lm_loss + cfg.moe_aux_weight * aux``, so :func:`llama_forward`
refuses one, as the JAX function does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.ops.flash_attention import flash_attention
from ddl25spring_tpu_torch.parallel import ep
from ddl25spring_tpu_torch.parallel.bucketing import flatten
from ddl25spring_tpu_torch.parallel.comm import Axis, copy_in, reduce_out
from ddl25spring_tpu_torch.utils.config import LlamaConfig

ATTN_BLOCK_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
FFN_KEYS = ("w_gate", "w_up", "w_down")


def _dense(shape, generator: torch.Generator, device, scale=0.02) -> nn.Parameter:
    # drawn on the CPU generator, then moved: the same seed gives the same
    # weights on every device
    w = scale * torch.randn(shape, generator=generator, dtype=torch.float32)
    return nn.Parameter(w.to(device))


def _ones(n, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=torch.float32, device=device))


class LlamaBlock(nn.Module):
    """One pre-norm block's parameters (applied by :func:`block_forward`):
    the dense SwiGLU FFN, or with ``cfg.n_experts > 0`` the switch-MoE FFN
    ``moe`` (:func:`~ddl25spring_tpu_torch.parallel.ep.init_moe_params`)."""

    def __init__(self, cfg: LlamaConfig, generator: torch.Generator, device):
        super().__init__()
        d, f = cfg.dmodel, cfg.ffn_dim
        self.ln1 = _ones(d, device)
        self.wq = _dense((d, d), generator, device)
        self.wk = _dense((d, d), generator, device)
        self.wv = _dense((d, d), generator, device)
        self.wo = _dense((d, d), generator, device)
        self.ln2 = _ones(d, device)
        if cfg.n_experts > 0:
            self.moe = ep.init_moe_params(generator, d, f, cfg.n_experts, device)
        else:
            self.w_gate = _dense((d, f), generator, device)
            self.w_up = _dense((d, f), generator, device)
            self.w_down = _dense((f, d), generator, device)


class Llama(nn.Module):
    """Full model: ``embed [V, D]``, ``blocks``, final-norm scale ``ln_f``,
    ``unembed [D, V]``; init ``normal(0, 0.02)`` from ``generator``."""

    def __init__(self, cfg: LlamaConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = _dense((cfg.vocab_size, cfg.dmodel), generator, device)
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, generator, device) for _ in range(cfg.n_layers)
        )
        self.ln_f = _ones(cfg.dmodel, device)
        self.unembed = _dense((cfg.dmodel, cfg.vocab_size), generator, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return llama_forward(self, tokens, self.cfg)

    def param_tree(self) -> dict:
        return _param_tree(self)


class LlamaStage(nn.Module):
    """Stage ``stage`` of ``num_stages``: layers ``[stage * L/S, (stage+1) * L/S)``,
    plus ``embed`` on the first stage and ``ln_f`` / ``unembed`` on the last
    (the reference's ``LLamaStage``, ``lab/s01_b1_microbatches.py:40-62``).
    Applied by :func:`stage_forward`."""

    def __init__(self, cfg: LlamaConfig, stage: int, num_stages: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        if cfg.n_layers % num_stages:
            raise ValueError(f"{cfg.n_layers} layers not divisible by {num_stages} stages")
        if not 0 <= stage < num_stages:
            raise ValueError(f"stage {stage} outside 0..{num_stages - 1}")
        self.cfg, self.stage, self.num_stages = cfg, stage, num_stages
        self.first, self.last = stage == 0, stage == num_stages - 1
        if self.first:
            self.embed = _dense((cfg.vocab_size, cfg.dmodel), generator, device)
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, generator, device) for _ in range(cfg.n_layers // num_stages)
        )
        if self.last:
            self.ln_f = _ones(cfg.dmodel, device)
            self.unembed = _dense((cfg.dmodel, cfg.vocab_size), generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stage_forward(self, x, self.cfg)

    def param_tree(self) -> dict:
        return _param_tree(self)


class LlamaChunkedStage(nn.Module):
    """Rank ``stage`` of ``num_stages`` under the interleaved schedules:
    ``num_chunks`` chunks, chunk ``v`` being the global chunk
    ``g = v * S + stage`` of ``S * V``, a :class:`LlamaStage` of layers
    ``[g Lc, (g+1) Lc)`` with ``Lc = L / (S V)`` (Megatron's interleaving,
    the JAX ``split_blocks_interleaved``).  The embedding sits on chunk 0 of
    rank 0 and ``ln_f``/``unembed`` on the last chunk of rank ``S - 1``.
    Each chunk is applied by :func:`stage_forward`; the pipeline runs them."""

    def __init__(self, cfg: LlamaConfig, stage: int, num_stages: int, num_chunks: int, *,
                 device, generator: torch.Generator):
        super().__init__()
        S, V = num_stages, num_chunks
        if cfg.n_layers % (S * V):
            raise ValueError(f"{cfg.n_layers} layers not divisible by S*V = {S}*{V}")
        if not 0 <= stage < S:
            raise ValueError(f"stage {stage} outside 0..{S - 1}")
        self.cfg, self.stage, self.num_stages, self.num_chunks = cfg, stage, S, V
        self.first, self.last = stage == 0, stage == S - 1
        self.chunks = nn.ModuleList(LlamaStage(cfg, v * S + stage, S * V, device=device,
                                               generator=generator) for v in range(V))

    @property
    def blocks(self) -> list[LlamaBlock]:
        """Every block of the rank, chunk by chunk: the order of its
        ``[V, Lc]`` slice of the interleaved pytree, flattened."""
        return [b for c in self.chunks for b in c.blocks]

    def param_tree(self) -> dict:
        tree = {}
        if self.first:
            tree["embed"] = self.chunks[0].embed
        if self.last:
            tree["ln_f"], tree["unembed"] = self.chunks[-1].ln_f, self.chunks[-1].unembed
        tree["blocks"] = _blocks_tree(self.blocks)
        return tree


def _blocks_tree(blocks) -> dict:
    """``blocks.<key>`` as one parameter per layer (the stacked ``[L, ...]``
    leaf), with the MoE leaves under ``blocks.moe.<key>``."""
    tree = {k: [getattr(b, k) for b in blocks] for k in ATTN_BLOCK_KEYS}
    if hasattr(blocks[0], "moe"):
        tree["moe"] = {k: [b.moe[k] for b in blocks] for k in ep.MOE_KEYS}
    else:
        tree.update({k: [getattr(b, k) for b in blocks] for k in FFN_KEYS})
    return tree


def _param_tree(model: nn.Module) -> dict:
    """The reference's pytree layout over ``model``'s parameters: ``blocks.<key>``
    holds one parameter per layer (the stacked ``[L, ...]`` leaf; a MoE
    block's under ``blocks.moe.<key>``); ``embed``, ``ln_f`` and ``unembed``
    where the model holds them."""
    tree = {k: getattr(model, k) for k in ("embed", "ln_f", "unembed") if hasattr(model, k)}
    tree["blocks"] = _blocks_tree(model.blocks)
    return tree


def map_blocks(fn, *trees):
    """``fn`` over the matching leaves of nested dicts (the ``blocks``
    subtrees of reference pytrees): the ``jax.tree.map`` the stage splits and
    the bridge need."""
    if isinstance(trees[0], dict):
        return {k: map_blocks(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------- forward


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    rms = torch.sqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 / rms) * scale).to(x.dtype)


def rope_angles(seq_len: int, head_dim: int, base: float = 10_000.0,
                pos: torch.Tensor | None = None, device=None):
    """``(cos, sin)``, each ``[L, hd/2]`` float32.  ``pos`` overrides
    ``arange(seq_len)``."""
    if pos is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = base ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32, device=pos.device) / head_dim
    )
    ang = pos.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x: [B, L, H, hd]; rotates interleaved (even, odd) pairs, not the
    # half-split rotate_half convention
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def causal_attention(q, k, v, dtype: torch.dtype) -> torch.Tensor:
    """Dense causal attention: scores in ``dtype``, float32 softmax."""
    hd = q.shape[-1]
    L, Lk = q.shape[1], k.shape[1]
    scores = torch.einsum("blhd,bmhd->bhlm", q, k).float() / math.sqrt(hd)
    mask = torch.ones((L, Lk), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def _dtype(cfg: LlamaConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _flash(q, k, v, dtype):
    return flash_attention(q, k, v)


def block_forward(p: LlamaBlock, x: torch.Tensor, cfg: LlamaConfig, *,
                  tp_axis: Axis | None = None, pos: torch.Tensor | None = None,
                  attn_fn=None, moe_fn=None):
    """One pre-norm block: RMSNorm -> causal RoPE attention -> residual ->
    RMSNorm -> FFN -> residual; returns ``(x, aux)``, ``aux`` the switch-MoE
    load-balancing loss when ``cfg.n_experts > 0`` and ``0.0`` for the dense
    SwiGLU FFN (JAX ``block_forward``, ``llama.py:130``).  Attention goes
    through ``attn_fn(q, k, v, dtype)`` when given, else through
    :func:`flash_attention` when ``cfg.use_flash`` (its kernels on CUDA,
    their plain versions on the CPU), else through dense
    :func:`causal_attention`.  The MoE FFN takes the normed tokens flattened
    to ``[B L, D]``, one dispatch group per call, through ``moe_fn(p.moe,
    flat) -> (y, aux)``, by default
    :func:`~ddl25spring_tpu_torch.parallel.ep.moe_ffn` at the config's
    capacity and top-k.

    Parallel hooks (both off by default, the serial block): ``tp_axis``, the
    model axis of Megatron tensor parallelism: ``p`` holds this rank's slices,
    each normed input enters the column-parallel products through
    :func:`~ddl25spring_tpu_torch.parallel.comm.copy_in` and each
    row-parallel product leaves through
    :func:`~ddl25spring_tpu_torch.parallel.comm.reduce_out`; a MoE block
    needs the expert-sharded ``moe_fn`` of
    :func:`~ddl25spring_tpu_torch.parallel.tp.make_tp_moe_fn`, whose partial
    output ``reduce_out`` completes, and raises without one, as in JAX;
    ``pos``/``attn_fn``: a sequence shard's global RoPE positions and its
    attention."""
    if cfg.n_experts > 0 and tp_axis is not None and moe_fn is None:
        # the replicated moe_ffn's output would be summed n times by the
        # row-parallel reduce_out
        raise NotImplementedError(
            "switch-MoE under tensor parallelism needs the expert-sharded moe_fn "
            "from parallel.tp.make_tp_moe_fn (whose partial output the "
            "row-parallel reduce_out completes)")
    dtype = _dtype(cfg)
    B, L, D = x.shape
    hd = cfg.head_dim

    def col_in(h):
        return h if tp_axis is None else copy_in(h, tp_axis)

    def row_out(y):
        return y if tp_axis is None else reduce_out(y, tp_axis)

    h = col_in(rms_norm(x, p.ln1))
    q = (h @ p.wq.to(dtype)).view(B, L, -1, hd)
    k = (h @ p.wk.to(dtype)).view(B, L, -1, hd)
    v = (h @ p.wv.to(dtype)).view(B, L, -1, hd)
    cos, sin = rope_angles(L, hd, pos=pos, device=x.device)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if attn_fn is None:
        attn_fn = _flash if cfg.use_flash else causal_attention
    attn = attn_fn(q, k, v, dtype)
    x = x + row_out(attn.reshape(B, L, -1) @ p.wo.to(dtype))

    if cfg.n_experts > 0:
        if moe_fn is None:
            def moe_fn(mp, flat):
                return ep.moe_ffn(mp, flat, capacity_factor=cfg.capacity_factor,
                                  top_k=cfg.moe_top_k)
        # the TP moe_fn puts its own copy_in where the rank-local work starts
        y, aux = moe_fn(p.moe, rms_norm(x, p.ln2).reshape(B * L, D))
        return x + row_out(y.reshape(B, L, D).to(dtype)), aux
    h = col_in(rms_norm(x, p.ln2))
    gate = F.silu(h @ p.w_gate.to(dtype))
    up = h @ p.w_up.to(dtype)
    return x + row_out((gate * up) @ p.w_down.to(dtype)), 0.0


def apply_blocks(blocks, x: torch.Tensor, cfg: LlamaConfig, **block_kw):
    """:func:`block_forward` of each block in turn (JAX ``apply_blocks``, a
    scan there): ``(x, aux)``, ``aux`` summed over the layers (``0.0`` for a
    dense FFN)."""
    aux = 0.0
    for block in blocks:
        x, a = block_forward(block, x, cfg, **block_kw)
        aux = aux + a
    return x, aux


def embed(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return model.embed.to(_dtype(cfg))[tokens]


def unembed(model: Llama, x: torch.Tensor, cfg: LlamaConfig,
            tp_axis: Axis | None = None) -> torch.Tensor:
    """Final norm + output projection; logits come out float32.  With
    ``tp_axis``, ``model.unembed`` is this rank's column slice of a
    vocab-sharded head: the normed input enters it through ``copy_in``."""
    h = rms_norm(x, model.ln_f)
    if tp_axis is not None:
        h = copy_in(h, tp_axis)
    return (h @ model.unembed.to(h.dtype)).float()


def _refuse_moe(cfg: LlamaConfig, use: str):
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"cfg.n_experts > 0: use {use} so the MoE load-balancing aux loss reaches "
            "the objective")


def llama_forward(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                  **block_kw) -> torch.Tensor:
    """``tokens [B, L]`` -> logits ``[B, L, V]`` float32; ``block_kw``
    (``pos``, ``attn_fn``) go to every :func:`block_forward`.  Dense-FFN
    configs only: a switch-MoE config raises (JAX ``llama.py:280``), since its
    aux loss would be dropped; use :func:`llama_forward_with_aux`."""
    _refuse_moe(cfg, "llama_forward_with_aux")
    return llama_forward_with_aux(model, tokens, cfg, **block_kw)[0]


def llama_forward_with_aux(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
                           **block_kw):
    """``(logits, moe_aux)``: a switch-MoE config trains on
    ``causal_lm_loss(logits, tokens) + cfg.moe_aux_weight * moe_aux``;
    ``moe_aux`` is ``0.0`` for a dense FFN."""
    x = embed(model, tokens, cfg)
    x, aux = apply_blocks(model.blocks, x, cfg, **block_kw)
    return unembed(model, x, cfg), aux


def stage_forward(stage: LlamaStage, x: torch.Tensor, cfg: LlamaConfig,
                  with_aux: bool = False, **block_kw):
    """One pipeline stage: ``tokens [B, L]`` on the first stage, activations
    ``[B, L, D]`` in ``cfg.dtype`` elsewhere; returns float32 logits on the last
    stage, activations otherwise.  ``with_aux``: ``(out, aux)``, the stage's
    MoE aux loss summed over its layers; a MoE stage needs it (and raises
    without it, as :func:`llama_forward` does).  ``block_kw`` (``tp_axis``,
    ``moe_fn``, ``pos``, ``attn_fn``) goes to every :func:`block_forward`: the
    parallel hooks of a stage under TP, EP or SP; the embedding and the head
    stay whole."""
    if not with_aux:
        _refuse_moe(cfg, "stage_forward(with_aux=True)")
    if stage.first:
        x = embed(stage, x, cfg)
    x, aux = apply_blocks(stage.blocks, x, cfg, **block_kw)
    out = unembed(stage, x, cfg) if stage.last else x
    return (out, aux) if with_aux else out


# ------------------------------------------------------------ weight bridge


def _put(param: nn.Parameter, value, name: str, resize: bool):
    value = np.asarray(value)
    if resize:
        param.data = torch.from_numpy(np.array(value, dtype=np.float32)).to(param.device)
        return
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {value.shape} != {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


@torch.no_grad()
def load_jax_params(model: Llama | LlamaStage, np_params: dict, resize: bool = False):
    """Copy the reference's parameter pytree (numpy leaves: ``embed [V, D]``,
    stacked ``blocks.<key> [L, ...]`` with a MoE model's under
    ``blocks.moe.<key>``, ``ln_f``, ``unembed [D, V]``) into ``model`` (a
    stage takes the keys it holds).  Shapes must match exactly, unless
    ``resize``: then each parameter takes its value's shape (a rank's slice
    under TP or EP; build the optimizer after)."""
    given = dict(flatten(np_params))
    for path, leaf in flatten(model.param_tree()):
        if path not in given:
            raise ValueError(f"{path}: not in the pytree")
        value = given[path]
        if isinstance(leaf, torch.Tensor):
            _put(leaf, value, path, resize)
            continue
        if len(value) != len(leaf):
            raise ValueError(f"{path}: {len(value)} layers != {len(leaf)}")
        for i, param in enumerate(leaf):
            _put(param, value[i], f"{path}[{i}]", resize)
    return model


def load_stage_params(stage: LlamaStage | LlamaChunkedStage, staged: dict,
                      resize: bool = False):
    """Copy stage ``stage.stage``'s slice of the reference's staged pytree into
    ``stage``: its layers, and whichever of ``embed``, ``ln_f``, ``unembed``
    it holds.  A :class:`LlamaStage` takes blocks ``[S, L/S, ...]`` (from
    :func:`split_blocks_for_stages`), a :class:`LlamaChunkedStage` blocks
    ``[S, V, L/(S V), ...]`` (from :func:`split_blocks_interleaved`).
    ``resize`` as in :func:`load_jax_params`."""
    n = len(staged["blocks"]["wq"])
    if n != stage.num_stages:
        raise ValueError(f"pytree split into {n} stages, the stage is one of "
                         f"{stage.num_stages}")
    chunked = np.ndim(staged["blocks"]["wq"]) == 5
    if chunked != isinstance(stage, LlamaChunkedStage):
        raise ValueError("an interleaved pytree ([S, V, Lc, ...] blocks) loads into a "
                         "LlamaChunkedStage, a staged one ([S, Lc, ...]) into a LlamaStage")
    mine = dict(staged)
    mine["blocks"] = map_blocks(lambda v: np.asarray(v[stage.stage]), staged["blocks"])
    if chunked:
        if len(mine["blocks"]["wq"]) != stage.num_chunks:
            raise ValueError(f"pytree split into {len(mine['blocks']['wq'])} chunks, the "
                             f"stage holds {stage.num_chunks}")
        mine["blocks"] = map_blocks(lambda v: v.reshape((-1,) + v.shape[2:]), mine["blocks"])
    return load_jax_params(stage, mine, resize)


def _export(model: nn.Module, grads: bool) -> dict:
    def arr(p):
        return (p.grad if grads else p).detach().cpu().numpy().copy()

    tree = model.param_tree()
    out = {k: arr(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = map_blocks(lambda ps: np.stack([arr(p) for p in ps]), tree["blocks"])
    return out


@torch.no_grad()
def export_params(model: Llama | LlamaStage) -> dict:
    """The inverse of :func:`load_jax_params`: the reference's pytree layout
    with numpy leaves (a stage exports the keys it holds, blocks ``[L/S, ...]``)."""
    return _export(model, grads=False)


@torch.no_grad()
def export_grads(model: Llama | LlamaStage) -> dict:
    """The gradients in ``.grad``, laid out as :func:`export_params` lays out
    the parameters."""
    return _export(model, grads=True)


def merge_stage_exports(exports: list[dict], num_chunks: int = 1) -> dict:
    """The full pytree from the exports of stages ``0..S-1``, in order:
    blocks concatenated (with ``num_chunks > 1``, each stage's ``V Lc``
    blocks put back in their interleaved places), ``embed`` from the first
    stage, ``ln_f``/``unembed`` from the last."""
    blocks = map_blocks(lambda *vs: np.concatenate(vs), *(e["blocks"] for e in exports))
    if num_chunks > 1:
        S = len(exports)
        blocks = merge_blocks_interleaved({"blocks": map_blocks(
            lambda v: v.reshape((S, num_chunks, -1) + v.shape[1:]), blocks)})["blocks"]
    return {"embed": exports[0]["embed"], "blocks": blocks, "ln_f": exports[-1]["ln_f"],
            "unembed": exports[-1]["unembed"]}


def split_blocks_for_stages(params: dict, num_stages: int) -> dict:
    """Reshape the stacked blocks ``[L, ...] -> [S, L/S, ...]`` (numpy), the
    MoE subtree too, as the JAX package's ``split_blocks_for_stages``
    (``llama.py:306``)."""
    L = len(params["blocks"]["wq"])
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible by {num_stages} stages")
    out = dict(params)
    out["blocks"] = map_blocks(
        lambda v: np.asarray(v).reshape((num_stages, L // num_stages) + v.shape[1:]),
        params["blocks"])
    return out


def merge_blocks_from_stages(params: dict) -> dict:
    """Inverse of :func:`split_blocks_for_stages`."""
    out = dict(params)
    out["blocks"] = map_blocks(lambda v: np.asarray(v).reshape((-1,) + v.shape[2:]),
                               params["blocks"])
    return out


def split_blocks_interleaved(params: dict, num_stages: int, num_chunks: int) -> dict:
    """Reshape the stacked blocks ``[L, ...] -> [S, V, L/(S V), ...]`` (numpy)
    for the interleaved schedules, as the JAX package's
    ``split_blocks_interleaved`` (``llama.py:322``): ``blocks[s][v]`` is the
    global chunk ``v S + s``, layers ``[(v S + s) Lc, (v S + s + 1) Lc)``."""
    L = len(params["blocks"]["wq"])
    S, V = num_stages, num_chunks
    if L % (S * V):
        raise ValueError(f"{L} layers not divisible by S*V = {S}*{V}")
    out = dict(params)
    # [L] -> [V, S, Lc] (chunk-major: g = v S + s) -> [S, V, Lc]
    out["blocks"] = map_blocks(
        lambda v: np.asarray(v).reshape((V, S, L // (S * V)) + v.shape[1:]).swapaxes(0, 1),
        params["blocks"])
    return out


def merge_blocks_interleaved(params: dict) -> dict:
    """Inverse of :func:`split_blocks_interleaved`."""
    out = dict(params)
    out["blocks"] = map_blocks(lambda v: np.asarray(v).swapaxes(0, 1).reshape((-1,) + v.shape[3:]),
                               params["blocks"])
    return out
