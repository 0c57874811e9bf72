"""Flash attention: the counterpart of the JAX package's ``ops/flash_attention.py``.

Three hand-written CUDA kernels for Hopper (``csrc/flash_attention.cu``) take
the place of the three Pallas TPU kernels: the online-softmax forward, ``dq``
and ``dk/dv``.  Two ``torch.autograd.Function``\\ s share them:
:func:`flash_attention` (``o``) and :func:`flash_attention_with_lse`
(``(o, lse)``, whose backward also takes the lse cotangent).

Inputs ``[B, L, H, hd]`` are folded to ``[B*H, L, hd]``.  On a CUDA tensor
each wrapper launches its kernel or raises; on a CPU tensor it runs the plain
PyTorch version beside it (:func:`flash_fwd_reference`,
:func:`flash_bwd_reference`), which repeats the kernel's arithmetic tile by
tile.  ``delta = rowsum(do * o)`` is plain torch in both cases, as the
reference computes it outside Pallas.

The TPU block sizes (``block_q``/``block_k``) are not carried over: the CUDA
kernels tile by 64 rows and mask ragged tails themselves.

``LAUNCHES`` counts kernel launches (never plain-version calls), so a run can
show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddl25spring_tpu_torch.ops import _build

NEG_INF = -1e30
TILE = 64           # the CUDA kernels' tile; the plain versions walk the same tiles
MAX_HEAD_DIM = 128

LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------- plain versions


def _live(q0, nq, k0, nk, causal, device):
    """``[nq, nk]`` mask of the (query, key) pairs that attend, or None."""
    if not causal:
        return None
    qpos = torch.arange(q0, q0 + nq, device=device)
    kpos = torch.arange(k0, k0 + nk, device=device)
    return qpos[:, None] >= kpos[None, :]


def flash_fwd_reference(q3, k3, v3, causal: bool):
    """The forward kernel's arithmetic in plain torch: the online-softmax walk
    over 64-row KV tiles, float32 throughout.  ``[BH, Lq, hd]`` x ``[BH, Lk, hd]``
    -> ``(o [BH, Lq, hd] in q3's dtype, lse [BH, Lq] float32)``."""
    BH, Lq, hd = q3.shape
    Lk = k3.shape[1]
    scale = hd ** -0.5
    q, k, v = q3.float(), k3.float(), v3.float()
    outs, lses = [], []
    for q0 in range(0, Lq, TILE):
        qb = q[:, q0:q0 + TILE]
        nq = qb.shape[1]
        m = torch.full((BH, nq), NEG_INF, device=q.device)
        l = torch.zeros((BH, nq), device=q.device)
        acc = torch.zeros((BH, nq, hd), device=q.device)
        kv_end = min(Lk, q0 + TILE) if causal else Lk
        for k0 in range(0, kv_end, TILE):
            kb, vb = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
            s = (qb @ kb.transpose(1, 2)) * scale
            live = _live(q0, nq, k0, kb.shape[1], causal, q.device)
            if live is not None:
                s = s.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if live is not None:
                p = p.masked_fill(~live, 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vb
            m = m_new
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    return torch.cat(outs, 1).to(q3.dtype), torch.cat(lses, 1)


def _tile_grads(qb, kb, vb, dob, lse_b, delta_b, live, scale):
    """``p`` and ``ds`` of one (Q tile, KV tile) pair, recomputed from lse."""
    p = torch.exp((qb @ kb.transpose(1, 2)) * scale - lse_b[..., None])
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    ds = p * ((dob @ vb.transpose(1, 2)) - delta_b[..., None]) * scale
    return p, ds


def flash_dq_reference(q3, k3, v3, lse, do, delta, causal: bool):
    """The dq kernel's arithmetic in plain torch, float32 throughout: for each
    Q tile, walk the KV tiles it attends to, recomputing
    ``p = exp(scale q k^T - lse)``.  Returns ``dq`` in ``q3``'s dtype."""
    Lq, hd = q3.shape[1:]
    Lk = k3.shape[1]
    scale = hd ** -0.5
    q, k, v, dof = q3.float(), k3.float(), v3.float(), do.float()
    dq = torch.zeros_like(q)
    for q0 in range(0, Lq, TILE):
        qs = slice(q0, q0 + TILE)
        nq = q[:, qs].shape[1]
        for k0 in range(0, min(Lk, q0 + TILE) if causal else Lk, TILE):
            kb, vb = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
            live = _live(q0, nq, k0, kb.shape[1], causal, q.device)
            _, ds = _tile_grads(q[:, qs], kb, vb, dof[:, qs], lse[:, qs],
                                delta[:, qs], live, scale)
            dq[:, qs] += ds @ kb
    return dq.to(q3.dtype)


def flash_dkv_reference(q3, k3, v3, lse, do, delta, causal: bool):
    """The dk/dv kernel's arithmetic in plain torch, float32 throughout: for
    each KV tile, walk the Q tiles that attend to it.  Returns ``(dk, dv)`` in
    the dtypes of ``k3`` and ``v3``."""
    Lq, hd = q3.shape[1:]
    Lk = k3.shape[1]
    scale = hd ** -0.5
    q, k, v, dof = q3.float(), k3.float(), v3.float(), do.float()
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Lk, TILE):
        ks = slice(k0, k0 + TILE)
        kb, vb = k[:, ks], v[:, ks]
        for q0 in range(k0 if causal else 0, Lq, TILE):
            qs = slice(q0, q0 + TILE)
            live = _live(q0, q[:, qs].shape[1], k0, kb.shape[1], causal, q.device)
            p, ds = _tile_grads(q[:, qs], kb, vb, dof[:, qs], lse[:, qs],
                                delta[:, qs], live, scale)
            dv[:, ks] += p.transpose(1, 2) @ dof[:, qs]
            dk[:, ks] += ds.transpose(1, 2) @ q[:, qs]
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_reference(q3, k3, v3, lse, do, delta, causal: bool):
    """Both backward kernels' plain versions: ``(dq, dk, dv)``."""
    return (flash_dq_reference(q3, k3, v3, lse, do, delta, causal),
            *flash_dkv_reference(q3, k3, v3, lse, do, delta, causal))


# ---------------------------------------------------------------- kernels


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.load(_build.CSRC / "flash_attention.cu")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, i32, f32, i32, i32, i32, ptr]  # bh Lq Lk hd scale causal dtype dev stream
    lib.ddl_flash_fwd.argtypes = [ptr] * 5 + tail
    lib.ddl_flash_dq.argtypes = [ptr] * 7 + tail
    lib.ddl_flash_dkv.argtypes = [ptr] * 8 + tail
    for fn in (lib.ddl_flash_fwd, lib.ddl_flash_dq, lib.ddl_flash_dkv):
        fn.restype = ctypes.c_int
    lib.ddl_flash_error_string.argtypes = [ctypes.c_int]
    lib.ddl_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q3, k3, v3, causal, lse=None, do=None, delta=None):
    """Raise on anything the kernels (and so the plain versions) do not take:
    the kernels index every operand from these shapes alone."""
    tensors = [t for t in (q3, k3, v3, do) if t is not None]
    if q3.dtype not in _DTYPE_CODE or any(t.dtype != q3.dtype for t in tensors):
        raise TypeError(
            f"flash attention takes float32 or bfloat16 q/k/v/do of one dtype, "
            f"got {[t.dtype for t in tensors]}"
        )
    BH, Lq, hd = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != BH or k3.shape[2] != hd:
        raise ValueError(f"q {tuple(q3.shape)} / k {tuple(k3.shape)} / v "
                         f"{tuple(v3.shape)} do not fold to [BH, L, hd] alike")
    if not 1 <= hd <= MAX_HEAD_DIM or Lq < 1 or k3.shape[1] < 1:
        raise ValueError(f"need 1 <= head_dim <= {MAX_HEAD_DIM} and L >= 1, "
                         f"got q {tuple(q3.shape)}")
    if causal and k3.shape[1] != Lq:
        raise ValueError(
            f"causal flash requires square q/kv lengths, got L={Lq} Lk={k3.shape[1]}"
        )
    if do is not None and do.shape != q3.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q3.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (BH, Lq) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be [{BH}, {Lq}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors += [t for t in (lse, delta) if t is not None]
    if any(t.device != q3.device for t in tensors):
        raise ValueError("flash attention operands lie on different devices")
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q3.device}")
    if q3.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("flash attention kernels need contiguous operands")
        cap = torch.cuda.get_device_capability(q3.device)
        if cap < (9, 0):
            raise RuntimeError(
                f"flash attention kernels are built for sm_90a; "
                f"{torch.cuda.get_device_name(q3.device)} is sm_{cap[0]}{cap[1]}"
            )


def _launch(name: str, fn, *args, q3, Lk, causal):
    BH, Lq, hd = q3.shape
    code = fn(*(t.data_ptr() for t in args), BH, Lq, Lk, hd, hd ** -0.5,
              int(causal), _DTYPE_CODE[q3.dtype], q3.device.index,
              torch.cuda.current_stream(q3.device).cuda_stream)
    if code != 0:
        msg = _kernels().ddl_flash_error_string(code).decode()
        raise RuntimeError(f"flash {name} kernel launch failed: {msg} ({code})")
    LAUNCHES[name] += 1


def flash_fwd(q3, k3, v3, causal: bool):
    """``(o, lse)`` of folded ``[BH, L, hd]`` operands: the forward kernel on
    CUDA, its plain version on the CPU."""
    _check(q3, k3, v3, causal)
    if q3.device.type == "cpu":
        return flash_fwd_reference(q3, k3, v3, causal)
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[:2], dtype=torch.float32, device=q3.device)
    _launch("fwd", _kernels().ddl_flash_fwd, q3, k3, v3, o, lse,
            q3=q3, Lk=k3.shape[1], causal=causal)
    return o, lse


def flash_dq(q3, k3, v3, lse, do, delta, causal: bool):
    """``dq``: the dq kernel on CUDA, its plain version on the CPU.  ``delta``
    is ``rowsum(do * o)`` minus any lse cotangent, ``[BH, Lq]`` float32."""
    _check(q3, k3, v3, causal, lse, do, delta)
    if q3.device.type == "cpu":
        return flash_dq_reference(q3, k3, v3, lse, do, delta, causal)
    dq = torch.empty_like(q3)
    _launch("dq", _kernels().ddl_flash_dq, q3, k3, v3, do, lse, delta, dq,
            q3=q3, Lk=k3.shape[1], causal=causal)
    return dq


def flash_dkv(q3, k3, v3, lse, do, delta, causal: bool):
    """``(dk, dv)``: the dk/dv kernel on CUDA, its plain version on the CPU."""
    _check(q3, k3, v3, causal, lse, do, delta)
    if q3.device.type == "cpu":
        return flash_dkv_reference(q3, k3, v3, lse, do, delta, causal)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("dkv", _kernels().ddl_flash_dkv, q3, k3, v3, do, lse, delta, dk, dv,
            q3=q3, Lk=k3.shape[1], causal=causal)
    return dk, dv


# -------------------------------------------------------------- autograd


def _forward(ctx, q3, k3, v3, causal):
    o, lse = flash_fwd(q3, k3, v3, causal)
    ctx.save_for_backward(q3, k3, v3, o, lse)
    ctx.causal = causal
    return o, lse


def _backward(ctx, do, dlse=None):
    q3, k3, v3, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        # d lse_i / d s_ij = p_ij, so the lse cotangent folds into delta:
        # ds = p (dp - delta + dlse) = p (dp - delta'), delta' = delta - dlse
        delta = delta - dlse.float()
    return (flash_dq(q3, k3, v3, lse, do, delta, ctx.causal),
            *flash_dkv(q3, k3, v3, lse, do, delta, ctx.causal), None)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, causal):
        return _forward(ctx, q3, k3, v3, causal)[0]

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do)


class _FlashLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, causal):
        return _forward(ctx, q3, k3, v3, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def _fold(x: torch.Tensor) -> torch.Tensor:
    B, L, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, L, hd)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Flash attention.  ``q/k/v``: ``[B, L, H, hd]`` -> ``[B, L, H, hd]``."""
    B, L, H, hd = q.shape
    o3 = _Flash.apply(_fold(q), _fold(k), _fold(v), causal)
    return o3.view(B, H, L, hd).transpose(1, 2)


def flash_attention_with_lse(q, k, v, *, causal: bool = True):
    """:func:`flash_attention` also returning the log-sum-exp.

    ``q/k/v``: ``[B, L, H, hd]`` -> ``(o [B, L, H, hd], lse [B, H, L])``.  The
    backward takes cotangents for both outputs.  KV length may differ from
    ``L`` only when ``causal=False``."""
    B, L, H, hd = q.shape
    o3, lse = _FlashLse.apply(_fold(q), _fold(k), _fold(v), causal)
    return o3.view(B, H, L, hd).transpose(1, 2), lse.view(B, H, L)
