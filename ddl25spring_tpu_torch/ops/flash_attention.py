"""Flash attention: the counterpart of the JAX package's ``ops/flash_attention.py``.

Hand-written CUDA kernels for Hopper take the place of the three Pallas TPU
kernels: the online-softmax forward, ``dq`` and ``dk/dv``.  Two
``torch.autograd.Function``\\ s share them: :func:`flash_attention` (``o``)
and :func:`flash_attention_with_lse` (``(o, lse)``, whose backward also takes
the lse cotangent).

Variants, chosen by dtype and shape (``LAUNCHES_BY_VARIANT`` counts each):

- ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): all three kernels on the
  tensor cores, for bfloat16 operands whose head_dim is a multiple of 8 (TMA
  needs 16-byte row strides) and whose data pointers are 16-byte aligned.
  They round p and ds to bf16 before the second product of each pair, as
  the TPU kernels round them to the input type.
- ``"tf32x3"`` (``csrc/flash_attention_tf32x3.cu``): all three kernels on the
  tensor cores for float32 operands whose head_dim is a multiple of 4 and
  whose data pointers are 16-byte aligned (``cp.async`` moves 16-byte pieces
  of a row).  Each operand is split as ``hi + lo``, both TF32, and each
  product taken as three TF32 products summed in fp32, so they hold the fp32
  tolerance of 1e-4 that one TF32 product would miss.
- ``"scalar"`` (``csrc/flash_attention.cu``): scalar fp32 FMAs, with the same
  roundings, for the float32 operands the tf32x3 kernels do not take and the
  bfloat16 operands the wgmma kernels do not take (head_dim not a multiple of
  8, or 4 for tf32x3; misaligned pointers).

A failed build or launch raises; nothing gives way to another variant.

Inputs ``[B, L, H, hd]`` are folded to ``[B*H, L, hd]``.  On a CUDA tensor
each wrapper launches its kernel or raises; on a CPU tensor it runs the plain
PyTorch version beside it (:func:`flash_fwd_reference`,
:func:`flash_bwd_reference`), which repeats the kernel's arithmetic tile by
tile.  ``delta = rowsum(do * o)`` is plain torch in both cases, as the
reference computes it outside Pallas.

The TPU block sizes (``block_q``/``block_k``) are not carried over: the CUDA
kernels tile by 64 rows and mask ragged tails themselves.

``LAUNCHES`` counts kernel launches per kernel and ``LAUNCHES_BY_VARIANT`` per
kernel and variant (never plain-version calls), so a run can show that its
attention went through the kernels it expects.  Both count eager launches
only: a launch made while the current stream is capturing a CUDA graph
(:func:`~ddl25spring_tpu_torch.parallel.pipeline.fuse_train_steps`) records
a node of the graph and runs nothing, and a replay of the graph runs its
kernels without calling back into Python.  ``CAPTURED`` counts those
recorded launches, per kernel and variant: the kernel nodes the graphs
captured in this process hold, once each, whatever the number of replays.
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
VARIANTS = ("wgmma", "tf32x3", "scalar")
LAUNCHES_BY_VARIANT = {name: dict.fromkeys(VARIANTS, 0) for name in LAUNCHES}
CAPTURED = {name: dict.fromkeys(VARIANTS, 0) for name in LAUNCHES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------- plain versions


def _live(q0, nq, k0, nk, causal, device):
    """``[nq, nk]`` mask of the (query, key) pairs that attend, or None."""
    if not causal:
        return None
    qpos = torch.arange(q0, q0 + nq, device=device)
    kpos = torch.arange(k0, k0 + nk, device=device)
    return qpos[:, None] >= kpos[None, :]


def _round(x, dtype):
    """``x`` rounded to ``dtype`` and back to float32 (identity for float32)."""
    return x.to(dtype).float()


def flash_fwd_reference(q3, k3, v3, causal: bool):
    """The forward kernel's arithmetic in plain torch: the online-softmax walk
    over 64-row KV tiles in float32, with p rounded to the input dtype before
    ``p @ v`` (the row sums take it unrounded), as the TPU kernel does.
    ``[BH, Lq, hd]`` x ``[BH, Lk, hd]`` -> ``(o [BH, Lq, hd] in q3's dtype,
    lse [BH, Lq] float32)``."""
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
            acc = acc * corr[..., None] + _round(p, v3.dtype) @ vb
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
    """The dq kernel's arithmetic in plain torch: for each Q tile, walk the KV
    tiles it attends to, recomputing ``p = exp(scale q k^T - lse)`` in float32,
    with ds rounded to the input dtype before ``ds @ k`` as the TPU kernel
    rounds it (p is never a matmul operand here, so it stays float32).
    Returns ``dq`` in ``q3``'s dtype."""
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
            dq[:, qs] += _round(ds, q3.dtype) @ kb
    return dq.to(q3.dtype)


def flash_dkv_reference(q3, k3, v3, lse, do, delta, causal: bool):
    """The dk/dv kernel's arithmetic in plain torch: for each KV tile, walk the
    Q tiles that attend to it, in float32, with p and ds rounded to the input
    dtype before ``p^T do`` and ``ds^T q`` as the TPU kernel rounds them.
    Returns ``(dk, dv)`` in the dtypes of ``k3`` and ``v3``."""
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
            dv[:, ks] += _round(p, do.dtype).transpose(1, 2) @ dof[:, qs]
            dk[:, ks] += _round(ds, q3.dtype).transpose(1, 2) @ q[:, qs]
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_reference(q3, k3, v3, lse, do, delta, causal: bool):
    """Both backward kernels' plain versions: ``(dq, dk, dv)``."""
    return (flash_dq_reference(q3, k3, v3, lse, do, delta, causal),
            *flash_dkv_reference(q3, k3, v3, lse, do, delta, causal))


# ---------------------------------------------------------------- kernels


@functools.cache
def _kernels():
    """The three libraries, built together (one ``nvcc`` each, in parallel)."""
    paths = _build.build(_build.CSRC / "flash_attention.cu",
                         _build.CSRC / "flash_attention_sm90.cu",
                         _build.CSRC / "flash_attention_tf32x3.cu")
    scalar, sm90, tf32x3 = (ctypes.CDLL(str(p)) for p in paths)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, i32, f32, i32, i32, i32, ptr]  # bh Lq Lk hd scale causal dtype dev stream
    scalar.ddl_flash_fwd.argtypes = [ptr] * 5 + tail
    scalar.ddl_flash_dq.argtypes = [ptr] * 7 + tail
    scalar.ddl_flash_dkv.argtypes = [ptr] * 8 + tail
    tail90 = [i32, i32, i32, i32, f32, i32, i32, ptr]  # bh Lq Lk hd scale causal dev stream
    sm90.ddl_flash_fwd_sm90.argtypes = [ptr] * 5 + tail90
    sm90.ddl_flash_dq_sm90.argtypes = [ptr] * 7 + tail90
    sm90.ddl_flash_dkv_sm90.argtypes = [ptr] * 8 + tail90
    tf32x3.ddl_flash_fwd_tf32x3.argtypes = [ptr] * 5 + tail90
    tf32x3.ddl_flash_dq_tf32x3.argtypes = [ptr] * 7 + tail90
    tf32x3.ddl_flash_dkv_tf32x3.argtypes = [ptr] * 8 + tail90
    for fn in (scalar.ddl_flash_fwd, scalar.ddl_flash_dq, scalar.ddl_flash_dkv,
               sm90.ddl_flash_fwd_sm90, sm90.ddl_flash_dq_sm90, sm90.ddl_flash_dkv_sm90,
               tf32x3.ddl_flash_fwd_tf32x3, tf32x3.ddl_flash_dq_tf32x3,
               tf32x3.ddl_flash_dkv_tf32x3):
        fn.restype = ctypes.c_int
    for fn in (scalar.ddl_flash_error_string, sm90.ddl_flash_sm90_error_string,
               tf32x3.ddl_flash_tf32x3_error_string):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
    return {"scalar": {"fwd": scalar.ddl_flash_fwd, "dq": scalar.ddl_flash_dq,
                       "dkv": scalar.ddl_flash_dkv, "error": scalar.ddl_flash_error_string},
            "wgmma": {"fwd": sm90.ddl_flash_fwd_sm90, "dq": sm90.ddl_flash_dq_sm90,
                      "dkv": sm90.ddl_flash_dkv_sm90,
                      "error": sm90.ddl_flash_sm90_error_string},
            "tf32x3": {"fwd": tf32x3.ddl_flash_fwd_tf32x3, "dq": tf32x3.ddl_flash_dq_tf32x3,
                       "dkv": tf32x3.ddl_flash_dkv_tf32x3,
                       "error": tf32x3.ddl_flash_tf32x3_error_string}}


@functools.cache
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


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
        cap = _capability(q3.device.index)
        if cap < (9, 0):
            raise RuntimeError(
                f"flash attention kernels are built for sm_90a; "
                f"{torch.cuda.get_device_name(q3.device)} is sm_{cap[0]}{cap[1]}"
            )


def _variant(name, tensors):
    """The variant that runs kernel ``name`` on ``tensors`` (q3 first), by the
    dispatch rule of the module docstring: bfloat16 with head_dim a multiple
    of 8 goes to wgmma, float32 with head_dim a multiple of 4 to tf32x3, each
    only with every pointer 16-byte aligned; the rest to scalar.  The rule is
    the same for the three kernels (``name`` does not change it)."""
    q3 = tensors[0]
    hd = q3.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if q3.dtype == torch.bfloat16:
        return "wgmma" if hd % 8 == 0 and aligned else "scalar"
    return "tf32x3" if hd % 4 == 0 and aligned else "scalar"


def _launch(name: str, variant: str, *args, q3, Lk, causal):
    BH, Lq, hd = q3.shape
    lib = _kernels()[variant]
    ptrs = [t.data_ptr() for t in args]
    dims = [BH, Lq, Lk, hd, hd ** -0.5, int(causal)]
    if variant == "scalar":
        dims.append(_DTYPE_CODE[q3.dtype])
    code = lib[name](*ptrs, *dims, q3.device.index,
                     torch.cuda.current_stream(q3.device).cuda_stream)
    if code != 0:
        msg = lib["error"](code).decode()
        raise RuntimeError(f"flash {name} ({variant}) kernel launch failed: {msg} ({code})")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name][variant] += 1
    else:
        LAUNCHES[name] += 1
        LAUNCHES_BY_VARIANT[name][variant] += 1


def reset_launches():
    """Set every launch count, eager and captured, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for v in LAUNCHES_BY_VARIANT[name]:
            LAUNCHES_BY_VARIANT[name][v] = 0
            CAPTURED[name][v] = 0


def flash_fwd(q3, k3, v3, causal: bool):
    """``(o, lse)`` of folded ``[BH, L, hd]`` operands: the forward kernel on
    CUDA, its plain version on the CPU."""
    _check(q3, k3, v3, causal)
    if q3.device.type == "cpu":
        return flash_fwd_reference(q3, k3, v3, causal)
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[:2], dtype=torch.float32, device=q3.device)
    args = (q3, k3, v3, o, lse)
    _launch("fwd", _variant("fwd", args), *args,
            q3=q3, Lk=k3.shape[1], causal=causal)
    return o, lse


def flash_dq(q3, k3, v3, lse, do, delta, causal: bool):
    """``dq``: the dq kernel on CUDA, its plain version on the CPU.  ``delta``
    is ``rowsum(do * o)`` minus any lse cotangent, ``[BH, Lq]`` float32."""
    _check(q3, k3, v3, causal, lse, do, delta)
    if q3.device.type == "cpu":
        return flash_dq_reference(q3, k3, v3, lse, do, delta, causal)
    dq = torch.empty_like(q3)
    args = (q3, k3, v3, do, lse, delta, dq)
    _launch("dq", _variant("dq", args), *args,
            q3=q3, Lk=k3.shape[1], causal=causal)
    return dq


def flash_dkv(q3, k3, v3, lse, do, delta, causal: bool):
    """``(dk, dv)``: the dk/dv kernel on CUDA, its plain version on the CPU."""
    _check(q3, k3, v3, causal, lse, do, delta)
    if q3.device.type == "cpu":
        return flash_dkv_reference(q3, k3, v3, lse, do, delta, causal)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    args = (q3, k3, v3, do, lse, delta, dk, dv)
    _launch("dkv", _variant("dkv", args), *args,
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
    # contiguous: at B = 1 the reshape is a strided view, which the kernels
    # refuse (one row per replica and microbatch is the DP x PP path's shape)
    B, L, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, L, hd).contiguous()


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
