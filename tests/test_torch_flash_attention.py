"""The port's flash attention against the JAX package's, on the CPU.

The port's autograd Functions run their plain PyTorch versions here (CPU
tensors); the JAX side runs the Pallas kernels in interpret mode.  Same inputs
from a seeded numpy generator, float32.  Tolerances: outputs and lse 2e-5,
gradients 5e-5 (summation order differs: blocked online softmax on both
sides, with different block walks).  The bf16 cases hold the same two sides on
bf16 inputs to bf16's band (see test_flash_bf16_matches_jax).  The kernels
themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from ddl25spring_tpu_torch.ops import flash_attention as fa  # noqa: E402

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2


def _inputs(seed, shape, lk=None, n_extra=1):
    rng = np.random.default_rng(seed)
    B, L, H, hd = shape
    kv_shape = (B, lk or L, H, hd)
    q = rng.standard_normal(shape, dtype=np.float32)
    k = rng.standard_normal(kv_shape, dtype=np.float32)
    v = rng.standard_normal(kv_shape, dtype=np.float32)
    extra = [rng.standard_normal(shape, dtype=np.float32) for _ in range(n_extra)]
    return q, k, v, *extra


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


# shapes of tests/test_flash_attention.py:33-159 (the port has no block sizes,
# so the reference's block variants collapse into these), plus head_dim 48
# (the LLaMA path's), a ragged length and a single head
@pytest.mark.parametrize("shape,causal", [
    ((2, 128, 3, 32), True),
    ((2, 192, 3, 32), True),
    ((2, 256, 3, 32), True),
    ((2, 128, 2, 32), False),
    ((2, 256, 3, 48), True),
    ((1, 200, 1, 48), True),
    ((1, 200, 2, 64), False),
])
def test_flash_matches_jax(shape, causal):
    q, k, v, t = _inputs(0, shape)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True), q, k, v)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)

    want_g = vjp(jnp.asarray(t))
    got_g = _torch_grads(
        lambda q, k, v: (fa.flash_attention(q, k, v, causal=causal)
                         * torch.from_numpy(t)).sum(), (q, k, v))
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)


@pytest.mark.parametrize("shape,causal", [
    ((2, 256, 3, 48), True),
    ((1, 200, 2, 64), False),
])
def test_flash_bf16_matches_jax(shape, causal):
    """The bf16 oracle band: o and the three gradients of the port's plain
    versions on bf16 inputs against the Pallas kernels (interpret mode) on the
    same bf16 inputs, |port - jax| <= 2e-2 + 1e-2 |jax|.  Both round p (and
    in dq and dk/dv ds) to bf16 before the second product of each pair, but
    against different running maxima (64-row KV tiles here, one block there),
    so they differ by about one bf16 ulp.  Measured: max(|port - jax| - 1e-2
    |jax|) is 7.7e-4 (o), 1.6e-3 (dq), 1.8e-3 (dk), 4.5e-5 (dv) at
    (2, 256, 3, 48) causal and at most 1.1e-3 at (1, 200, 2, 64); the largest
    raw difference, 7.8e-3 on a dq and a dk near 1, is one bf16 ulp there.
    dq differs from the JAX dq in 0.10 and 0.16 of its elements; without the
    rounding of ds that the TPU kernel does, 0.42 of them differ."""
    q, k, v, t = _inputs(0, shape)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True),
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(t, dtype=jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    got.backward(torch.from_numpy(t).bfloat16())

    def f32(x):
        return np.asarray(jnp.asarray(x, dtype=jnp.float32))

    np.testing.assert_allclose(got.detach().float().numpy(), f32(want),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    for a, b in zip((tq, tk, tv), want_g):
        np.testing.assert_allclose(a.grad.float().numpy(), f32(b),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
    assert (tq.grad.float().numpy() != f32(want_g[0])).mean() < 0.25


def test_plain_versions_round_p_and_ds_like_the_tpu_kernels():
    """bf16 inputs: the forward's p, dq's ds and dk/dv's p and ds are rounded
    to bf16 before their second product (float32 inputs: nothing is
    rounded)."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 64, 32, generator=g).bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, False)
    s = (q.float() @ k.float().transpose(1, 2)) * 32 ** -0.5
    p = torch.exp(s - lse[..., None])
    # one 64-row KV tile, so the running max is the row max and p is exact
    want_o = (torch.exp(s - s.amax(-1, keepdim=True)).bfloat16().float() @ v.float()
              / torch.exp(s - s.amax(-1, keepdim=True)).sum(-1, keepdim=True))
    assert torch.equal(o, want_o.bfloat16())
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = fa.flash_dkv_reference(q, k, v, lse, do, delta, False)
    dq = fa.flash_dq_reference(q, k, v, lse, do, delta, False)
    ds = p * (do.float() @ v.float().transpose(1, 2) - delta[..., None]) * 32 ** -0.5
    assert torch.equal(dq, (ds.bfloat16().float() @ k.float()).bfloat16())
    assert torch.equal(dv, (p.bfloat16().float().transpose(1, 2) @ do.float()).bfloat16())
    assert torch.equal(dk, (ds.bfloat16().float().transpose(1, 2) @ q.float()).bfloat16())
    o32, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), False)
    assert not torch.equal(o32.bfloat16(), o)  # fp32 inputs: p stays fp32


@pytest.mark.parametrize("causal,lk", [(True, None), (False, None), (False, 96)])
def test_flash_with_lse_matches_jax(causal, lk):
    """Both outputs and the joint (do, dlse) backward, on a loss that mixes o
    and lse as the ring-attention merge does."""
    shape = (2, 128, 2, 32)
    q, k, v, t_o = _inputs(5, shape, lk=lk)
    t_l = np.random.default_rng(6).standard_normal((2, 2, 128), dtype=np.float32)
    (o_w, lse_w), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, causal=causal, interpret=True),
        q, k, v)
    o_g, lse_g = fa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert lse_g.shape == (2, 2, 128)
    np.testing.assert_allclose(o_g.numpy(), np.asarray(o_w), atol=FWD_ATOL)
    np.testing.assert_allclose(lse_g.numpy(), np.asarray(lse_w), atol=FWD_ATOL)

    def torch_loss(q, k, v):
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        return (o * torch.from_numpy(t_o)).sum() + (
            torch.tanh(lse) * torch.from_numpy(t_l)).sum()

    # cotangents of (o * t_o).sum() + (tanh(lse) * t_l).sum()
    want_g = vjp((jnp.asarray(t_o), t_l * (1 - jnp.tanh(lse_w) ** 2)))
    got_g = _torch_grads(torch_loss, (q, k, v))
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, (1, 70, 2, 48)))
    q.requires_grad_()
    before = dict(fa.LAUNCHES)
    before_v = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    fa.flash_attention(q, k, v).backward(do)
    q3 = fa._fold(q)
    o, lse = fa.flash_fwd(q3, q3, q3, True)
    ref_o, ref_lse = fa.flash_fwd_reference(q3, q3, q3, True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert fa.LAUNCHES == before
    assert fa.LAUNCHES_BY_VARIANT == before_v


@pytest.mark.parametrize("B", [1, 3])
def test_fold_hands_the_kernels_contiguous_operands(B):
    """``[B, L, H, hd]`` as the block makes it (a projection viewed as heads)
    folds to a contiguous ``[B*H, L, hd]``, which the CUDA kernels require; at
    B = 1 a bare reshape would be a strided view."""
    h = torch.zeros(B, 64, 96)
    q = (h @ torch.zeros(96, 96)).view(B, 64, 2, 48)
    q3 = fa._fold(q)
    assert q3.shape == (B * 2, 64, 48) and q3.is_contiguous()
    assert torch.equal(q3, q.transpose(1, 2).reshape(B * 2, 64, 48))


def _misaligned(shape, dtype):
    """A contiguous tensor whose data pointer is 2 bytes past 16-byte alignment."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("name,dtype,hd,aligned,want", [
    ("fwd", torch.bfloat16, 48, True, "wgmma"),
    ("dkv", torch.bfloat16, 48, True, "wgmma"),
    ("fwd", torch.bfloat16, 128, True, "wgmma"),
    ("dkv", torch.bfloat16, 16, True, "wgmma"),       # smallest wgmma width
    ("fwd", torch.bfloat16, 80, True, "wgmma"),       # second 64-column box
    ("dkv", torch.bfloat16, 112, True, "wgmma"),
    ("dq", torch.bfloat16, 48, True, "wgmma"),
    ("dq", torch.bfloat16, 16, True, "wgmma"),
    ("dq", torch.bfloat16, 80, True, "wgmma"),
    ("dq", torch.bfloat16, 112, True, "wgmma"),
    ("dq", torch.float32, 48, True, "tf32x3"),       # fp32 backward: 3xTF32
    ("dq", torch.bfloat16, 36, True, "scalar"),
    ("dq", torch.bfloat16, 48, False, "scalar"),
    ("fwd", torch.float32, 48, True, "tf32x3"),       # the fp32 forward: 3xTF32 too
    ("dkv", torch.float32, 64, True, "tf32x3"),
    ("fwd", torch.bfloat16, 36, True, "scalar"),      # TMA: hd a multiple of 8
    ("dkv", torch.bfloat16, 48, False, "scalar"),     # TMA: 16-byte aligned data
    ("dkv", torch.float32, 20, True, "tf32x3"),       # cp.async: hd a multiple of 4
    ("dq", torch.float32, 128, True, "tf32x3"),
    ("fwd", torch.float32, 64, True, "tf32x3"),
    ("fwd", torch.float32, 18, True, "scalar"),       # rows not 16-byte strided
    ("fwd", torch.float32, 48, False, "scalar"),      # cp.async: 16-byte aligned data
    ("dq", torch.float32, 18, True, "scalar"),        # rows not 16-byte strided
    ("dkv", torch.float32, 18, True, "scalar"),
    ("dq", torch.float32, 48, False, "scalar"),       # cp.async: 16-byte aligned data
    ("dkv", torch.float32, 64, False, "scalar"),
])
def test_dispatch_rule(name, dtype, hd, aligned, want):
    """Which variant a CUDA launch would take: the rule of the module
    docstring, decided from dtype, head_dim and pointers alone."""
    x = torch.zeros(2, 64, hd, dtype=dtype) if aligned else _misaligned((2, 64, hd), dtype)
    assert fa._variant(name, (x, torch.zeros(2, 64, hd, dtype=dtype))) == want


def _tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (add half of the dropped 13 bits, then clear
    them; the sign bit is apart, so this holds for negatives too)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_is_rna():
    """The emulation against hand-made bit patterns: below, at and above the
    halfway point, and a tie on a negative value."""
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    x = (one + torch.tensor([0x0FFF, 0x1000, 0x1001, 0x3000], dtype=torch.int32)).view(torch.float32)
    got = _tf32(x).view(torch.int32) - one
    assert got.tolist() == [0, 0x2000, 0x2000, 0x4000]
    assert _tf32(-x).tolist() == (-_tf32(x)).tolist()


def test_tf32x3_split():
    """Why the fp32 backward kernels split each operand (``csrc/
    flash_attention_tf32x3.cu``): on a seeded ``[64, 48] x [48, 64]`` tile,
    against float64, one TF32 product misses the fp32 kernels' tolerance of
    1e-4, while ``lo hi' + hi lo' + hi hi'`` (hi = tf32(x), lo = tf32(x -
    hi); each product of TF32 values exact in fp32, summed in fp32, as the
    tensor cores do) holds within 1e-6 of the tile's scale, max |a b|, no
    worse than 2x the plain fp32 product's own rounding error."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 48), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((48, 64), dtype=np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    # hi + lo gives back all but ~2^-22 of each value
    assert ((a_hi.double() + a_lo.double() - a.double()).abs() <= 2.0 ** -21 * a.abs()).all()
    one = (a_hi @ b_hi).double()
    three = (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).double()
    plain = (a @ b).double()
    assert (one - exact).abs().max().item() > 1e-4
    err = (three - exact).abs().max().item()
    assert err <= 1e-6 * scale
    assert err <= 2 * (plain - exact).abs().max().item()


LOG2E = 1.4426950408889634


def _mm3(a, b):
    """``a @ b`` as the tf32x3 kernels take it: ``lo hi' + hi lo' + hi hi'``."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    return _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + a_hi @ b_hi


def _fwd_tf32x3_design(q, k, v, causal, own=32, warps=8):
    """``flash_fwd_tf32x3``'s arithmetic in torch: blocks of ``own`` query
    rows, whose warps take 16 rows each times a quarter (``span`` keys) of
    each 64-row KV tile up to the block's last row (causal); each warp keeps an
    online state in log2 units, skips a quarter wholly above the diagonal or
    past Lk and zeroes p under the mask; the states of each row are merged in
    the order of the quarters, scaled to their common max."""
    BH, Lq, hd = q.shape
    Lk = k.shape[1]
    sl2 = hd ** -0.5 * LOG2E
    wn = warps // (own // 16)
    span = fa.TILE // wn
    o, lse = torch.empty_like(q), torch.empty(BH, Lq)
    for q0 in range(0, Lq, own):
        kv_end = min(Lk, q0 + own) if causal else Lk
        for r0 in range(q0, min(q0 + own, Lq), 16):
            qb = q[:, r0:r0 + 16]
            rows = torch.arange(r0, r0 + qb.shape[1])[:, None]
            states = []
            for w in range(wn):
                m = torch.full((BH, qb.shape[1]), fa.NEG_INF)
                l, acc = torch.zeros_like(m), torch.zeros_like(qb)
                for c0 in range(w * span, kv_end, fa.TILE):
                    if c0 >= Lk or (causal and c0 > r0 + 15):
                        continue
                    kb, vb = k[:, c0:c0 + span], v[:, c0:c0 + span]
                    cols = torch.arange(c0, c0 + kb.shape[1])[None, :]
                    live = (cols <= rows) if causal else torch.ones_like(cols, dtype=bool)
                    s = (_mm3(qb, kb.transpose(1, 2)) * sl2).masked_fill(~live, fa.NEG_INF)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[..., None]).masked_fill(~live, 0.0)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + _mm3(p, vb)
                    m = m_new
                states.append((m, l, acc))
            mt = torch.stack([m for m, _, _ in states]).amax(0)
            l_sum, o_sum = 0.0, 0.0
            for m, l, acc in states:
                c = torch.exp2(m - mt)
                l_sum, o_sum = l_sum + c * l, o_sum + c[..., None] * acc
            o[:, r0:r0 + 16] = o_sum / l_sum[..., None]
            lse[:, r0:r0 + 16] = mt / LOG2E + torch.log(l_sum)
    return o, lse


def test_tf32x3_forward_design():
    """The fp32 forward kernel's design, emulated in torch on a seeded causal
    ``[2, 130, 48]``: quarter-span warp states (rows 0-15 see no key of
    quarters 1-3 of the first tile: those states stay empty and weigh 0 in
    the merge), 3xTF32 products, the fixed-order merge.  Within 1e-5 of
    ``flash_fwd_reference`` and 1e-4 of the JAX forward (Pallas in
    interpret mode)."""
    q, k, v = _inputs(7, (1, 130, 2, 48), n_extra=0)
    tq, tk, tv = (fa._fold(torch.from_numpy(a)) for a in (q, k, v))
    o, lse = _fwd_tf32x3_design(tq, tk, tv, True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    o_ref, lse_ref = fa.flash_fwd_reference(tq, tk, tv, True)
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5
    o_j, lse_j = jax_flash_lse(q, k, v, causal=True, interpret=True)
    np.testing.assert_allclose(o.view(1, 2, 130, 48).transpose(1, 2).numpy(), np.asarray(o_j),
                               atol=1e-4)
    np.testing.assert_allclose(lse.view(1, 2, 130).numpy(), np.asarray(lse_j), atol=1e-4)


def test_reset_launches():
    fa.LAUNCHES["fwd"] += 2
    fa.LAUNCHES_BY_VARIANT["dkv"]["wgmma"] += 1
    fa.reset_launches()
    assert set(fa.LAUNCHES.values()) == {0}
    assert all(set(c.values()) == {0} for c in fa.LAUNCHES_BY_VARIANT.values())


_X = torch.zeros(2, 64, 32)
_Y = torch.zeros(2, 48, 32)
_ROWS = torch.zeros(2, 64)


@pytest.mark.parametrize("call,exc,match", [
    (lambda: fa.flash_fwd(_X, _Y, _Y, True), ValueError, "square"),
    (lambda: fa.flash_attention_with_lse(_X.view(1, 64, 2, 32), _Y.view(1, 48, 2, 32),
                                         _Y.view(1, 48, 2, 32)), ValueError, "square"),
    (lambda: fa.flash_fwd(*[torch.zeros(2, 64, 160)] * 3, True), ValueError,
     "head_dim"),
    (lambda: fa.flash_fwd(_X.half(), _X.half(), _X.half(), True), TypeError,
     "float32 or bfloat16"),
    (lambda: fa.flash_dq(_X, _X, _X, _ROWS[:, :10], _X, _ROWS, True), ValueError,
     "lse must be"),
    (lambda: fa.flash_dkv(_X, _X, _X, _ROWS, _X[:, :8], _ROWS, True), ValueError,
     "do "),
], ids=["causal-rect", "with-lse-causal-rect", "head-dim", "dtype", "lse-shape",
        "do-shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc, match):
    with pytest.raises(exc, match=match):
        call()
