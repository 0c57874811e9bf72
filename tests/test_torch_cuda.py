"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips unless an sm_90 (Hopper) device is present.
This file imports torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: |kernel - plain| <= atol + rtol |plain| with
fp32 (1e-4, 0) and bf16 (2e-2, 1e-2), the plain version run in fp32 on the same
bf16-rounded inputs.
"""

import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(a, ref, dtype):
    atol, rtol = TOL[dtype]
    assert ((a.float() - ref.float()).abs() - rtol * ref.float().abs()).max() <= atol


@pytest.mark.parametrize("BH,Lq,Lk,hd,dtype,causal", [
    (18, 256, 256, 48, torch.bfloat16, True),
    (18, 256, 256, 48, torch.float32, True),
    (4, 200, 200, 64, torch.float32, False),
    (2, 130, 130, 32, torch.bfloat16, True),
    (2, 100, 70, 128, torch.float32, False),
])
def test_kernels_match_plain_versions(dev, BH, Lq, Lk, hd, dtype, causal):
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(BH, Lq, hd, generator=g).to(dev, dtype) for _ in range(2))
    k, v = (torch.randn(BH, Lk, hd, generator=g).to(dev, dtype) for _ in range(2))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), causal)
    delta = (do.float() * o_ref).sum(-1)
    dq = fa.flash_dq(q, k, v, lse_ref, do, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, lse_ref, do, delta, causal)
    refs = fa.flash_bwd_reference(q.float(), k.float(), v.float(), lse_ref,
                                  do.float(), delta, causal)
    torch.cuda.synchronize()
    _close(o, o_ref, dtype)
    _close(lse, lse_ref, torch.float32)
    for a, ref in zip((dq, dk, dv), refs):
        _close(a, ref, dtype)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}


def test_cuda_tensors_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 64, 32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(x.half(), x.half(), x.half(), True)
