"""The port's CUDA kernels against their plain PyTorch versions, on the card,
the fp32 kernels (tf32x3: forward, dq and dk/dv) bitwise across two calls and
the fp32 shapes off their rule on the scalar variant, the launches of every pipeline
schedule on the card, the ResNet-18 slice's
card-only checks (the on-card dataset, fp32 against
the CPU, bf16 channels_last against fp32), federated learning's
(``MnistCnn`` and one FedAvg round on the card against the CPU), one
flash-ring and one TP step on the card against the CPU, a switch-MoE
LLaMA step (top 1 and 2) and the EP layer on the card, one EP x DP x PP
and one DP x PP x TP step on the card against the CPU, and the sentinel's
``skip`` on the card, eager and inside a CUDA graph (chip_smoke phase 16 (a)
and (b), small), the serving engine graphed against eager: plain,
speculative and elastic (phases 18 (a), 19 (a) and (c), small), and TP
serving from 2 ranks on the card, resident, streamed and speculative, against
the single-card engine (phase 20 (a), small), the bench's telemetry on the
card with the training losses and the engine's streams and pool bitwise with
the memory sampler and the goodput meter on and off (phase 21, small), and
the bench's retry half on the card: the device probe, the native stream's
pinned feed against the loader's batches, a resume that lands in the tensors
a CUDA graph captured (phase 22, small).

Marked ``gpu``: each test skips unless an sm_90 (Hopper) device is present,
but for the FL entry points' refusal of a missing GPU, which runs anywhere.
This file imports torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: |kernel - plain| <= atol + rtol |plain| with
fp32 (1e-4, 0) and bf16 (2e-2, 1e-2), the plain version run on the same inputs
(it computes in fp32 and rounds p and ds to bf16 where the kernels do).
"""

import numpy as np
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


def _variant_runs(before):
    return {n: {v: c - before[n][v] for v, c in counts.items() if c != before[n][v]}
            for n, counts in fa.LAUNCHES_BY_VARIANT.items()}


def _run_case(dev, BH, Lq, Lk, hd, dtype, causal):
    """Each kernel against its plain version; returns the launches by variant."""
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(BH, Lq, hd, generator=g).to(dev, dtype) for _ in range(2))
    k, v = (torch.randn(BH, Lk, hd, generator=g).to(dev, dtype) for _ in range(2))
    before = dict(fa.LAUNCHES)
    before_v = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, lse_ref, do, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, lse_ref, do, delta, causal)
    refs = fa.flash_bwd_reference(q, k, v, lse_ref, do, delta, causal)
    torch.cuda.synchronize()
    _close(o, o_ref, dtype)
    _close(lse, lse_ref, torch.float32)
    for a, ref in zip((dq, dk, dv), refs):
        _close(a, ref, dtype)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    return _variant_runs(before_v)


@pytest.mark.parametrize("BH,Lq,Lk,hd,dtype,causal", [
    (18, 256, 256, 48, torch.bfloat16, True),
    (18, 256, 256, 48, torch.float32, True),
    (4, 200, 200, 64, torch.float32, False),
    (2, 130, 130, 32, torch.bfloat16, True),
    (2, 100, 70, 128, torch.float32, False),
    # the tensor-core variants: head dims, a ragged tail, a length below one
    # tile, non-causal non-square
    (4, 256, 256, 40, torch.bfloat16, True),
    (4, 256, 256, 64, torch.bfloat16, True),
    (2, 256, 256, 128, torch.bfloat16, True),
    (4, 200, 200, 48, torch.bfloat16, True),
    (3, 17, 17, 48, torch.bfloat16, True),
    (4, 256, 192, 48, torch.bfloat16, False),
    # every wgmma width of the second products: N = 16 (hd 16; box 1 at hd
    # 80), 32 and 48 in box 1 (hd 96, 112)
    (2, 256, 256, 16, torch.bfloat16, True),
    (2, 256, 256, 80, torch.bfloat16, True),
    (2, 256, 256, 96, torch.bfloat16, True),
    (2, 256, 256, 112, torch.bfloat16, True),
    (2, 256, 192, 16, torch.bfloat16, False),
    (2, 200, 200, 112, torch.bfloat16, False),
    (2, 100, 100, 36, torch.bfloat16, True),  # hd not a multiple of 8: scalar bf16
    (18, 256, 256, 36, torch.bfloat16, False),
    # odd lengths with BH = 2: a TMA box or a plain load at bh * L + row with
    # L not a multiple of 4 (an unaligned start) must still be right
    (2, 17, 17, 48, torch.bfloat16, True),
    (2, 17, 17, 48, torch.bfloat16, False),
    (2, 66, 66, 48, torch.bfloat16, True),
    (2, 66, 66, 48, torch.bfloat16, False),
    (2, 130, 130, 48, torch.bfloat16, True),
    (2, 130, 130, 48, torch.bfloat16, False),
    # fp32 on tf32x3: padded widths (hd 20 pads to 32), odd lengths, Lk != Lq
    (2, 17, 17, 16, torch.float32, True),
    (2, 100, 100, 20, torch.float32, True),
    (2, 66, 66, 80, torch.float32, False),
    (2, 130, 130, 112, torch.float32, True),
    (3, 17, 40, 36, torch.float32, False),
])
def test_kernels_match_plain_versions(dev, BH, Lq, Lk, hd, dtype, causal):
    runs = _run_case(dev, BH, Lq, Lk, hd, dtype, causal)
    assert runs == {n: {_want(n, dtype, hd): 1} for n in ("fwd", "dq", "dkv")}


def _want(name, dtype, hd):
    """The variant of the dispatch rule for aligned operands."""
    if dtype == torch.bfloat16:
        return "wgmma" if hd % 8 == 0 else "scalar"
    return "tf32x3" if hd % 4 == 0 else "scalar"


def test_main_shape_dispatch(dev):
    """At the LLaMA path's shape bf16 goes to the wgmma kernels and fp32 to
    the tf32x3 kernels."""
    for dtype, want in ((torch.bfloat16, ("wgmma",) * 3),
                        (torch.float32, ("tf32x3",) * 3)):
        x = torch.randn(18, 256, 48, device=dev).to(dtype)
        before = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}
        o, lse = fa.flash_fwd(x, x, x, True)
        fa.flash_dq(x, x, x, lse, x, lse, True)
        fa.flash_dkv(x, x, x, lse, x, lse, True)
        torch.cuda.synchronize()
        assert _variant_runs(before) == {n: {w: 1} for n, w in zip(("fwd", "dq", "dkv"), want)}


@pytest.mark.parametrize("BH,Lq,Lk,hd,causal", [
    (18, 256, 256, 48, True),
    (2, 130, 130, 128, True),
    (3, 17, 40, 36, False),
])
def test_fp32_kernels_are_bitwise_repeatable(dev, BH, Lq, Lk, hd, causal):
    """The tf32x3 forward (o and lse), dq and dk/dv use no atomics: two calls
    on the same inputs give the same bits (the bitwise resume of chip_smoke
    phase 17 needs it)."""
    g = torch.Generator().manual_seed(2)
    q, do = (torch.randn(BH, Lq, hd, generator=g).to(dev) for _ in range(2))
    k, v = (torch.randn(BH, Lk, hd, generator=g).to(dev) for _ in range(2))
    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = (do * o).sum(-1)
    before = {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()}

    def run():
        return (*fa.flash_fwd(q, k, v, causal), fa.flash_dq(q, k, v, lse, do, delta, causal),
                *fa.flash_dkv(q, k, v, lse, do, delta, causal))

    first, second = run(), run()
    torch.cuda.synchronize()
    assert _variant_runs(before) == {n: {"tf32x3": 2} for n in ("fwd", "dq", "dkv")}
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("hd,aligned", [(18, True), (48, False)])
def test_fp32_backward_off_the_rule_runs_on_the_scalar_variant(dev, hd, aligned):
    """fp32 at head_dim 18 (rows not 16-byte strided) or 4 bytes past
    16-byte alignment is no ``cp.async`` source: the forward, dq and dk/dv
    go to the scalar kernels, which are right."""
    g = torch.Generator().manual_seed(3)
    n = 2 * 66 * hd
    q, k, v, do = ((torch.randn(n + 4, generator=g).to(dev)[(0 if aligned else 1):][:n]
                    .view(2, 66, hd)) for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v, True)
    delta = (do * o).sum(-1)
    before = {n_: dict(c) for n_, c in fa.LAUNCHES_BY_VARIANT.items()}
    got = (*fa.flash_fwd(q, k, v, True), fa.flash_dq(q, k, v, lse, do, delta, True),
           *fa.flash_dkv(q, k, v, lse, do, delta, True))
    refs = (o, lse, *fa.flash_bwd_reference(q, k, v, lse, do, delta, True))
    torch.cuda.synchronize()
    assert _variant_runs(before) == {n_: {"scalar": 1} for n_ in ("fwd", "dq", "dkv")}
    for a, ref in zip(got, refs):
        _close(a, ref, torch.float32)


def test_misaligned_bf16_runs_on_the_scalar_variant(dev):
    """A contiguous bf16 view 2 bytes past 16-byte alignment cannot be a TMA
    source: the dispatch sends it to the scalar kernels, which are right."""
    g = torch.Generator().manual_seed(1)
    n = 2 * 64 * 48
    q, k, v, do = (torch.randn(n + 8, generator=g).to(dev, torch.bfloat16)[1:n + 1]
                   .view(2, 64, 48) for _ in range(4))
    before = {n_: dict(c) for n_, c in fa.LAUNCHES_BY_VARIANT.items()}
    o, lse = fa.flash_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, lse_ref, do, delta, True)
    dq_ref = fa.flash_dq_reference(q, k, v, lse_ref, do, delta, True)
    torch.cuda.synchronize()
    _close(o, o_ref, torch.bfloat16)
    _close(lse, lse_ref, torch.float32)
    _close(dq, dq_ref, torch.bfloat16)
    runs = _variant_runs(before)
    assert runs["fwd"] == {"scalar": 1} and runs["dq"] == {"scalar": 1}


def test_one_row_batch_runs_the_kernels(dev):
    """B = 1 (one row per replica and microbatch on the DP x PP path): the
    folded operands are contiguous and the Function runs the kernels."""
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(1, 256, 6, 48, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    before = dict(fa.LAUNCHES)
    got = []
    for device in (dev, "cpu"):
        qd, kd, vd = (x.to(device).requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(qd, kd, vd)
        o.backward(do.to(device))
        got.append([t.detach().cpu() for t in (o, qd.grad, kd.grad, vd.grad)])
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    for a, ref in zip(*got):
        _close(a, ref, torch.bfloat16)


def test_cuda_tensors_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 64, 32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(x.half(), x.half(), x.half(), True)


DP_CFG = dict(vocab_size=256, dmodel=64, num_heads=2, n_layers=2, ctx_size=64,
              dtype="float32", use_flash=True)


def _dp_batches():
    g = torch.Generator().manual_seed(4)
    return [torch.randint(0, 256, (4, 64), generator=g) for _ in range(2)]


def _loss(model, tokens):
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    return causal_lm_loss(model(tokens), tokens)


def dp_rank_on_the_card(rdv):
    """One rank of a 2-rank DP world on the layout's card: 2 Adam steps of the
    bucketed ``make_dp_train_step``; the losses, the first step's gradients."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with init_mesh(rdv, data=2, stages=1, device="cuda") as mesh:
        model = Llama(LlamaConfig(**DP_CFG), device=mesh.device,
                      generator=torch.Generator().manual_seed(3))
        step = make_dp_train_step(model, _loss, torch.optim.Adam(model.parameters(), lr=8e-4),
                                  mesh)
        losses, grads = [], []
        for b in _dp_batches():
            losses.append(step(b).item())
            grads.append(export_grads(model))
        return {"backend": mesh.backend, "device": str(mesh.device), "losses": losses,
                "grads": grads[0], "launches": dict(fa.LAUNCHES)}


def test_dp_step_of_two_ranks_equals_one_process(dev, tmp_path):
    """2 DP ranks on the card (six-rank runs share one card the same way:
    gloo through pinned host buffers when the ranks outnumber the cards)
    against a single-process step on the whole batch: first loss rtol 1e-5,
    gradients atol 2e-4 + rtol 2e-3, the second loss rtol 1e-4."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import select_backend

    ranks = spawn(dp_rank_on_the_card, 2, timeout=120, tmpdir=str(tmp_path))
    model = Llama(LlamaConfig(**DP_CFG), device=dev, generator=torch.Generator().manual_seed(3))
    step = make_train_step(model, _loss, torch.optim.Adam(model.parameters(), lr=8e-4))
    losses, grads = [], []
    for b in _dp_batches():
        losses.append(step(b.to(dev)).item())
        grads.append(export_grads(model))
    backend = select_backend("cuda", 2, torch.cuda.device_count())
    for r in ranks:
        assert r["backend"] == backend and r["device"].startswith("cuda")
        assert r["launches"] == {"fwd": 4, "dq": 4, "dkv": 4}  # 2 layers x 2 steps
        assert r["losses"][0] == pytest.approx(losses[0], rel=1e-5)
        assert r["losses"][1] == pytest.approx(losses[1], rel=1e-4)
        for (path, a), (_, b) in zip(flatten(r["grads"]), flatten(grads[0])):
            assert (abs(a - b) - 2e-3 * abs(b)).max() <= 2e-4, path


SCHED_CFG = dict(vocab_size=256, dmodel=64, num_heads=2, n_layers=6, ctx_size=64,
                 dtype="bfloat16", use_flash=True)
SCHEDULES = ("gpipe", "1f1b", "1f1b-stash", "interleaved", "interleaved-1f1b")


def schedules_rank_on_the_card(rdv):
    """One rank of a 1 x 3 world on the card: 2 bf16 steps of every schedule
    (2 chunks per rank when interleaved), M = 3 one-row microbatches; the
    flash launches by kernel and variant of each schedule and its losses."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_params
    from ddl25spring_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_staged_params,
    )
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    cfg = LlamaConfig(**SCHED_CFG)
    params = export_params(Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
    tokens = torch.randint(0, 256, (3, 64), generator=torch.Generator().manual_seed(6))
    out = {}
    with init_mesh(rdv, data=1, stages=3, device="cuda") as mesh:
        for name in SCHEDULES:
            V = 2 if name.startswith("interleaved") else 1
            stage = shard_staged_params(params, cfg, mesh, V)
            step = make_pipeline_train_step(stage, cfg, torch.optim.SGD(stage.parameters(),
                                                                        lr=0.1),
                                            mesh, 3, name, V)
            fa.reset_launches()
            losses = [step(tokens) for _ in range(2)]
            torch.cuda.synchronize()
            out[name] = {"launches": dict(fa.LAUNCHES),
                         "by_variant": {n: dict(c) for n, c in fa.LAUNCHES_BY_VARIANT.items()},
                         "losses": [None if x is None else x.item() for x in losses],
                         "stash": step.stats["stash_max"]}
    return out


@pytest.fixture(scope="module")
def schedule_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    from ddl25spring_tpu_torch.parallel.launch import spawn

    return spawn(schedules_rank_on_the_card, 3, timeout=300,
                 tmpdir=str(tmp_path_factory.mktemp("rdv")))


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_launches_on_the_card(schedule_world, name):
    """Per rank, 2 steps of 3 microbatches over 2 layers: dq and dk/dv 6 a
    step, the forward 6, or 12 under the schedules that recompute it (1f1b,
    interleaved-1f1b); every launch on the tensor cores."""
    fwd = 12 if name in ("1f1b", "interleaved-1f1b") else 6
    want = {"fwd": 2 * fwd, "dq": 12, "dkv": 12}
    for r in schedule_world:
        got = r[name]
        assert got["launches"] == want
        assert all(got["by_variant"][n] == {"wgmma": want[n], "tf32x3": 0, "scalar": 0}
                   for n in want)
    losses = schedule_world[-1][name]["losses"]
    assert all(np.isfinite(losses))
    ref = schedule_world[-1]["gpipe"]["losses"]
    assert losses == pytest.approx(ref, rel=2e-2)  # bf16: the same step to rounding


# ------------------------------------------------------------ ResNet-18 slice


def test_device_dataset_on_the_card(dev):
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset

    ds = DeviceDataset(64, n_train=256, device=dev)
    assert ds.x.device.type == "cuda" and ds.x.dtype == torch.uint8
    ds.cursor = 0
    epochs = []
    for _ in range(2):
        xs, ys = zip(*(ds.feed() for _ in range(ds.batches_per_epoch)))
        assert all(x.device.type == "cuda" and x.shape == (64, 32, 32, 3) for x in xs)
        flat = torch.cat(xs).reshape(256, -1)
        # every row of the split once per epoch (n = 4 batches exactly)
        assert torch.equal(flat.sort(0).values, ds.x.reshape(256, -1).sort(0).values)
        epochs.append(torch.cat(ys))
    assert not torch.equal(epochs[0], epochs[1])


def test_resnet_fp32_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One SGD step of ResNet18(norm="group") at width 16 on the card (cuDNN,
    channels_last, TF32 off) against the same step on the CPU: loss, logits
    and updated weights within 1e-4 relative of max |ref|."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset, _nchw
    from ddl25spring_tpu_torch.models.resnet import ResNet18, export_params
    from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x_u8, y = DeviceDataset(8, n_train=64, device="cpu").fixed

    def run(device):
        m = ResNet18(norm="group", width=16, generator=torch.Generator().manual_seed(4))
        m = m.to(device, memory_format=torch.channels_last if device.type == "cuda"
                 else torch.preserve_format)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        logits = m(_nchw(x_u8.to(device), torch.float32))
        loss = cross_entropy_logits(logits, y.to(device))
        loss.backward()
        opt.step()
        return loss.item(), logits.detach().cpu(), export_params(m)

    got, want = run(dev), run(torch.device("cpu"))
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    assert (got[1] - want[1]).abs().max() <= 1e-4 * want[1].abs().max()
    for (path, a), (_, b) in zip(flatten(got[2]), flatten(want[2])):
        assert abs(a - b).max() <= 1e-4 * abs(b).max() + 1e-7, path


def test_resnet_bf16_channels_last_logits_near_fp32(dev, monkeypatch):
    """Full-width bf16 logits (channels_last, cuDNN) within 2e-2 + 1e-2 |ref|
    of the float32 logits of the same weights on the card."""
    from ddl25spring_tpu_torch.benchmarks import DeviceDataset, _nchw
    from ddl25spring_tpu_torch.models.resnet import ResNet18

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x_u8, _ = DeviceDataset(16, n_train=64, device="cpu").fixed
    x_u8 = x_u8.to(dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = ResNet18(norm="group", dtype=dtype, generator=torch.Generator().manual_seed(5))
        m = m.to(dev, memory_format=torch.channels_last)
        with torch.no_grad():
            out[dtype] = m(_nchw(x_u8, dtype))
    assert out[torch.bfloat16].dtype == torch.float32  # the head computes in float32
    _close(out[torch.bfloat16], out[torch.float32], torch.bfloat16)


# ------------------------------------------------------- federated learning


def _fl_leaf_close(got: dict, want: dict, rel: float):
    for name, a in got.items():
        b = want[name]
        assert a.device.type == "cuda" and b.device.type == "cpu"
        assert (a.cpu() - b).abs().max() <= rel * b.abs().max() + 1e-7, name


def test_mnist_cnn_forward_and_backward_on_the_card(dev, monkeypatch):
    """MnistCnn's logits and gradients on the card (cuDNN, TF32 off), with
    the same dropout masks, against the CPU: within 1e-4 of max |ref|."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.models.mnist_cnn import MnistCnn
    from ddl25spring_tpu_torch.ops.losses import nll_loss

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    d = load_mnist(n_train=64, n_test=8)
    x, y = torch.from_numpy(d["x_train"][:32]), torch.from_numpy(d["y_train"][:32]).long()
    out = {}
    for device in (dev, torch.device("cpu")):
        m = MnistCnn(generator=torch.Generator().manual_seed(2)).to(device)
        masks = tuple(t.to(device) for t in m.dropout_masks(32, torch.Generator().manual_seed(3)))
        logits = m(x.to(device), masks)
        nll_loss(logits, y.to(device)).backward()
        out[device.type] = (logits.detach(), {n: p.grad for n, p in m.named_parameters()})
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert (lc.cpu() - lh).abs().max() <= 1e-4 * lh.abs().max()
    _fl_leaf_close(gc, gh, 1e-3)


def test_fedavg_round_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One FedAvg round (N=4, C=0.5, B=16, E=1, dropout on) on the card and on
    the CPU from the same weights, both drawing from CPU generators: every
    leaf within 1e-3 of its max |CPU| (a relu or max-pool tie at fp32
    rounding may branch the other way on the other device)."""
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.fl import FedAvgServer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    data = load_mnist(n_train=200, n_test=50)
    servers = [FedAvgServer(nr_clients=4, client_fraction=0.5, batch_size=16, nr_local_epochs=1,
                            lr=0.01, seed=10, data=data, device=device, generator_device="cpu")
               for device in (dev, "cpu")]
    for s in servers:
        s.round(0)
    _fl_leaf_close(servers[0].params, servers[1].params, 1e-3)


def test_fl_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu():
    """Runs everywhere: without a GPU the FL entry points refuse the default
    device and run when asked for the CPU."""
    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.data.mnist import load_mnist
    from ddl25spring_tpu_torch.examples import homework1_a1_equivalence, vfl_and_generative_fl
    from ddl25spring_tpu_torch.fl import (
        FedAvgServer,
        FedSgdGradientServer,
        TabularVAE,
        VFLNetwork,
        train_evaluator,
    )

    data = load_mnist(n_train=40, n_test=10)
    kw = dict(nr_clients=2, client_fraction=0.5, batch_size=-1, nr_local_epochs=1, lr=0.01,
              data=data)
    assert FedAvgServer(**kw, device="cpu").params["Conv_0.weight"].device.type == "cpu"
    x, y = data["x_test"].reshape(10, -1)[:, :8], data["y_test"] % 2
    entry_points = [
        lambda **d: FedAvgServer(**kw, **d),
        lambda **d: FedSgdGradientServer(**kw, **d),
        lambda **d: VFLNetwork([np.arange(4), np.arange(4, 8)], **d),
        lambda **d: TabularVAE(8, **d),
        lambda **d: train_evaluator(x, y, x, y, epochs=1, **d),
    ]
    for make in entry_points:
        make(device="cpu")
    if torch.cuda.is_available():
        return
    for make in entry_points:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.fedavg_secondary(n_rounds=1, n_train=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        homework1_a1_equivalence.main(["--n-train", "40", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vfl_and_generative_fl.main(["--epochs", "1", "--vae-epochs", "1"])


# ------------------------------------------------------- K steps per dispatch


def _fused_llama(dev, bf16):
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(**{**DP_CFG, "dtype": "bfloat16" if bf16 else "float32"})
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(6))
    opt = torch.optim.Adam(model.parameters(), lr=8e-4, capturable=True)
    return model, opt, make_train_step(model, _loss, opt)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_graph_equals_sequential_steps(dev, bf16):
    """``fuse_train_steps(step, 3)`` on the card is one CUDA graph: its
    replay runs the same kernels on the same inputs as 3 eager steps from the
    same weights (capturable Adam on both sides), so losses and parameters
    agree to 1e-6; the graph holds 3 steps x 2 layers of each flash kernel
    (``CAPTURED``), and its replays move no eager counter."""
    from ddl25spring_tpu_torch.parallel.pipeline import fuse_train_steps

    g = torch.Generator().manual_seed(8)
    window = torch.randint(0, 256, (3, 4, 64), generator=g).to(dev)
    model, _, step = _fused_llama(dev, bf16)
    seq = torch.stack([step(window[i]) for i in range(3)])
    fmodel, fopt, fstep = _fused_llama(dev, bf16)
    fa.reset_launches()
    multi = fuse_train_steps(fstep, 3, module=fmodel, optimizer=fopt, device=dev)
    fused = multi(window)
    eager = dict(fa.LAUNCHES)
    assert multi.graph is not None
    want = {n: {"wgmma" if bf16 else "tf32x3": 6} for n in fa.CAPTURED}
    assert {n: {v: c for v, c in by.items() if c} for n, by in fa.CAPTURED.items()} == want
    torch.cuda.synchronize()
    assert (fused - seq).abs().max().item() <= 1e-6
    for a, b in zip(model.parameters(), fmodel.parameters()):
        assert (a - b).abs().max().item() <= 1e-6
    multi(window)  # a second replay
    torch.cuda.synchronize()
    assert dict(fa.LAUNCHES) == eager  # only the warm-up launched eagerly
    with pytest.raises(ValueError, match="window of 2"):
        multi(window[:2])
    with pytest.raises(ValueError, match="captured for a window tensor"):
        multi(window[:, :2])


def test_explicit_hbm_scan_on_ranks_sharing_the_card_raises(dev):
    """Four ResNet ranks on one card talk over gloo through host buffers,
    which a CUDA graph cannot hold: an explicit ``--input hbm-scan`` raises
    before any rank starts, and ``auto`` takes ``hbm``."""
    from ddl25spring_tpu_torch.lab import dp_pp

    with pytest.raises(ValueError, match="host copy"):
        dp_pp.main(["--workload", "resnet", "--pp", "--ranks", "4", "--input", "hbm-scan"])
    assert dp_pp.resnet_input("auto", 0, dev, 4, 256)[:2] == ("hbm", 1)
    assert dp_pp.resnet_input("auto", 0, dev, 1, 1024)[:2] == ("hbm-scan", 16)


# ------------------------------------------- sequence and tensor parallelism


def sp_tp_rank(rdv, device):
    """One rank of a 2-rank world on ``device``: one step (SGD at lr 0, which
    leaves the weights) of the flash ring over ``seq = 2`` and of TP over
    ``model = 2`` (vocab-sharded), fp32 ``DP_CFG``; the losses, the synced
    gradients and each step's flash launches."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
    from ddl25spring_tpu_torch.parallel import sp, tp
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    cfg = LlamaConfig(**DP_CFG)
    params = export_params(Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(3)))
    tokens = _dp_batches()[0]
    out = {}
    with init_mesh(rdv, 1, seq=2, device=device) as mesh:
        for name, m in (("sp", mesh), ("tp", mesh.regrid(1, model=2))):
            model = Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(3))
            if name == "sp":
                step = sp.make_sp_train_step(model, cfg, torch.optim.SGD(model.parameters(),
                                                                         lr=0.0), m)
            else:
                tp.load_tp_params(model, tp.shard_tp_params(params, 2, m.axis("model").index))
                step = tp.make_tp_train_step(model, cfg, torch.optim.SGD(model.parameters(),
                                                                         lr=0.0), m)
            fa.reset_launches()
            loss = step(tokens).item()
            out[name] = {"loss": loss, "grads": export_grads(model),
                         "launches": dict(fa.LAUNCHES), "device": str(mesh.device)}
    return out


@pytest.mark.parametrize("name", ["sp", "tp"])
def test_sp_and_tp_steps_on_the_card_match_the_cpu(dev, tmp_path, name):
    """The flash ring (index s launches each kernel (1 + s) x 2 layers) and
    TP (2 each) on the card against the same world on the CPU, where the
    plain versions run: loss rtol 1e-5, gradients atol 2e-4 + rtol 2e-3."""
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.launch import spawn

    card = spawn(sp_tp_rank, 2, "cuda", timeout=300, tmpdir=str(tmp_path))
    host = spawn(sp_tp_rank, 2, "cpu", timeout=300, tmpdir=str(tmp_path))
    for s, (c, h) in enumerate(zip(card, host)):
        c, h = c[name], h[name]
        assert c["device"].startswith("cuda")
        n = 2 * (1 + s) if name == "sp" else 2
        assert c["launches"] == {"fwd": n, "dq": n, "dkv": n}
        assert c["loss"] == pytest.approx(h["loss"], rel=1e-5)
        for (path, a), (_, b) in zip(flatten(c["grads"]), flatten(h["grads"])):
            assert (abs(a - b) - 2e-3 * abs(b)).max() <= 2e-4, path


# ------------------------------------------------ switch-MoE and EP


def _moe_loss_grads(cfg, device, tokens):
    """``causal_lm_loss + w aux`` of the MoE model from seed 3 on ``device``,
    its gradients and each layer's float32 router logits."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, llama_forward_with_aux
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.parallel import ep

    model = Llama(cfg, device=device, generator=torch.Generator().manual_seed(3))
    logs = []

    def moe_fn(mp, flat):
        logs.append(ep.router_logits(mp["router"], flat).detach().cpu())
        return ep.moe_ffn(mp, flat, cfg.capacity_factor, top_k=cfg.moe_top_k)

    tokens = tokens.to(device)
    logits, aux = llama_forward_with_aux(model, tokens, cfg, moe_fn=moe_fn)
    loss = causal_lm_loss(logits, tokens) + cfg.moe_aux_weight * aux
    loss.backward()
    return loss.item(), export_grads(model), logs


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_step_on_the_card_matches_the_cpu(dev, top_k):
    """A MoE LLaMA step (fp32, TF32 off, capacity 1.25, which drops) on the
    card against the CPU from the same weights: every layer's ordered expert
    choices agree, loss rtol 1e-5, gradients atol 2e-4 + rtol 2e-3, and each
    flash kernel launches once per layer."""
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(**DP_CFG, n_experts=4, moe_top_k=top_k)
    tokens = _dp_batches()[0]
    fa.reset_launches()
    card = _moe_loss_grads(cfg, dev, tokens)
    assert dict(fa.LAUNCHES) == {"fwd": 2, "dq": 2, "dkv": 2}
    host = _moe_loss_grads(cfg, torch.device("cpu"), tokens)
    for c, h in zip(card[2], host[2]):
        assert torch.equal(torch.softmax(c, -1).topk(top_k, -1).indices,
                           torch.softmax(h, -1).topk(top_k, -1).indices)
    assert card[0] == pytest.approx(host[0], rel=1e-5)
    for (path, a), (_, b) in zip(flatten(card[1]), flatten(host[1])):
        assert (abs(a - b) - 2e-3 * abs(b)).max() <= 2e-4, path


EP_CFS = (0.5, 1.0)  # every bucket fills at 0.5; at 1.0 some overflow and some do not


def ep_layer_rank(rdv, device):
    """One rank of a 2-rank world: the EP layer over ``expert = 2`` (top-2,
    capacities ``EP_CFS``, fp32, TF32 off) on 256 tokens of width 64."""
    from ddl25spring_tpu_torch.parallel import ep
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    with init_mesh(rdv, 1, expert=2, device=device) as mesh:
        gen = torch.Generator().manual_seed(5)
        p = ep.init_moe_params(gen, 64, 128, 4, mesh.device)
        x = torch.randn(256, 64, generator=gen).to(mesh.device)
        out = {"device": str(mesh.device)}
        for cf in EP_CFS:
            f = ep.make_ep_moe_fn(mesh, capacity_factor=cf, return_stats=True, top_k=2)
            with torch.no_grad():
                y, aux, st = f(ep.shard_moe_params(p, 2, mesh.axis("expert").index,
                                                   mesh.device), x)
            out[cf] = {"y": y.cpu(), "kept": st["kept"].cpu()}
        return out


def test_ep_layer_on_the_card_equals_moe_ffn_per_shard(dev, tmp_path):
    """Two ranks on the card (gloo through host buffers): the EP layer's
    output within 1e-5 of ``moe_ffn`` on each shard's tokens on the card, and
    the kept counts equal, at a capacity where every bucket fills and at one
    where the counts depend on the routing."""
    from ddl25spring_tpu_torch.parallel import ep
    from ddl25spring_tpu_torch.parallel.launch import spawn

    ranks = spawn(ep_layer_rank, 2, "cuda", timeout=300, tmpdir=str(tmp_path))
    gen = torch.Generator().manual_seed(5)
    p = ep.init_moe_params(gen, 64, 128, 4, dev)
    x = torch.randn(256, 64, generator=gen).to(dev)
    for cf in EP_CFS:
        ys, kept = [], torch.zeros(4)
        with torch.no_grad():
            for shard in x.chunk(2):
                y, _, st = ep.moe_ffn(p, shard, cf, return_stats=True, top_k=2)
                ys.append(y.cpu())
                kept += st["kept"].cpu()
        full = 2 * ep.capacity(128, cf, 2, 4)
        assert kept.sum() < 2 * 256  # drops
        assert cf != EP_CFS[-1] or (kept < full).any()
        for r in ranks:
            assert r["device"].startswith("cuda")
            assert (r[cf]["y"] - torch.cat(ys)).abs().max() <= 1e-5
            assert torch.equal(r[cf]["kept"], kept)


def test_router_logits_stay_full_fp32_under_tf32(dev):
    """The router's product runs in full fp32 on the card whatever the
    global TF32 flag says (a routing decision must not depend on it), and
    the flag is left as it was."""
    from ddl25spring_tpu_torch.parallel import ep

    gen = torch.Generator().manual_seed(6)
    router, x = torch.randn(288, 4, generator=gen), torch.randn(768, 288, generator=gen)
    want = (x.double() @ router.double()).float()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ep.router_logits(router.to(dev), x.to(dev)).cpu()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert (got - want).abs().max() <= 1e-4


# ------------------------------------------------ the pipeline compositions

# name -> (world, init_mesh arguments, n_experts, schedule, the composition's axes)
COMPOSITIONS = {
    "ep-dp-pp 1f1b": (4, dict(data=2, stages=2), 4, "1f1b", {"ep_axis": "data"}),
    "dp-pp-tp gpipe": (8, dict(data=2, stages=2, model=2), 0, "gpipe", {"tp_axis": "model"}),
}


def composition_rank(rdv, name, device):
    """One rank of a composition of ``COMPOSITIONS`` on ``device``: one step
    (SGD at lr 0) of ``DP_CFG`` with 4 layers (and 4 experts under EP), M 2,
    fp32, TF32 off; its coordinates, the loss (last stage), its stage's
    gradients and the flash launches."""
    from ddl25spring_tpu_torch.models.llama import Llama, export_grads, export_params
    from ddl25spring_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_staged_params,
    )
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    world, kw, experts, schedule, axes = COMPOSITIONS[name]
    cfg = LlamaConfig(**{**DP_CFG, "n_layers": 4, "n_experts": experts})
    params = export_params(Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(3)))
    with init_mesh(rdv, kw["data"], kw["stages"], device=device, model=kw.get("model")) as mesh:
        stage = shard_staged_params(params, cfg, mesh, ep_axis=axes.get("ep_axis"),
                                    tp_axis=axes.get("tp_axis"))
        step = make_pipeline_train_step(stage, cfg, torch.optim.SGD(stage.parameters(), lr=0.0),
                                        mesh, 2, schedule, **axes)
        fa.reset_launches()
        loss = step(torch.cat(_dp_batches()))
        return {"coords": mesh.coords, "loss": None if loss is None else loss.item(),
                "grads": export_grads(stage), "launches": dict(fa.LAUNCHES),
                "device": str(mesh.device)}


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_pipeline_composition_on_the_card_matches_the_cpu(dev, tmp_path, name):
    """EP x DP x PP under 1F1B and DP x PP x TP under GPipe, every rank on the
    card (gloo through host buffers), against the same world on the CPU,
    where the plain versions run: each rank's loss rtol 1e-5 and stage
    gradients atol 2e-4 + rtol 2e-3; each kernel launched once per layer and
    microbatch, the forward twice under 1F1B's recompute."""
    from ddl25spring_tpu_torch.parallel.bucketing import flatten
    from ddl25spring_tpu_torch.parallel.launch import spawn

    world, _, _, schedule, _ = COMPOSITIONS[name]
    card = spawn(composition_rank, world, name, "cuda", timeout=300, tmpdir=str(tmp_path))
    host = spawn(composition_rank, world, name, "cpu", timeout=300, tmpdir=str(tmp_path))
    n = 2 * 2  # 2 layers per stage, 2 microbatches
    for c, h in zip(card, host):
        assert c["device"].startswith("cuda") and c["coords"] == h["coords"]
        assert c["launches"] == {"fwd": n * (2 if schedule == "1f1b" else 1), "dq": n, "dkv": n}
        assert (c["loss"] is None) == (h["loss"] is None)
        if c["loss"] is not None:
            assert c["loss"] == pytest.approx(h["loss"], rel=1e-5)
        for (path, a), (_, b) in zip(flatten(c["grads"]), flatten(h["grads"])):
            assert (abs(a - b) - 2e-3 * abs(b)).max() <= 2e-4, path


def _scaled_loss(model, batch):
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss

    tokens, factor = batch
    return causal_lm_loss(model(tokens), tokens) * factor


def _guarded_llama(dev, capturable, guarded):
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.obs import sentinels
    from ddl25spring_tpu_torch.parallel.dp import make_train_step
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(**{**DP_CFG, "dtype": "bfloat16"})
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(6))
    opt = torch.optim.Adam(model.parameters(), lr=8e-4, capturable=capturable)
    with sentinels.scoped(guarded, policy="skip"):
        return model, opt, make_train_step(model, _scaled_loss, opt, sentinel=guarded)


def _bits_of(tensors):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [t.detach().contiguous().view(ints[t.element_size()]).clone() for t in tensors]


def _opt_state(opt):
    return [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]


def test_guarded_step_skips_a_poisoned_step_bitwise_on_the_card(dev):
    """chip_smoke phase 16 (a), small: 6 guarded bf16 steps (plain Adam, its
    step counter on the host), step 3's loss factor NaN: one violation
    record naming step 3; parameters and Adam state bitwise unchanged across
    it; the 5 clean losses bitwise an unguarded run's without the poisoned
    batch; each flash kernel launched 2 (layers) times a step on wgmma."""
    from ddl25spring_tpu_torch.obs import flight, sentinels

    sentinels.reset()
    flight.reset()
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, 256, (6, 4, 64), generator=g).to(dev)
    factors = torch.ones(6, device=dev)
    factors[3] = float("nan")
    model, opt, step = _guarded_llama(dev, False, True)
    fa.reset_launches()
    losses = []
    for i in range(6):
        if i == 3:
            sentinels.flush()
            before = _bits_of(list(model.parameters()) + _opt_state(opt))
        losses.append(step((tokens[i], factors[i])))
        if i == 3:
            sentinels.flush()
            assert all(torch.equal(a, b) for a, b in
                       zip(before, _bits_of(list(model.parameters()) + _opt_state(opt))))
    sentinels.flush()
    assert {n: c["wgmma"] for n, c in fa.LAUNCHES_BY_VARIANT.items()} == \
        {"fwd": 12, "dq": 12, "dkv": 12}
    kinds = [r["kind"] for r in flight.last()]
    assert kinds == ["step"] * 3 + ["violation"] + ["step"] * 2
    plain, _, plain_step = _guarded_llama(dev, False, False)
    ref = [plain_step((tokens[i], factors[i])).float().item() for i in range(6) if i != 3]
    assert [x.float().item() for i, x in enumerate(losses) if i != 3] == ref
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), plain.parameters()))
    sentinels.reset()
    flight.reset()


def test_guarded_fused_window_records_every_step_on_the_card(dev):
    """chip_smoke phase 16 (b), small: ``fuse_train_steps(step, 4)`` with the
    guard (capturable Adam), window step 2 poisoned: 4 records in step
    order, one violation; the clean losses, parameters and Adam state
    bitwise 3 eager unguarded steps'; the graph holds 4 x 2 of each flash
    kernel; a second replay records 4 more."""
    from ddl25spring_tpu_torch.obs import flight, sentinels
    from ddl25spring_tpu_torch.parallel.pipeline import fuse_train_steps

    sentinels.reset()
    flight.reset()
    g = torch.Generator().manual_seed(10)
    window = torch.randint(0, 256, (4, 4, 64), generator=g).to(dev)
    wf = torch.ones(4, device=dev)
    wf[2] = float("nan")
    emodel, eopt, estep = _guarded_llama(dev, True, False)
    ref = [estep((window[i], wf[i])).float().item() for i in range(4) if i != 2]
    model, opt, step = _guarded_llama(dev, True, True)
    fa.reset_launches()
    multi = fuse_train_steps(step, 4, module=model, optimizer=opt, device=dev)
    fused = multi((window, wf)).float().tolist()
    sentinels.flush()
    assert {n: c["wgmma"] for n, c in fa.CAPTURED.items()} == {"fwd": 8, "dq": 8, "dkv": 8}
    recs = flight.last()
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert [r["kind"] for r in recs] == ["step", "step", "violation", "step"]
    assert [x for i, x in enumerate(fused) if i != 2] == ref
    assert all(torch.equal(a, b) for a, b in zip(_bits_of(list(model.parameters())
                                                          + _opt_state(opt)),
                                                 _bits_of(list(emodel.parameters())
                                                          + _opt_state(eopt))))
    multi((window, torch.ones(4, device=dev)))
    sentinels.flush()
    assert [r["step"] for r in flight.last()] == list(range(8))
    sentinels.reset()
    flight.reset()


# ------------------------------------------------------- fault tolerance

FT_CFG = dict(vocab_size=256, dmodel=64, num_heads=2, n_layers=3, ctx_size=64,
              dtype="bfloat16", use_flash=True)


def _ft_tokens(n, rows, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (rows, 64), generator=g).numpy() for _ in range(n)]


def test_lab_resume_is_bitwise_on_the_card(dev, tmp_path):
    """chip_smoke phase 17 (a), small: the lab's 2 x 3 world on the card
    (bf16, flash; gloo through pinned buffers), 4 steps with checkpoints
    after steps 1 and 3 against 2 steps and a relaunch of 2: the losses and
    step 3's checkpoint, every stage's parameters and Adam state, bitwise;
    each rank launches each kernel once per layer and microbatch, on
    ``wgmma``."""
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from ddl25spring_tpu_torch.utils import pytree
    from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    tokens = _ft_tokens(4, 6, 21)

    def job(d, iters):
        return dp_pp.Job(LlamaConfig(**FT_CFG), data=2, stages=3, microbatches=3, batch=6,
                         iters=iters, device="cuda", batches=tokens, log=False,
                         ckpt_dir=str(tmp_path / d), ckpt_every=2)

    rdv = str(tmp_path)
    a = spawn(dp_pp.run_rank, 6, job("A", 4), timeout=300, tmpdir=rdv)
    b1 = spawn(dp_pp.run_rank, 6, job("B", 2), timeout=300, tmpdir=rdv)
    b2 = spawn(dp_pp.run_rank, 6, job("B", 2), timeout=300, tmpdir=rdv)
    last = [next(r for r in run if r["coords"] == (0, 2))["losses"] for run in (a, b1, b2)]
    assert last[0] == last[1] + last[2]
    assert {r["start"] for r in b2} == {2}
    for r in a + b2:
        steps = 4 if r in a else 2
        assert r["device"].startswith("cuda")
        assert {n: c["wgmma"] for n, c in r["launches_by_variant"].items()} == \
            {n: 3 * steps for n in ("fwd", "dq", "dkv")}
    want = pytree.flatten_with_path(Checkpointer(tmp_path / "A").restore(3))
    got = pytree.flatten_with_path(Checkpointer(tmp_path / "B").restore(3))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), path


def ft_zero_rank(rdv, device):
    """One rank of 4 on ``device``: the narrow fp32 LLaMA ZeRO-3 (Adam at the
    lab's 8e-4, eps 1e-6), 4 steps at n = 2; 2 at n = 4, a live reshape to n = 2, 2
    more; 2 at n = 2, a reshape to n = 4, 2 more.  This rank's rows, numpy."""
    from ddl25spring_tpu_torch.ft import elastic
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.parallel import zero
    from ddl25spring_tpu_torch.utils.config import LlamaConfig
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    cfg = LlamaConfig(**{**FT_CFG, "dtype": "float32"})
    tokens = [torch.from_numpy(t).long() for t in _ft_tokens(4, 4, 22)]
    out = {}
    with init_mesh(rdv, 4, stages=1, device=device) as mesh4:
        meshes = {4: mesh4, 2: mesh4.regrid(2, stages=2)}

        def build(model, n, rows):
            opt = torch.optim.Adam(rows.parameters(), lr=8e-4, eps=1e-6)
            return opt, zero.make_zero3_llama_train_step(model, opt, meshes[n], rows)

        def fresh(n):
            model = Llama(cfg, device=mesh4.device, generator=torch.Generator().manual_seed(0))
            rows = zero.zero_shard_llama_params(model, meshes[n])
            return (model, rows, *build(model, n, rows))

        _, rows, _, step = fresh(2)
        for t in tokens:
            step(t)
        out["ref"] = [r.detach().cpu().numpy() for r in rows.parameters()]
        for first, second in ((4, 2), (2, 4)):
            model, rows, opt, step = fresh(first)
            for t in tokens[:2]:
                step(t)
            state = elastic.reshape_state(
                zero.zero_state(rows, opt, meshes[first], model),
                zero.zero_resume_template(model, opt, meshes[second], llama=True, abstract=True))
            rows2 = zero.zero_rows_from_state(state, model, llama=True)
            opt2, step2 = build(model, second, rows2)
            zero.zero_load_optimizer(opt2, rows2, state, model)
            for t in tokens[2:]:
                step2(t)
            out[first, second] = [r.detach().cpu().numpy() for r in rows2.parameters()]
    return out


def test_zero3_reshape_on_the_card_matches_uninterrupted(dev, tmp_path):
    """chip_smoke phase 17 (d), small: fp32 LLaMA ZeRO-3 on 4 ranks sharing
    the card, reshaped live 4 -> 2 and 2 -> 4 after 2 steps: within atol
    2e-5 + rtol 2e-5 (the JAX test's ``assert_allclose``) of 4 uninterrupted
    steps at n = 2 on the card."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    ranks = spawn(ft_zero_rank, 4, "cuda", timeout=300, tmpdir=str(tmp_path))

    def flat(line, key):
        per_rank = [ranks[r][key] for r in line]
        return [np.concatenate([rows[j] for rows in per_rank]).reshape(-1)
                for j in range(len(per_rank[0]))]

    ref = flat((0, 2), "ref")
    for key, line in (((4, 2), (0, 2)), ((2, 4), (0, 1, 2, 3))):
        for a, b in zip(flat(line, key), ref, strict=True):
            k = min(a.size, b.size)
            np.testing.assert_allclose(a[:k], b[:k], atol=2e-5, rtol=2e-5, err_msg=str(key))
            assert not a[k:].any() and not b[k:].any()


def _serve_run(device, graphs, trace_label=None):
    """The tiny fp32 engine with the smoke knobs on the seeded smoke trace,
    virtual clock, the host/device page mirror asserted at every step."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace

    cfg = driver.serve_model("tiny")
    model = Llama(cfg, device=device, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
    knobs = driver.engine_knobs(smoke=True)
    eng = ServeEngine(model, cfg, **knobs, clock="virtual", trace_label=trace_label,
                      graphs=graphs, tick_s=driver.ab_tick_s(trace, knobs["max_slots"]))
    eng._sanitize = True
    eng.warmup()
    eng.run(trace, max_steps=5_000)
    return eng


def test_serve_engine_graphed_equals_eager_and_the_cpu(dev):
    """chip_smoke phase 18 (a), small: the graphed engine's token streams and
    final pool are bitwise the eager engine's on the card, and its streams
    the CPU engine's."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    graphed = _serve_run(dev, graphs=True)
    eager = _serve_run(dev, graphs=False)
    cpu = _serve_run(torch.device("cpu"), graphs=True)
    assert graphed._tick.graph is not None and eager._tick.graph is None
    streams = [{r.rid: r.tokens for r in e.done} for e in (graphed, eager, cpu)]
    assert streams[0] == streams[1] == streams[2] and len(streams[0]) > 5
    assert graphed.token_log == cpu.token_log
    for name, t in graphed.pool.items():
        # the trash page (the last K/V row) takes the masked rows' writes in
        # an undefined order; nothing reads it
        keep = slice(0, graphed.n_pages) if name in ("k", "v") else slice(None)
        assert torch.equal(t[keep], eager.pool[name][keep]), name
    assert graphed.pool_ok_failures == 0 and graphed.mem_leak_check()["ok"]
    assert sum(fa.LAUNCHES.values()) == 0
    assert sum(c for v in fa.CAPTURED.values() for c in v.values()) == 0


def _spec_run(device, graphs):
    """The tiny-deep fp32 engine with 2 drafts a round and the smoke knobs on
    the seeded smoke trace, virtual clock, the page mirror asserted at every
    step."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace

    cfg = driver.serve_model("tiny-deep")
    model = Llama(cfg, device=device, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
    knobs = {**driver.engine_knobs(smoke=True), "spec_k": 2}
    eng = ServeEngine(model, cfg, **knobs, clock="virtual", trace_label=None, graphs=graphs,
                      tick_s=driver.ab_tick_s(trace, knobs["max_slots"]))
    eng._sanitize = True
    eng.warmup()
    eng.run(trace, max_steps=5_000)
    return eng


def test_spec_engine_graphed_equals_eager_and_the_cpu(dev):
    """chip_smoke phase 19 (a), small: the graphed speculative engine's
    streams, accept counts and both final pools are bitwise the eager
    engine's, its streams and accept counts the CPU's, and a full accept
    took the captured (k+1)-step draft."""
    from ddl25spring_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    graphed, eager = _spec_run(dev, graphs=True), _spec_run(dev, graphs=False)
    cpu = _spec_run(torch.device("cpu"), graphs=True)
    assert graphed._verify.graph is not None and graphed._draft_k1.graph is not None
    assert eager._verify.graph is None
    streams = [{r.rid: r.tokens for r in e.done} for e in (graphed, eager, cpu)]
    assert streams[0] == streams[1] == streams[2] and len(streams[0]) > 5
    assert graphed.spec_accept_counts == eager.spec_accept_counts == cpu.spec_accept_counts
    assert graphed._draft_steps > 2 * graphed._spec_rounds  # a (k+1)-step round ran
    for ours, theirs in ((graphed.pool, eager.pool), (graphed.draft_pool, eager.draft_pool)):
        for name, t in ours.items():
            keep = slice(0, graphed.n_pages) if name in ("k", "v") else slice(None)
            assert torch.equal(t[keep], theirs[name][keep]), name
    leak = graphed.mem_leak_check()
    assert graphed.pool_ok_failures == 0 and leak["ok"] and leak["draft"]["ok"]
    assert sum(fa.LAUNCHES.values()) == 0
    assert sum(c for v in fa.CAPTURED.values() for c in v.values()) == 0


def test_elastic_serve_graphed_equals_eager_on_the_card(dev, tmp_path):
    """chip_smoke phase 19 (c), small: a traffic spike and a device loss on
    the tiny model, graphed and eager replicas: the same events and streams,
    nothing dropped, and the retired replica's allocator step-down above 0."""
    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.ft import ChaosInjector, parse_chaos
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.obs import memscope
    from ddl25spring_tpu_torch.serve import driver

    cfg = driver.serve_model("tiny")
    model = Llama(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    knobs = dict(page_len=4, n_pages=16, max_slots=2, prefill_batch=2, max_prompt_len=8,
                 max_queue=32, token_budget=None, eos_id=None, prefix_cache=False)
    trace = [{"t": 0.001 * i, "prompt": [5, 9, 11, 3], "max_new": 6} for i in range(8)]
    cells = []
    obs.timeline.configure(None)
    with obs.scoped(True), memscope.scoped(True):
        for graphs in (True, False):
            chaos = ChaosInjector(parse_chaos("traffic_spike@1:12,device_loss@8"), None)
            cells.append(driver.elastic_serve_run(model, cfg, trace, dict(knobs, graphs=graphs),
                                                  chaos=chaos, max_replicas=3,
                                                  keep_requests=True))
    graphed, eager = cells
    assert ([(e["reason"], e["old"], e["new"], e["t"]) for e in graphed["events"]]
            == [(e["reason"], e["old"], e["new"], e["t"]) for e in eager["events"]])
    assert graphed["dropped_requests"] == eager["dropped_requests"] == 0
    assert ({r.rid: r.tokens for r in graphed["_requests"]}
            == {r.rid: r.tokens for r in eager["_requests"]})
    for cell in cells:
        (step,) = cell["mem_steps"]
        assert step["leak_ok"] and step["step_down_bytes"] > 0


def tp_serve_rank(rdv, device):
    """One rank of a 2-rank TP serving world on ``device`` (chip_smoke phase
    20 (a), small): the smoke trace through the tiny model's resident and
    streamed ``tp=2`` engines and tiny-deep's with 2 drafts a round; each
    engine's streams, accept counts, pool k/v (the trash page aside) and the
    streamed tick's logits against the resident one's."""
    from ddl25spring_tpu_torch.models.llama import Llama
    from ddl25spring_tpu_torch.serve import driver, kv_pages
    from ddl25spring_tpu_torch.serve import engine as eng_mod
    from ddl25spring_tpu_torch.serve import spec as spec_mod
    from ddl25spring_tpu_torch.serve.engine import ServeEngine
    from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launches()
    out = {}
    with init_mesh(rdv, 1, model=2, device=device) as mesh:
        out["index"] = mesh.axis("model").index
        for name, ws, spec_k in (("resident", False, 0), ("streamed", True, 0),
                                 ("spec", False, 2)):
            cfg = driver.serve_model("tiny-deep" if spec_k else "tiny")
            model = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=cfg.vocab_size))
            knobs = {**driver.engine_knobs(smoke=True), "spec_k": spec_k, "tp": 2,
                     "weight_stream": ws}
            eng = ServeEngine(model.requires_grad_(False), cfg, **knobs, mesh=mesh,
                              graphs=False, clock="virtual", trace_label=None,
                              tick_s=driver.ab_tick_s(trace, knobs["max_slots"]))
            eng._sanitize = True
            eng.warmup()
            eng.run(trace, max_steps=5_000)
            n = eng.n_pages
            out[name] = {"streams": {r.rid: r.tokens for r in eng.done},
                         "accept": dict(eng.spec_accept_counts),
                         "k": eng.pool["k"][:n].cpu(), "v": eng.pool["v"][:n].cpu(),
                         "ok": eng.pool_ok_failures == 0 and eng.mem_leak_check()["ok"],
                         "device": str(eng.device)}
            if not spec_k:
                pool = kv_pages.init_page_pool(cfg, n_pages=n, page_len=eng.page_len,
                                               max_slots=eng.max_slots,
                                               pages_per_seq=eng.pages_per_seq, num_heads=1,
                                               device=mesh.device)
                pool["active"][:] = True
                stack = (None if eng._stream is None
                         else eng_mod._stream_layer_stack(eng.axis, *eng._stream))
                toks = torch.tensor([3, 5], dtype=torch.int32, device=mesh.device)
                _, logits, _ = spec_mod._position_step(cfg, eng.axis, stack)(
                    eng.params, pool, toks, pool["seq_len"], pool["active"])
                out[name]["logits"] = logits.cpu()
    out["launches"] = sum(fa.LAUNCHES.values()) + sum(
        c for v in fa.CAPTURED.values() for c in v.values())
    return out


@pytest.fixture(scope="module")
def tp_serve_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    from ddl25spring_tpu_torch.parallel.launch import spawn

    return spawn(tp_serve_rank, 2, "cuda", timeout=300,
                 tmpdir=str(tmp_path_factory.mktemp("rdv")))


@pytest.mark.parametrize("name", ["resident", "streamed", "spec"])
def test_tp_serve_on_the_card_equals_the_single_card_engine(dev, tp_serve_world, name):
    """chip_smoke phase 20 (a), small: 2 ranks on the card over gloo, the
    ``tp=2`` engine's streams (and accept counts) equal the single-card
    engine's graphed, eager and on the CPU; each rank's pool is its heads of
    the graphed single-card pool within 1e-5; the streamed tick's logits equal
    the resident one's bitwise; no flash kernel launched."""
    run = _spec_run if name == "spec" else _serve_run
    graphed, eager = run(dev, graphs=True), run(dev, graphs=False)
    cpu = run(torch.device("cpu"), graphs=True)
    want = {r.rid: r.tokens for r in graphed.done}
    assert len(want) > 5
    assert {r.rid: r.tokens for r in eager.done} == {r.rid: r.tokens for r in cpu.done} == want
    for r in tp_serve_world:
        got, i = r[name], r["index"]
        assert got["device"].startswith("cuda") and got["ok"] and r["launches"] == 0
        assert got["streams"] == want
        if name == "spec":
            assert got["accept"] == graphed.spec_accept_counts
        for k in ("k", "v"):
            ref = graphed.pool[k][:graphed.n_pages, :, :, i:i + 1].cpu()
            assert (got[k] - ref).abs().max() <= 1e-5, k
        if name == "streamed":
            assert torch.equal(got["logits"], r["resident"]["logits"])


def test_bench_obs_dir_on_the_card(dev, tmp_path, monkeypatch):
    """chip_smoke phase 21, small (``bench --smoke --device cuda``: batch 64,
    one step per dispatch), run in this process as a retry child would run
    it: the perf record names the card and its data-sheet
    peak, its measured MFU is flops / (p50 x peak); the live bytes come from
    the allocator, inside the first sample's band; the flight dump names live
    tensors on the card; the goodput doc adds up; every gate tool exits 0;
    no flash kernel launched."""
    import json
    import os

    from ddl25spring_tpu_torch import bench
    from ddl25spring_tpu_torch.utils.flops import peak_bf16_flops
    from tools import goodput_report, mem_report, perf_report

    fa.reset_launches()
    monkeypatch.setenv("DDL25_BENCH_CHILD", "1")  # in this process, not a retry child
    d, led = str(tmp_path / "run"), str(tmp_path / "ledger.jsonl")
    rec = bench.main(["--smoke", "--device", "cuda", "--obs-dir", d, "--perf-ledger", led,
                      "--perf-reps", "2"])
    tel = rec["telemetry"]
    assert "error" not in tel["perf"]
    perf = json.load(open(os.path.join(d, "perf.json")))
    peak = peak_bf16_flops(dev)
    assert perf["chip"] == torch.cuda.get_device_name(0) and perf["peak_source"] == "datasheet"
    assert perf["measured_mfu"] == pytest.approx(perf["flops"] / (perf["step_s_p50"] * peak),
                                                 rel=1e-12)
    assert perf["exposed_comms_s"] >= 0 and perf["flops"] > 0
    mem = json.load(open(os.path.join(d, "mem.json")))
    assert mem["budget"]["within_band"] and mem["growth_violations"] == 0
    assert 0 < mem["memscope"]["live_bytes_peak"] <= torch.cuda.max_memory_allocated()
    live = json.load(open(os.path.join(d, "flight.json")))["live_arrays"]
    assert any(t["device"] == "cuda:0" for t in live["largest"])
    assert tel["goodput"]["sum_check"]["ok"]
    assert perf_report.main(["--ledger", led, "--check"]) == 0
    assert mem_report.main(["--run", d, "--check"]) == 0
    assert goodput_report.main(["--ledger", led, "--check"]) == 0
    assert sum(fa.LAUNCHES.values()) == 0


def test_memscope_and_meter_leave_losses_and_tokens_bitwise_on_the_card(dev):
    """The ResNet run's losses (one step per dispatch, batch 64) and the
    graphed serving engine's streams and pool are bitwise equal with the
    memory sampler and the goodput meter on and off."""
    from ddl25spring_tpu_torch import obs
    from ddl25spring_tpu_torch.lab import dp_pp
    from ddl25spring_tpu_torch.obs import goodput, memscope

    job = dp_pp.ResnetJob(1, 1, 1, 64, 4, device="cuda", input="hbm", warmup=2, n_train=512)

    def train(on):
        with obs.scoped(on), memscope.scoped(on):
            tel = (dp_pp.ResnetTelemetry(goodput=goodput.GoodputMeter("t"),
                                         memscope=memscope.MemScope(device=dev))
                   if on else None)
            r = dp_pp.train_resnet(None, job, tel)
        if on:
            assert tel.memscope.live_bytes.count == 4 and tel.goodput.seconds["useful_step"] > 0
        return r["losses"]

    assert train(True) == train(False)

    def serve(on):
        with obs.scoped(on), memscope.scoped(on):
            return _serve_run(dev, graphs=True, trace_label="serve")

    on, off = serve(True), serve(False)
    assert on.memscope.live_bytes.count > 0 and off.memscope.live_bytes.count == 0
    assert {r.rid: r.tokens for r in on.done} == {r.rid: r.tokens for r in off.done}
    for name, t in on.pool.items():
        keep = slice(0, on.n_pages) if name in ("k", "v") else slice(None)
        assert torch.equal(t[keep], off.pool[name][keep]), name


def test_a_new_stream_costs_one_blas_workspace(dev):
    """The serving band's known term: a product on a stream that has run
    none grows ``memory_allocated`` by exactly ``blas_workspace_bytes``, a
    second product on it by nothing; every serve program is captured on one
    stream; and a live tensor is named by the summary whichever way the
    card is named."""
    from ddl25spring_tpu_torch.obs import memscope
    from ddl25spring_tpu_torch.serve import engine

    a = torch.randn(64, 64, device=dev)
    stream = torch.cuda.Stream(dev, priority=-1)  # the high-priority pool: the port takes none
    before = memscope.live_total_bytes(dev)
    with torch.cuda.stream(stream):
        b = a @ a
        first = memscope.live_total_bytes("cuda") - before - b.nbytes
        c = a @ a
    torch.cuda.synchronize()
    assert first == memscope.blas_workspace_bytes(dev) == memscope.blas_workspace_bytes("cuda:0")
    assert memscope.live_total_bytes(dev) - before == first + b.nbytes + c.nbytes
    assert engine._capture_stream(torch.device(dev)) is engine._capture_stream(torch.device("cuda"))
    x = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
    assert any(t["device"] == "cuda:0" and t["bytes"] == x.numel()
               for t in memscope.live_array_summary(top=50)["largest"])


def test_probe_devices_brings_up_the_card(dev):
    """The bench's device probe on the card: ``torch.cuda.init()``, the
    count and one allocation inside the bounded thread give the cards, no
    error and no stall dump."""
    from ddl25spring_tpu_torch import bench

    devices, err, dump = bench.probe_devices(60.0)
    assert err is None and dump is None
    assert devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_input_feed_streams_pinned_batches_to_the_card(dev):
    """``InputFeed(stream=True)`` on the card: each batch lands on cuda:0 as
    uint8, and five batches held at once equal the native loader's batches
    of the same seed bitwise (a pinned buffer rewritten before its copy
    finished would show here); the fixed batch is the first."""
    from ddl25spring_tpu_torch.benchmarks import InputFeed
    from ddl25spring_tpu_torch.data.cifar10 import ensure_bin_dir
    from ddl25spring_tpu_torch.data.native_loader import NativeCifar10Loader

    feed = InputFeed(256, stream=True, workers=2, prefetch_depth=2, device=dev)
    try:
        assert feed.streaming and feed.input_mode == "native-stream-uint8"
        got = [feed.feed_fixed()] + [feed.feed() for _ in range(5)]
        torch.cuda.synchronize()
    finally:
        feed.close()
    ref = NativeCifar10Loader(ensure_bin_dir()[0], batch_size=256, normalize=False, workers=1)
    try:
        it = iter(ref)
        for x, y in got:
            rx, ry = next(it)
            assert x.device == dev and x.dtype == torch.uint8 and x.shape == (256, 32, 32, 3)
            assert torch.equal(x.cpu(), torch.from_numpy(rx))
            assert torch.equal(y.cpu(), torch.from_numpy(ry))
    finally:
        ref.close()


def test_resume_lands_in_the_captured_graph_on_the_card(dev, tmp_path, monkeypatch):
    """The resilient primary on the card under ``hbm-scan`` (K = 2 steps a
    CUDA graph, the bench's lr 0.1, cuDNN deterministic): a run that saved
    after each window, resumed at window 2, runs windows 2 and 3 with the
    losses of the uninterrupted run (within 1e-3 of each), so the restored
    weights and momentum are the tensors the graph replays.  A control
    resumed at window 2 from a checkpoint of the untrained weights (what the
    graph would train on had the restore missed its tensors) is off by over
    20 times the resumed run's largest gap."""
    from ddl25spring_tpu_torch.lab import dp_pp

    monkeypatch.setattr(dp_pp, "RUN_FLAGS", {**dp_pp.RUN_FLAGS, "cudnn_benchmark": False,
                                             "cudnn_deterministic": True})

    def run(iters, ft, lr=0.1):
        job = dp_pp.ResnetJob(1, 1, 1, 64, iters, lr=lr, device="cuda", input="hbm-scan",
                              scan_steps=2, warmup=1, n_train=512)
        return dp_pp.train_resnet(None, job, dp_pp.ResnetTelemetry(ft=ft))

    whole = run(8, None)
    run(4, dp_pp.ResnetFT(str(tmp_path / "ck"), save_every=1))
    resumed = run(8, dp_pp.ResnetFT(str(tmp_path / "ck"), save_every=1, resume=True))
    # the same windows and cursor, the weights as they were at the start
    run(4, dp_pp.ResnetFT(str(tmp_path / "ck0"), save_every=1), lr=1e-30)
    control = run(8, dp_pp.ResnetFT(str(tmp_path / "ck0"), save_every=1, resume=True))
    for r in (resumed, control):
        assert r["resume"]["start_step"] == 2 and r["timed_steps"] == 4
    a, b, c = whole["losses"][-4:], resumed["losses"][-4:], control["losses"][-4:]
    gap = max(abs(x - y) for x, y in zip(b, a))
    assert all(abs(x - y) <= 1e-3 * abs(y) for x, y in zip(b, a)), (a, b)
    assert max(abs(x - y) for x, y in zip(c, a)) > 20 * gap, (a, b, c)
