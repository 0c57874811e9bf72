"""The port's ResNet benchmark pieces on the CPU: ``DeviceDataset`` held to the
properties ``tests/test_benchmarks.py`` pins for the JAX class (its batch
order cannot equal ``jax.random.permutation``'s), ``report_line``, the FLOP
count against the analytic conv + fc count, the MFU table, ``build_resnet_step``,
``timed_run``, and ``lab.dp_pp --workload resnet`` end to end (one rank in
process; four spawned ranks with ``--pp``).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch import benchmarks  # noqa: E402
from ddl25spring_tpu_torch.lab import dp_pp  # noqa: E402
from ddl25spring_tpu_torch.models import resnet  # noqa: E402
from ddl25spring_tpu_torch.utils import flops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and the full-width CPU steps here would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    # n=100, B=32 -> 3 batches per epoch, a 4-row drop-last tail
    return benchmarks.DeviceDataset(32, n_train=100, device="cpu")


def _row_ids(ds, x):
    ref = ds.x.reshape(ds.n, -1)
    return [int(torch.nonzero((ref == r).all(1))[0]) for r in x.reshape(x.shape[0], -1)]


def test_epoch_batches_disjoint_and_drop_last(ds):
    ds.cursor = 0
    assert ds.batches_per_epoch == 3
    seen = []
    for _ in range(ds.batches_per_epoch):
        x, y = ds.feed()
        assert x.shape == (32, 32, 32, 3) and x.dtype == torch.uint8 and y.shape == (32,)
        seen += _row_ids(ds, x)
    assert len(set(seen)) == 96, "epoch batches must be disjoint"
    assert ds.cursor == 3


def test_epochs_reshuffle(ds):
    ds.cursor = 0
    first = [ds.feed()[1] for _ in range(ds.batches_per_epoch)]
    second = [ds.feed()[1] for _ in range(ds.batches_per_epoch)]
    assert any(not torch.equal(a, b) for a, b in zip(first, second))
    # the same cursor gives the same batch (the shuffle is keyed by epoch)
    ds.cursor = 4
    again = ds.feed()[1]
    assert torch.equal(again, second[1])


def test_step_counter_survives_many_epochs(ds):
    ds.cursor = (2**31 // 32) + 7  # would overflow an int32 i * B product
    x, y = ds.feed()
    assert x.shape[0] == 32 and y.shape == (32,)


def test_batch_larger_than_dataset_rejected():
    with pytest.raises(ValueError, match="exceeds dataset size"):
        benchmarks.DeviceDataset(256, n_train=100, device="cpu")


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host with no GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.DeviceDataset(8, n_train=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.build_resnet_step(None, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp_pp.main(["--workload", "resnet", "--iters", "1"])


def test_dp_pp_defaults_match_the_jax_lab():
    """``lab.dp_pp`` run with no arguments trains what ``lab/s01_b2_dp_pp.py``
    trains: ResNet-18, the BASELINE benchmark config (``lab/run-b2.sh:7-9``).
    The JAX lab's module level imports the standard library only, so it is
    loaded from its path.  ``iters`` is 0 on both sides, the workload's
    default: LLaMA 200 steps, ResNet 30 (the LLaMA jobs themselves:
    ``test_llama_labs_take_the_jax_labs_flags``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "lab" / "s01_b2_dp_pp.py"
    spec = importlib.util.spec_from_file_location("jax_lab_s01_b2_dp_pp", path)
    jax_lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_lab)
    want, got = vars(jax_lab.parse_args([])), vars(dp_pp.parse_args([]))
    shared = ("workload", "iters", "input", "schedule", "chunks", "microbatches", "batch",
              "lr", "log_every", "pp", "no_flash")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["workload"] == "resnet" and got["input"] == "auto"


def _jax_lab(name: str):
    """The JAX lab ``lab/<name>.py``, loaded from its path (its module level
    imports the standard library only)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "lab" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_lab_{name}", path)
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    return lab


def _jax_llama_job(name: str, argv: list[str]) -> dict:
    """What the JAX lab trains on LLaMA for ``argv`` on the reference's device
    count (six devices: ``mesh(data=2, stage=3)`` for B2, three stages for
    B1), by the lab's own expressions: ``run_llama``
    (``lab/s01_b2_dp_pp.py:126-128, 140``) and ``main``
    (``lab/s01_b1_microbatches.py:105-107, 116``, the parser's defaults)."""
    a = _jax_lab(name).parse_args(argv)
    if name == "s01_b2_dp_pp":
        return {"data": 2, "stages": 3, "batch": a.batch or 3 * 2,
                "microbatches": a.microbatches or 3, "lr": a.lr or 8e-4,
                "iters": a.iters or 200}
    return {"data": 1, "stages": a.stages or 3, "batch": a.batch,
            "microbatches": a.microbatches, "lr": a.lr, "iters": a.iters}


def _port_llama_job(monkeypatch, run, argv: list[str]) -> dict:
    """The job the port's lab hands its ranks for ``argv`` (``spawn``
    stubbed: no rank starts)."""
    got = {}

    def spawn(fn, world, job, timeout):
        got.update(world=world, job=job)
        return [None] * world

    monkeypatch.setattr(dp_pp, "spawn", spawn)
    run([*argv, "--device", "cpu"])
    job = got["job"]
    assert got["world"] == job.data * job.stages and job.scan_steps == 1
    return {"data": job.data, "stages": job.stages, "batch": job.batch,
            "microbatches": job.microbatches, "lr": job.lr, "iters": job.iters}


@pytest.mark.parametrize("name,argv", [
    ("s01_b2_dp_pp", ["--workload", "llama"]),
    ("s01_b2_dp_pp", ["--workload", "llama", "--batch", "12", "--microbatches", "6",
                      "--lr", "1e-3", "--iters", "7"]),
    ("s01_b1_microbatches", []),
    ("s01_b1_microbatches", ["--microbatches", "6", "--stages", "3", "--batch", "6",
                             "--lr", "2e-3", "--iters", "5"]),
    ("s01_b1_microbatches", ["--stages", "2", "--batch", "4", "--microbatches", "2"]),
], ids=["b2-defaults", "b2-flags", "b1-defaults", "b1-flags", "b1-two-stages"])
def test_llama_labs_take_the_jax_labs_flags(monkeypatch, name, argv):
    """The port's LLaMA labs train what the JAX labs train for the same argv:
    batch (global), microbatches, learning rate, steps and stages, with the
    JAX defaults (batch 3 per replica, M 3, lr 8e-4, 200 steps, 3 stages)."""
    from ddl25spring_tpu_torch.lab import microbatches

    run = dp_pp.main if name == "s01_b2_dp_pp" else microbatches.main
    assert _port_llama_job(monkeypatch, run, argv) == _jax_llama_job(name, argv)


def test_llama_lab_refuses_a_batch_the_microbatches_do_not_split(monkeypatch):
    from ddl25spring_tpu_torch.lab import microbatches

    monkeypatch.setattr(dp_pp, "spawn", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 microbatches x 2"):
        dp_pp.main(["--workload", "llama", "--device", "cpu", "--batch", "8"])
    with pytest.raises(ValueError, match="batch 3 not divisible by 6 microbatches x 1"):
        microbatches.main(["--device", "cpu", "--microbatches", "6"])


def test_microbatches_lab_trains_the_microbatches_asked_for():
    """``lab.microbatches --microbatches 6 --stages 3`` runs 6 microbatches
    through 3 ranks: under GPipe stage 0 holds every one of them at once."""
    from ddl25spring_tpu_torch.lab import microbatches

    run = microbatches.main(["--device", "cpu", "--microbatches", "6", "--stages", "3",
                             "--batch", "6", "--iters", "1", "--seq-len", "16",
                             "--timeout", "120"])
    assert len(run["ranks"]) == 3 and len(run["losses"]) == 1
    assert [r["stash_max"] for r in sorted(run["ranks"], key=lambda r: r["rank"])] == \
        [[6], [6], [6]]


def test_auto_input_resolves_by_device_and_ranks():
    """``--input auto`` is ``hbm`` on the CPU; ``hbm-scan`` takes the JAX K
    rule (the largest divisor of the epoch's batches up to 16: 16 at batch
    1024, 48 batches an epoch); ranks that share a card over gloo cannot be
    graphed, so ``auto`` is ``hbm`` for them and an explicit ``hbm-scan``
    raises (the check alone: no card needed)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dp_pp.resnet_input("auto", 0, cpu, 1, 4) == ("hbm", 1, "")
    assert dp_pp.resnet_input("hbm-scan", 0, cpu, 1, 1024) == ("hbm-scan", 16, "")
    assert dp_pp.resnet_input("hbm-scan", 0, cpu, 1, 4096) == ("hbm-scan", 12, "")
    assert dp_pp.resnet_input("hbm-scan", 3, cpu, 4, 64) == ("hbm-scan", 3, "")
    assert dp_pp.resnet_input("fixed", 0, cuda, 1, 1024) == ("fixed", 1, "")
    assert dp_pp.resnet_input("auto", 0, cuda, 1, 1024) == ("hbm-scan", 16, "")
    assert dp_pp.resnet_input("auto", 1, cuda, 1, 1024) == ("hbm", 1, "")
    mode, K, why = dp_pp.resnet_input("auto", 0, cuda, 4, 256)
    assert (mode, K) == ("hbm", 1) and "host copy" in why
    with pytest.raises(ValueError, match="host copy"):
        dp_pp.resnet_input("hbm-scan", 0, cuda, 4, 256)


def test_report_line_keys_and_metric():
    rec = json.loads(benchmarks.report_line("dppp", 12345.67, "hbm-resident-shuffle",
                                            0.41234, 405.66, extra=1))
    assert rec == {"metric": "cifar10_resnet18_dppp_samples_per_sec_per_chip",
                   "value": 12345.7, "unit": "samples/sec/chip",
                   "vs_baseline": round(12345.67 / 5000.0, 3),
                   "input": "hbm-resident-shuffle", "mfu": 0.4123,
                   "achieved_tflops_per_chip": 405.7, "extra": 1}
    assert json.loads(benchmarks.report_line("dp", 1.0, "x", None, None))["mfu"] is None


def _analytic_macs(width: int, batch: int) -> int:
    """Conv + fc multiply-accumulates of one forward of ResNet-18 on 32x32."""
    macs, size, cin = 3 * 3 * 3 * width * 32 * 32, 32, width  # stem
    for filters, stride in resnet.block_plan(width):
        out = size // stride
        macs += 9 * cin * filters * out * out + 9 * filters * filters * out * out
        if cin != filters or stride != 1:
            macs += cin * filters * out * out
        size, cin = out, filters
    return batch * (macs + cin * 10)


@pytest.mark.parametrize("width", [8, 64])
def test_flop_count_equals_the_analytic_count(width):
    m = resnet.ResNet18(norm="group", width=width, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(2, 3, 32, 32)
    with torch.no_grad():
        _, fl = flops.count_flops(m, x)
    assert fl == 2 * _analytic_macs(width, 2)
    if width == 64:  # ~555 M MACs, 1.11 GFLOP per image forward
        assert abs(fl / 2 - 1.11e9) < 0.01e9


def test_peak_table_and_mfu(monkeypatch):
    assert flops.peak_bf16_flops("cpu") is None
    assert flops.mfu(None, 1.0) == (None, None)
    assert flops.mfu(2e12, 1.0, 2, "cpu") == (1.0, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_bf16_flops() == 989.4e12
    tf, frac = flops.mfu(989.4e12, 1.0)
    assert tf == pytest.approx(989.4) and frac == pytest.approx(1.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Some Other Card")
    assert flops.peak_bf16_flops() is None


def test_build_resnet_step_on_the_cpu():
    step, module, opt, meta = benchmarks.build_resnet_step(None, 1, 2, device="cpu", seed=3)
    assert meta["layout"] == "dp" and meta["topology"] == "mesh(data=1)"
    assert meta["n_chips"] == 1 and meta["dtype"] == torch.float32
    assert meta["n_params"] == 11_173_962
    assert isinstance(opt, torch.optim.SGD) and opt.defaults["momentum"] == 0.9
    ds = benchmarks.DeviceDataset(2, n_train=16, device="cpu")
    before = [p.detach().clone() for p in module.parameters()]
    dt, losses, step_s = benchmarks.timed_run(step, ds.feed, 2, 1, device="cpu")
    assert len(losses) == 3 and len(step_s) == 2 and dt > 0
    assert all(np.isfinite(losses))
    assert any(not torch.equal(a, p) for a, p in zip(before, module.parameters()))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_lab_resnet_dp_in_process(capsys):
    run = dp_pp.main(["--workload", "resnet", "--device", "cpu", "--iters", "1", "--batch", "2",
                      "--input", "fixed"])
    rec = _last_json(capsys.readouterr().out)
    assert rec["metric"] == "cifar10_resnet18_dp_samples_per_sec_per_chip"
    assert rec["input"] == "fixed-device-batch" and rec["value"] > 0
    (r,) = run["ranks"]
    assert len(r["losses"]) == dp_pp.WARMUP + 1 and all(np.isfinite(r["losses"]))
    # forward + backward: 3x the forward's products, less the stem's input gradient
    assert r["flops"] == 3 * 2 * _analytic_macs(64, 2) - 2 * 3 * 3 * 3 * 64 * 32 * 32 * 2
    assert r["params_device"] == ["cpu"] and r["data_device"] == "cpu"
    assert run["cards"] == 1 and rec["value"] == round(2 / r["dt"], 1)


def test_lab_resnet_pipeline_on_four_ranks(capsys):
    run = dp_pp.main(["--workload", "resnet", "--device", "cpu", "--iters", "1", "--pp",
                      "--ranks", "4", "--batch", "4", "--input", "fixed", "--timeout", "120"])
    rec = _last_json(capsys.readouterr().out)
    assert rec["metric"] == "cifar10_resnet18_dppp_samples_per_sec_per_chip"
    assert rec["input"] == "fixed-device-batch"
    ranks = run["ranks"]
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["backend"] for r in ranks} == {"gloo"}
    last = [r for r in ranks if r["coords"][1] == 1]
    assert last[0]["losses"] == last[1]["losses"] and len(last[0]["losses"]) == 4
    assert [r["losses"] for r in ranks if r["coords"][1] == 0] == [[], []]
    assert ranks[0]["boundary_shapes"] == [(128, 16, 16), (10,)]
    # four ranks share one device (the CPU): the per-chip value is the whole
    # world's, the global batch over the slowest rank's time
    assert run["cards"] == 1
    assert rec["value"] == round(4 / max(r["dt"] for r in ranks), 1)


# ------------------------------------------- the torchrun report (ROADMAP C1)


def torchrun_report_rank(rdv, per_rank: list, job):
    """One rank of a 2-rank gloo world that reports the way ``lab.dp_pp``
    does under torchrun: its own stub result (no model), the world's FLOPs
    and slowest seconds through ``world_totals``, then ``report_resnet`` on
    a list that holds only its own entry (what ``spawn`` returns there).
    Returns what it printed and returned."""
    import contextlib
    import io

    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with init_mesh(rdv, job.data, job.stages, "cpu") as mesh:
        mine = {**per_rank[rdv.rank], "coords": mesh.coords}
        mine["world_flops"], (mine["world_dt"],) = dp_pp.world_totals(mesh, mine["flops"],
                                                                      [mine["dt"]])
        ranks = [None] * rdv.world
        ranks[rdv.rank] = mine
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = dp_pp.report_resnet(ranks, job, 1, torch.device("cpu"))
        return {"printed": out.getvalue(), "report": report}


@pytest.mark.parametrize("stages", [1, 2], ids=["dp", "pipeline"])
def test_torchrun_report_is_the_worlds_from_one_rank(tmp_path, stages):
    """Each rank holds only its own result, as under torchrun: the one rank
    that reports (the last stage of pipeline 0) prints the world's summed
    FLOPs against the slowest rank's seconds; the other prints nothing."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    job = dp_pp.ResnetJob(data=2 // stages, stages=stages, microbatches=stages, batch=8,
                          iters=4)
    stub = {"losses": [2.0, 1.5, 1.25], "step_s": [0.5] * 4, "topology": "stub",
            "layout": "dp" if stages == 1 else "dppp", "input": "fixed-device-batch"}
    per_rank = [{**stub, "flops": 3_000_000_000, "dt": 2.0},
                {**stub, "flops": 1_000_000_000, "dt": 4.0}]
    out = spawn(torchrun_report_rank, 2, per_rank, job, timeout=60, tmpdir=str(tmp_path))
    reporter = stages - 1  # rank (0, stages - 1)
    assert out[1 - reporter] == {"printed": "", "report": None}
    mine = out[reporter]
    assert mine["report"]["flops"] == 4_000_000_000  # the whole step, every rank's share
    assert mine["report"]["samples_per_s_per_chip"] == 4 * 8 / 4.0  # the slowest rank
    line = json.loads(mine["printed"].strip().splitlines()[-1])
    assert line["value"] == 8.0 and line["input"] == "fixed-device-batch"
    assert "0.0040 TFLOP per step" in mine["printed"]


def test_llama_report_rank_is_the_last_stage_of_pipeline_0():
    ranks = [{"coords": divmod(r, 3), "rank": r} for r in range(6)]
    assert dp_pp.reporting_rank(ranks, 3)["rank"] == 2
    # under torchrun each process holds only its own result
    for r in range(6):
        mine = [x if x is not None and x["rank"] == r else None for x in ranks]
        got = dp_pp.reporting_rank(mine, 3)
        assert (got is not None) == (r == 2)
