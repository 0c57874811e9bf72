"""The port's perf observatory (``ddl25spring_tpu_torch/obs/perfscope.py``,
the bench's training telemetry, and the stdlib gate ``tools/perf_report.py``):
the twins of ``tests/test_perfscope.py`` that pass at the reference and need
no ``describe()`` registry, on the CPU, and parity with the JAX package.

- the step-wall decomposition is consistent: exposed comms never negative,
  the compute-only counterfactual within scheduling noise of the step;
- measured MFU is *defined* on the CPU (the calibrated ``cpu-host`` peak);
- records append to a JSONL ledger keyed by (strategy, mesh, host), and
  ``perf_report --check`` trips on a step slowed by a host sleep while a
  clean re-run passes;
- the training bench (``bench --smoke``, its ResNet step stubbed by a tiny
  model) writes every artifact and its rows pass the gates unedited, and the
  JAX package's ``summarize_run`` reads the port's run dir as the port's does.

Not twinned here (the ``describe()`` registry, collective micro-costs, the
schedule verifier and the H001 cross-reference: ROADMAP A12):
``test_decomposition_invariants`` (over ``measure_strategy("dp")``; its
bench-step counterpart is here), ``test_micro_costs_cover_inventory_exactly``,
``test_dp_record_carries_bucket_knob_fields``,
``test_record_carries_static_overlap_bound``,
``test_bucket_sweep_measures_grid_and_recommends``,
``test_attach_measured_costs_prices_h001`` and
``test_strategy_record_findings_ride_with_measured_slot``.
"""

import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch import benchmarks  # noqa: E402
from ddl25spring_tpu_torch.obs import perfscope  # noqa: E402

BATCH = 16


def _tiny_step(seed=0):
    """A bench-shaped step (``step(batch)`` updates its model in place and
    returns the loss) of a small MLP, with its fixed batch and meta."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(),
                                torch.nn.Linear(128, 10))
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=g)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    x = torch.randn(BATCH, 64, generator=g)
    y = torch.randint(0, 10, (BATCH,), generator=g)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(batch[0]), batch[1])
        loss.backward()
        opt.step()
        return loss.detach()

    meta = {"layout": "dp", "topology": "mesh(data=1)", "n_chips": 1, "batch": BATCH,
            "num_stages": 1, "num_microbatches": 1}
    return step, (x, y), meta


_CACHE: dict = {}


def _bench_record() -> dict:
    """Measure-once: the tiny step's bench record, shared by the invariants."""
    if "rec" not in _CACHE:
        step, batch, meta = _tiny_step()
        _CACHE["rec"] = perfscope.measure_bench_step(step, batch, meta, reps=4, warmup=1)
    return _CACHE["rec"]


# ------------------------------------------------ decomposition invariants


def test_bench_step_decomposition_invariants():
    rec = _bench_record()
    assert rec["step_s_p50"] > 0
    assert rec["step_s_p95"] >= rec["step_s_p50"] >= rec["step_s_min"]
    # one chip: the counterfactual is the same step timed again
    assert rec["compute_s_p50"] is not None
    assert rec["compute_s_p50"] <= rec["step_s_p50"] * 2
    assert rec["exposed_comms_s"] >= 0
    # no collective inventory yet (A12): nothing costed, no overlap figure
    assert rec["micro"] == [] and rec["micro_total_s"] == 0.0 and rec["overlap_eff"] is None
    # the two products forward, both weight gradients, and the hidden
    # activation's gradient (the input needs none)
    assert rec["flops"] == 2 * BATCH * (2 * 64 * 128 + 3 * 128 * 10)


def test_measured_mfu_defined_on_cpu_host():
    rec = _bench_record()
    assert rec["chip"] == "cpu-host"
    assert rec["peak_source"] == "calibrated-host"
    assert rec["peak_flops_per_chip"] and rec["peak_flops_per_chip"] > 0
    assert rec["measured_mfu"] == pytest.approx(
        rec["flops"] / (rec["step_s_p50"] * rec["peak_flops_per_chip"]))
    # the roofline projection reads compiled programs: none yet (A12)
    assert rec["projected_mfu"] is None and rec["projection_err"] is None
    assert "A12" in rec["projection_note"]


def test_record_schema_and_ledger_key_fields():
    rec = _bench_record()
    required = {
        "record", "schema", "ts", "strategy", "mesh", "n_chips", "host",
        "git_sha", "torch_version", "backend", "chip",
        "peak_flops_per_chip", "peak_source", "reps", "warmup",
        "step_s_p50", "step_s_p95", "step_s_min", "compute_s_p50",
        "exposed_comms_s", "micro_total_s", "overlap_eff", "flops",
        "bytes_accessed", "wire_bytes", "measured_mfu", "projected_mfu",
        "projected_bound", "projection_err", "micro",
    }
    assert required <= set(rec)
    assert rec["record"] == "perf" and rec["strategy"] == "bench-dp"
    assert rec["mesh"] == {"data": 1} and rec["n_chips"] == 1 and rec["backend"] == "cpu"
    assert rec["host"] == perfscope.host_fingerprint("cpu")
    json.dumps(rec)  # the ledger contract: serializable as-is


def test_perf_cell_carries_the_bench_contract_keys():
    cell = perfscope.perf_cell(_bench_record())
    assert {"measured_mfu", "overlap_eff", "exposed_comms_ms", "projection_err"} <= set(cell)
    assert cell["exposed_comms_ms"] is not None and cell["exposed_comms_ms"] >= 0
    assert cell["measured_mfu"] > 0


def test_perf_cell_is_the_jax_cell():
    from ddl25spring_tpu.obs import perfscope as jperf

    rec = _bench_record()
    for r in (rec, dict(rec, overlap_eff=0.25, static_overlap_bound=0.5, compute_s_p50=None)):
        assert perfscope.perf_cell(r) == jperf.perf_cell(r)


def test_calibrated_host_peak_cached():
    from ddl25spring_tpu_torch.utils.flops import (
        calibrated_host_peak_flops,
        chip_peak_flops,
        host_peak_spec,
    )

    p1 = calibrated_host_peak_flops()
    assert p1 and p1 > 0
    t0 = time.perf_counter()
    assert calibrated_host_peak_flops() == p1  # cache hit, no re-run
    assert time.perf_counter() - t0 < 0.05
    assert chip_peak_flops("cpu") == p1 and chip_peak_flops("cpu", allow_host=False) is None
    assert host_peak_spec("cpu") == ("cpu-host", {"peak_bf16_flops": p1})


def test_registry_measurement_raises_naming_a12():
    for fn in (perfscope.measure_strategy, perfscope.build_micro_benches,
               perfscope.time_micro_benches, perfscope.micro_site_records, perfscope.main):
        with pytest.raises(NotImplementedError, match="A12"):
            fn("dp")


# -------------------------------------------- ledger + regression gate


def _toy_step():
    """A step heavy enough (a chain of 384 x 384 products, tens of ms on one
    core) that scheduling jitter is small relative to its wall."""
    a = torch.full((384, 384), 0.5 / 384)

    def f(x):
        for _ in range(8):
            x = x @ a
        return x

    return f, (a,)


def _slowed_step(sleep_s: float = 0.25):
    """The same toy step with a host sleep inside the call: the 'someone put
    a host round-trip on the hot path' regression the gate exists for."""
    f, args = _toy_step()

    def slow(x):
        y = f(x)
        time.sleep(sleep_s)
        return y

    return slow, args


def test_ledger_roundtrip_and_torn_tail(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    rec = perfscope.measure_callable(*_toy_step(), strategy="toy", reps=3, warmup=1)
    perfscope.append_ledger(rec, led)
    with open(led, "a") as f:
        f.write('{"record": "perf", "torn')  # killed mid-write
    out = perfscope.read_ledger(led)
    assert len(out) == 1
    assert out[0]["strategy"] == "toy"


def test_slowed_step_trips_the_gate_and_clean_rerun_passes(tmp_path):
    """Clean baseline -> injected slowdown fails ``perf_report --check`` ->
    clean re-run passes again."""
    import tools.perf_report as perf_report

    band = ["--check", "--tolerance", "1.0"]
    led = str(tmp_path / "ledger.jsonl")
    fast_fn, fast_args = _toy_step()
    for _ in range(2):
        perfscope.append_ledger(perfscope.measure_callable(
            fast_fn, fast_args, strategy="toy", reps=7, warmup=1), led)
    assert perf_report.main(["--ledger", led, *band]) == 0

    perfscope.append_ledger(perfscope.measure_callable(
        *_slowed_step(), strategy="toy", reps=3, warmup=1), led)
    assert perf_report.main(["--ledger", led, *band]) == 1

    perfscope.append_ledger(perfscope.measure_callable(
        fast_fn, fast_args, strategy="toy", reps=7, warmup=1), led)
    assert perf_report.main(["--ledger", led, *band]) == 0


def test_check_is_per_host_and_needs_a_baseline(tmp_path, capsys):
    import tools.perf_report as perf_report

    led = str(tmp_path / "ledger.jsonl")
    rec = perfscope.measure_callable(*_toy_step(), strategy="toy", reps=3, warmup=1)
    perfscope.append_ledger(rec, led)
    # single record: no baseline, check passes with a note
    assert perf_report.main(["--ledger", led, "--check"]) == 0
    assert "no baseline" in capsys.readouterr().err
    # a 100x slower record from a DIFFERENT host never gates this one
    other = dict(rec, host="elsewhere/64cpu/NVIDIA H100 80GB HBM3",
                 step_s_p50=rec["step_s_p50"] * 100)
    perfscope.append_ledger(other, led)
    assert perf_report.main(["--ledger", led, "--check"]) == 0
    # missing ledger: rc 2 under --check, rc 0 without
    assert perf_report.main(["--ledger", str(tmp_path / "absent.jsonl"), "--check"]) == 2
    assert perf_report.main(["--ledger", str(tmp_path / "absent.jsonl")]) == 0


def test_min_overlap_eff_floor_gates_and_skips_undefined(tmp_path, capsys):
    import tools.perf_report as perf_report

    led = str(tmp_path / "ledger.jsonl")
    base = perfscope.measure_callable(*_toy_step(), strategy="toy", reps=2, warmup=1)
    low = dict(base, strategy="ov-low", overlap_eff=0.2, exposed_comms_s=0.008,
               micro_total_s=0.01)
    high = dict(base, strategy="ov-high", overlap_eff=0.9, exposed_comms_s=0.001,
                micro_total_s=0.01)
    undefined = dict(base, strategy="ov-none", overlap_eff=None)
    for r in (low, high, undefined):
        perfscope.append_ledger(r, led)
    assert perf_report.main(["--ledger", led, "--check", "--min-overlap-eff", "0.5"]) == 1
    err = capsys.readouterr().err
    fails = [ln for ln in err.splitlines() if ln.startswith("CHECK FAIL")]
    assert len(fails) == 1
    assert "ov-low" in fails[0] and "overlap_eff 0.200" in fails[0]
    assert perf_report.main(["--ledger", led, "--check", "--min-overlap-eff", "0.1"]) == 0
    assert perf_report.main(["--ledger", led, "--check"]) == 0


# ----------------------------------------------------- report rendering


def test_perf_report_table_renders(tmp_path, capsys):
    import tools.perf_report as perf_report

    led = str(tmp_path / "ledger.jsonl")
    perfscope.append_ledger(_bench_record(), led)
    assert perf_report.main(["--ledger", led]) == 0
    out = capsys.readouterr().out
    assert "strategy bench-dp" in out and "step p50" in out and "MFU" in out


def test_perf_report_format_json_is_machine_readable(tmp_path, capsys):
    import tools.perf_report as perf_report

    led = str(tmp_path / "ledger.jsonl")
    base = _bench_record()
    perfscope.append_ledger(base, led)
    slow = dict(base, step_s_p50=base["step_s_p50"] * 50, ts=base["ts"] + 1)
    perfscope.append_ledger(slow, led)

    assert perf_report.main(["--ledger", led, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["record"] == "perf_report"
    (g,) = doc["groups"]
    assert g["strategy"] == "bench-dp" and len(g["records"]) == 2
    assert doc["check"]["ok"] is False and doc["check"]["fails"] == 1
    assert any("step_s_p50" in f for f in g["fails"])
    assert perf_report.main(["--ledger", led, "--format", "json", "--check"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out)["check"]["fails"] == 1
    assert "CHECK FAIL" in out.err


def test_obs_report_renders_performance_section(tmp_path):
    from ddl25spring_tpu_torch.obs.report import format_report, summarize_run

    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"record": "header", "n_chips": 1}) + "\n")
        f.write(json.dumps({"record": "step", "step": 0, "wall_s": 0.1, "label": "x"}) + "\n")
    perfscope.write_run_perf(_bench_record(), run_dir)
    text = format_report(summarize_run(run_dir))
    assert "performance (perf.json" in text
    assert "measured MFU" in text
    assert "overlap efficiency" in text
    assert "cpu-host" in text
    assert "compile analytics: not in the port yet" in text


# ------------------------------------------- the training bench's wiring


@pytest.fixture(scope="module")
def stubbed_bench(tmp_path_factory):
    """``bench --smoke --device cpu --obs-dir D`` with the ResNet run stubbed
    by the tiny step, driven through ``timed_run``'s telemetry path with the
    hooks the bench hands it."""
    from ddl25spring_tpu_torch import bench, obs
    from ddl25spring_tpu_torch.lab import dp_pp

    d = tmp_path_factory.mktemp("bench_smoke")
    seen = []

    def resnet_stub(argv, telemetry=None, warmup=3, n_train=None):
        seen.append((argv, warmup, n_train))
        step, batch, meta = _tiny_step()
        feed = lambda: batch  # noqa: E731
        _, warm, _ = benchmarks.timed_run(step, feed, 0, warmup - 1, label="hbm",
                                          goodput=telemetry.goodput)
        sample = telemetry.memscope
        dt, timed, step_s = benchmarks.timed_run(
            step, feed, 4, 0, logger=telemetry.logger, label="hbm", samples_per_step=BATCH,
            goodput=telemetry.goodput,
            on_step=(lambda i, _loss: sample.sample(i)) if sample is not None else None)
        line = benchmarks.report_line("dp", 4 * BATCH / dt, "hbm-resident-shuffle", None, None)
        return {"line": line, "ranks": [{"live": (step, batch, meta), "layout": "dp",
                                         "topology": "mesh(data=1)", "input": "hbm",
                                         "flops": 1.0, "losses": warm + timed,
                                         "step_s": step_s}]}

    prev = obs.get_recorder()
    obs.flight.reset()  # the run's health is its own, not the worker's earlier tests'
    mp = pytest.MonkeyPatch()
    mp.setattr(dp_pp, "main", resnet_stub)
    try:
        with obs.scoped(False):  # --obs-dir turns telemetry on for the run
            rec = bench.main(["--smoke", "--device", "cpu", "--obs-dir", str(d / "run"),
                              "--perf-ledger", str(d / "ledger.jsonl"), "--perf-reps", "3"])
    finally:
        mp.undo()
        obs.set_recorder(prev)
        obs.timeline.configure(None)
        obs.flight.configure(run_dir=None)
    return rec, d, seen


def test_bench_training_telemetry_with_a_stubbed_step(stubbed_bench, capsys):
    """The smoke cuts reach the run; the line carries the perf, mem and
    goodput cells and the phases; the run dir holds every artifact; the
    ledger's perf, mem and goodput rows and the run dir pass the gate tools
    unedited; the port's report renders the run."""
    from ddl25spring_tpu_torch.obs.report import format_report, main as report_main
    from ddl25spring_tpu_torch.obs.report import summarize_run
    from tools import goodput_report, mem_report, perf_report

    rec, d, seen = stubbed_bench
    run, led = str(d / "run"), str(d / "ledger.jsonl")
    assert seen == [(["--workload", "resnet", "--device", "cpu", "--batch", "64", "--iters",
                      "8", "--scan-steps", "1"], 2, 512)]
    tel = rec["telemetry"]
    assert rec["secondary"] == [] and tel["enabled"] is True
    assert tel["perf"]["chip"] == "cpu-host" and tel["perf"]["measured_mfu"] > 0
    assert tel["mem"]["enabled"] and tel["mem"]["budget"]["within_band"]
    assert tel["goodput"]["sum_check"]["ok"] and tel["goodput"]["scope"] == "train_attempt"
    assert tel["phases"]["hbm"]["steps"] == 4
    for name in ("metrics.jsonl", "counters.json", "trace.json", "timeline.jsonl",
                 "flight.json", "perf.json", "mem.json", "goodput.json"):
        assert os.path.exists(os.path.join(run, name)), name
    rows = [json.loads(line)["record"] for line in open(led)]
    assert rows == ["perf", "mem", "goodput"]
    assert perf_report.main(["--ledger", led, "--check"]) == 0
    assert mem_report.main(["--run", run, "--check"]) == 0
    assert mem_report.main(["--ledger", led, "--check"]) == 0
    assert goodput_report.main(["--ledger", led, "--check"]) == 0
    assert goodput_report.main(["--run", run, "--check"]) == 0
    text = format_report(summarize_run(run))
    for section in ("performance (perf.json", "memory (mem.json", "goodput (goodput.json",
                    "health (flight.json", "hbm"):
        assert section in text, section
    assert report_main([run, "--check-health"]) == 0
    capsys.readouterr()


def test_jax_summarize_run_reads_the_ports_run_dir(stubbed_bench):
    """Parity: the JAX package's ``summarize_run`` and the port's give the
    same summary of one port run dir."""
    from ddl25spring_tpu.obs.report import summarize_run as jax_summarize
    from ddl25spring_tpu_torch.obs.report import summarize_run

    _, d, _ = stubbed_bench
    run = str(d / "run")
    ours, theirs = summarize_run(run), jax_summarize(run)
    assert json.loads(json.dumps(ours, default=str)) == json.loads(
        json.dumps(theirs, default=str))


# --------------------------------------------- bench --smoke contract pin


@pytest.mark.slow
def test_bench_smoke_emits_perf_cell(tmp_path):
    """The whole ``bench --smoke --device cpu`` in a subprocess (the real
    ResNet-18 at batch 64): its line carries a full telemetry.perf cell and
    the record lands in the ledger and the run dir."""
    led = str(tmp_path / "ledger.jsonl")
    obs_dir = str(tmp_path / "run")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "ddl25spring_tpu_torch.bench", "--smoke", "--device", "cpu",
         "--obs-dir", obs_dir, "--perf-ledger", led],
        capture_output=True, text=True, timeout=900, cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    d = json.loads([ln for ln in r.stdout.splitlines() if ln.strip()][-1])
    perf = d["telemetry"]["perf"]
    for k in ("measured_mfu", "overlap_eff", "exposed_comms_ms", "projection_err"):
        assert k in perf, (k, perf)
    assert perf["measured_mfu"] > 0
    assert perf["exposed_comms_ms"] >= 0
    assert perf["chip"] == "cpu-host"
    recs = perfscope.read_ledger(led)
    assert recs and recs[-1]["strategy"] == "bench-dp"
    assert os.path.exists(os.path.join(obs_dir, perfscope.PERF_BASENAME))
