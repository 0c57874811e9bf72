"""The port's memory observatory (``ddl25spring_tpu_torch/obs/memscope.py``,
its serving and bench wiring, and ``tools/mem_report.py``): the twins of
``tests/test_memscope.py`` that pass at the reference, on the CPU, and parity
with the JAX package's module on the same inputs.

- **leak injection fires, the near miss stays quiet**: a page seated in a
  page-table row across drain is named by slot and rid; a host list growing
  across a window fires the growth detector once, a plateau never does.
- **budget against measured**: the serving engine's static bill covers its
  measured live bytes within the band, and ``mem_report --check`` turns the
  record's verdicts into exit codes.  On the CPU the live bytes are a walk
  of the live tensors, so this file keeps no tensor alive across its tests
  (``params`` is per test) and the walk sees each test's own.
- **zero cost when off**: with ``DDL25_MEMSCOPE=0`` the engine's token
  streams, clock and pool are bitwise those of a sampled run.
- **counter tracks**: ``trace_export`` renders the engine's ``mem_sample``
  events as Perfetto counters.
- **parity**: ``Series`` and ``GrowthDetector`` fire on the same steps as
  JAX's; ``budget_cell`` and ``mem_cell`` are JAX's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models.llama import Llama  # noqa: E402
from ddl25spring_tpu_torch.obs import memscope, state  # noqa: E402
from ddl25spring_tpu_torch.obs.memscope import (  # noqa: E402
    GrowthDetector,
    MemScope,
    Series,
    budget_cell,
    host_rss_bytes,
    live_array_summary,
    mem_cell,
    mem_record,
    pool_leak_check,
    pool_snapshot,
    write_run_mem,
)
from ddl25spring_tpu_torch.obs.recorder import flight  # noqa: E402
from ddl25spring_tpu_torch.obs.timeline import timeline  # noqa: E402
from ddl25spring_tpu_torch.serve import driver  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import ServeEngine  # noqa: E402

CFG = driver.serve_model("tiny")


@pytest.fixture
def params():
    m = Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return m.requires_grad_(False)


def make_engine(params, **kw):
    # the test_torch_serve smoke geometry
    kw.setdefault("page_len", 4)
    kw.setdefault("n_pages", 16)
    kw.setdefault("max_slots", 2)
    kw.setdefault("pages_per_seq", 4)
    kw.setdefault("prefill_batch", 1)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("clock", "virtual")
    return ServeEngine(params, CFG, **kw)


def drain(eng, max_steps: int = 500):
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


# ------------------------------------------------ series + detector


def test_series_below_cap_is_exact_and_summarized():
    s = Series(cap=8)
    for v in (3, 1, 9, 4):
        s.append(v)
    assert list(s) == [3, 1, 9, 4]
    d = s.summary()
    assert d["count"] == 4 and d["sampled"] == 4
    assert d["max"] == 9 and d["min"] == 1


def test_series_caps_memory_but_keeps_exact_extremes():
    s = Series(cap=4)
    for v in range(100):
        s.append(v)
    assert len(s) == 4
    d = s.summary()
    assert d["count"] == 100 and d["sampled"] == 4
    assert d["max"] == 99 and d["min"] == 0


def test_growth_detector_fires_once_naming_the_source():
    det = GrowthDetector(window=4, min_growth_bytes=100)
    v = None
    for i in range(6):
        got = det.observe("replay_buffer", 1000 + i * 50, step=i)
        if got is not None:
            assert v is None, "detector fired twice"
            v = got
    assert v is not None
    assert v["kind"] == "mem" and v["source"] == "replay_buffer"
    assert v["growth_bytes"] >= 100 and v["window"] == 4
    # latched: the same still-growing series never re-fires
    assert det.observe("replay_buffer", 10_000, step=9) is None


def test_growth_detector_near_miss_plateau_stays_quiet():
    det = GrowthDetector(window=4, min_growth_bytes=100)
    # grows, but plateaus once inside every window -> not monotone
    series = [100, 200, 300, 300, 400, 500, 500, 600, 700, 700]
    assert all(det.observe("spiky", v, step=i) is None for i, v in enumerate(series))


def test_growth_detector_below_floor_stays_quiet():
    det = GrowthDetector(window=4, min_growth_bytes=1 << 20)
    # strictly increasing, but by allocator-noise amounts
    assert all(det.observe("noise", 1000 + i, step=i) is None for i in range(10))


def test_series_and_detector_fire_on_the_jax_steps():
    """Parity: the same streams through JAX's and the port's ``Series`` and
    ``GrowthDetector`` give the same reservoirs, summaries and violations,
    on the same steps."""
    from ddl25spring_tpu.obs import memscope as jmem

    rng = np.random.default_rng(0)
    stream = rng.integers(0, 1 << 30, 700).tolist()
    series = [Series(cap=16), jmem.Series(cap=16)]
    for x in stream:
        for s in series:
            s.append(x)
    assert list(series[0]) == list(series[1])
    assert series[0].summary() == series[1].summary()
    walk = np.cumsum(rng.integers(-1, 3, 300) * 300_000).tolist()
    for window, floor in ((4, 100), (8, 1 << 20), (3, 0)):
        fired = []
        for det in (GrowthDetector(window, floor), jmem.GrowthDetector(window, floor)):
            fired.append([(i, v) for i, x in enumerate(walk)
                          for v in [det.observe("rss", x, step=i)] if v is not None])
        assert fired[0] == fired[1]
    assert fired[0], "the walk never grew for 3 samples running"


# ------------------------------------------------- host-side probes


def test_host_rss_and_live_array_summary_sanity():
    rss = host_rss_bytes()
    assert rss is not None and rss > (1 << 20)
    x = torch.ones((64, 64), dtype=torch.float32)
    view = x[:8]  # a view shares the storage: counted once  # noqa: F841
    s = live_array_summary(top=5)
    assert s["count"] >= 1
    assert s["total_bytes"] >= x.numel() * 4
    assert s["largest"], s
    top = s["largest"][0]
    for k in ("shape", "dtype", "bytes", "device"):
        assert k in top, (k, top)
    assert sum(v["bytes"] for v in s["by_device"].values()) == s["total_bytes"]
    assert sum(1 for t in memscope.live_tensors("cpu") if t[1] is x or t[1] is view) == 1
    assert memscope.live_total_bytes("cpu") >= x.numel() * 4
    del x


def test_flight_dump_carries_live_array_summary(tmp_path):
    """A crash dump answers 'what was resident': the live-tensor census rides
    every flight.json."""
    keep = torch.arange(4096, dtype=torch.int32)  # resident at dump time
    path = flight.dump(str(tmp_path / "flight.json"), reason="test")
    doc = json.load(open(path))
    la = doc["live_arrays"]
    assert la["count"] >= 1
    assert la["total_bytes"] >= keep.numel() * 4
    assert doc["host_rss_bytes"] > (1 << 20)
    assert any(v["bytes"] == keep.numel() * 4 and v["shape"] == [4096]
               for v in la["largest"]), la["largest"]


# -------------------------------------------- scope sampling + gating


def test_memscope_sample_is_gated_and_thinned():
    resident = torch.ones((32, 32), dtype=torch.float32)  # noqa: F841
    scope = MemScope(label="t", every=2, device="cpu")
    assert scope.sample(0) is None  # obs off -> no-op
    with state.scoped(True):
        s0 = scope.sample(0)
        s1 = scope.sample(1)  # off-cadence (every=2)
        s2 = scope.sample(2)
    assert s0 is not None and s2 is not None and s1 is None
    assert scope.live_bytes_peak >= s0["live_bytes"] > 0
    assert scope.live_bytes_baseline == s0["live_bytes"]
    cell = scope.cell()
    assert cell["samples"] == 2 and cell["every"] == 2
    assert memscope.default_every("cpu") == memscope.CPU_EVERY and memscope.default_every(
        "cuda") == 1


def test_memscope_flag_gates_without_obs_state():
    scope = MemScope(label="t", device="cpu")
    with state.scoped(True), memscope.scoped(False):
        assert memscope.enabled() is False
        assert scope.sample(0) is None
    assert len(scope.live_bytes) == 0


def test_memscope_watch_growth_fires_into_flight():
    """A host-side list growing across the window fires ONE violation naming
    the watch, mirrored to the flight ring as kind="mem"."""
    buf: list[bytes] = []
    scope = MemScope(label="train", window=4, min_growth_bytes=64, device="cpu")
    scope.watch("replay_buffer", lambda: len(buf) * 1024)
    with state.scoped(True):
        for i in range(8):
            buf.append(b"x")
            scope.sample(i)
    assert len(scope.violations) == 1
    v = scope.violations[0]
    assert v["source"] == "replay_buffer" and v["scope"] == "train"
    assert scope.cell()["growth_violations"] == [v]
    recs = [r for r in flight.snapshot()["records"]
            if r.get("kind") == "mem" and r.get("source") == "replay_buffer"]
    assert recs, "growth violation never reached the flight ring"


def test_memscope_near_miss_watch_stays_quiet():
    sizes = [100, 200, 300, 300, 400, 500, 500, 600]  # plateaus
    it = iter(sizes)
    scope = MemScope(label="train", window=4, min_growth_bytes=64, device="cpu")
    scope.watch("steady_cache", lambda: next(it))
    with state.scoped(True):
        for i in range(len(sizes)):
            scope.sample(i)
    assert scope.violations == []


# ----------------------------------------------- pool telemetry


def test_pool_snapshot_and_clean_drain_leak_check():
    timeline.configure(None)
    # the CPU's reading counts the whole process: the tensors other tests
    # left alive in it are not this engine's to account for
    floor = memscope.live_total_bytes("cpu")
    params = Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    eng = make_engine(params.requires_grad_(False))
    with state.scoped(True):
        for i in range(3):
            assert eng.submit(eng.make_request([5 + i, 9, 11, 3], 4)) is None
        drain(eng)
    # the leak check first: it flushes the releases the drain left pending
    leak = eng.mem_leak_check()
    assert leak["ok"] is True and leak["leaked_pages"] == 0
    assert leak["leaks"] == []
    snap = eng.mem_pool_snapshot()
    assert snap["n_pages"] == 16
    assert snap["used_pages"] == snap["cache_held_pages"] + snap["table_held_pages"]
    assert snap["table_held_pages"] == 0  # drained + flushed
    assert 0.0 <= snap["fragmentation"] <= 1.0
    # the histogram covers exactly the held pages (ref > 0)
    assert sum(snap["refcount_hist"].values()) == snap["used_pages"]
    # the sampler rode the ticks: the peak within the static bill's band
    assert eng.memscope.live_bytes_peak > 0
    budget = eng.mem_budget_bytes()
    assert budget > 0
    assert budget_cell(eng.memscope.live_bytes_peak - floor, budget)["within_band"] is True


def test_injected_page_table_leak_is_named_by_slot_and_rid(params):
    """Seat a page back into a page-table row after drain: the detector fails
    naming the slot and the last rid that occupied it, and the verdict
    reaches the flight ring."""
    timeline.configure(None)
    eng = make_engine(params)
    with state.scoped(True):
        req = eng.make_request([5, 9, 11, 3], 4)
        assert eng.submit(req) is None
        drain(eng)
        eng.mem_leak_check()  # flush the drain's releases first
        # the injection: page 7 held by slot 1's table row + refcount
        eng.pool["page_table"][1, 0] = 7
        eng.pool["refcount"][7] += 1
        eng.pool["free"][7] = False
        eng._slot_last_rid[1] = req.rid
        leak = eng.mem_leak_check()
    assert leak["ok"] is False
    assert leak["leaked_pages"] == 1
    (entry,) = [x for x in leak["leaks"] if x["held_by"] == "page_table"]
    assert entry["page"] == 7 and entry["slot"] == 1
    assert entry["rid"] == req.rid
    recs = [r for r in flight.snapshot()["records"]
            if r.get("kind") == "mem" and r.get("source") == "kv_pool_leak"]
    assert recs and recs[-1]["leaked_pages"] == 1


def test_orphan_refcount_beyond_cache_budget_is_a_leak():
    pool = {
        "free": np.array([False, False, True, True]),
        "refcount": np.array([1, 1, 0, 0]),
        "page_table": np.full((2, 2), -1),
    }
    # both held pages accounted to the cache -> clean
    ok = pool_leak_check(pool, cache_held_pages=2)
    assert ok["ok"] is True and ok["leaks"] == []
    # only one accounted -> one orphan leak
    bad = pool_leak_check(pool, cache_held_pages=1)
    assert bad["ok"] is False and bad["leaked_pages"] == 1
    (entry,) = bad["leaks"]
    assert entry["held_by"] == "orphan_refcount"


def test_pool_snapshot_fragmentation_of_interleaved_free_pages():
    pool = {
        "free": np.array([True, False, True, False, True, True]),
        "refcount": np.array([0, 1, 0, 1, 0, 0]),
        "page_table": np.full((2, 2), -1),
    }
    snap = pool_snapshot(pool)
    assert snap["used_pages"] == 2 and snap["free_pages"] == 4
    assert snap["free_runs"]["count"] == 3
    assert snap["free_runs"]["max"] == 2
    assert snap["fragmentation"] == pytest.approx(1 - 2 / 4)


# ------------------------------------------------ zero cost when off


def _served(params, mem_on: bool):
    eng = make_engine(params, prefill_batch=2, trace_label="serve")
    with state.scoped(True), memscope.scoped(mem_on):
        reqs = [eng.make_request([5 + i, 9, 11, 3], 6) for i in range(3)]
        for r in reqs:
            assert eng.submit(r) is None
        drain(eng)
    return eng, reqs


def test_tokens_bitwise_identical_with_memscope_off(params):
    """DDL25_MEMSCOPE=0 under obs-on leaves the token streams and the virtual
    clock bitwise unchanged: sampling is host-only."""
    timeline.configure(None)
    off, off_reqs = _served(params, False)
    on, on_reqs = _served(params, True)
    assert [r.tokens for r in on_reqs] == [r.tokens for r in off_reqs]
    assert on.now() == off.now() and on._vtime == off._vtime
    assert on.memscope.live_bytes.count > 0 and off.memscope.live_bytes.count == 0


def test_engine_tokens_and_pool_bitwise_with_memscope_toggled(params):
    """The twin of ``test_decode_tick_hlo_identical_with_memscope_toggled``:
    no compiled program to compare, so the engine's whole state is -- its
    token streams and every pool tensor bitwise equal with the scope on and
    off."""
    timeline.configure(None)
    off, off_reqs = _served(params, False)
    on, on_reqs = _served(params, True)
    assert [r.tokens for r in on_reqs] == [r.tokens for r in off_reqs]
    for name, t in on.pool.items():
        assert torch.equal(t, off.pool[name]), name


def test_mem_sample_timeline_events_present_iff_scope_on(params, tmp_path):
    from ddl25spring_tpu_torch.obs.timeline import read_timeline

    def run(mem_on: bool, sub: str):
        run_dir = tmp_path / sub
        timeline.configure(str(run_dir))
        try:
            with state.scoped(True), memscope.scoped(mem_on):
                eng = make_engine(params)
                assert eng.submit(eng.make_request([5, 9, 11, 3], 4)) is None
                drain(eng)
                timeline.flush()
        finally:
            timeline.configure(None)
        _, events = read_timeline(str(run_dir))
        return [e for e in events if e["kind"] == "mem_sample"]

    on = run(True, "on")
    assert on, "no mem_sample events with the scope on"
    for e in on:
        assert e["live_bytes"] > 0
        assert e["engine"] == "serve"
        assert e["pool_pages"] == 16
        assert "pool_used" in e and "queue_depth" in e
    assert run(False, "off") == []


# -------------------------------------- record envelope + the gates


def _good_record(**over):
    scope = MemScope(label="t", device="cpu")
    resident = torch.ones(16)  # something live to sample  # noqa: F841
    with state.scoped(True):
        scope.sample(0)
    rec = mem_record(
        strategy="serve/tiny",
        mesh={"replicas": 1},
        scope_cell=scope.cell(),
        budget=budget_cell(100, 100),
        pool=None,
        leaks=[{"ok": True, "leaked_pages": 0, "leaks": []}],
        device="cpu",
    )
    rec.update(over)
    return rec


def test_mem_record_round_trips_through_mem_json_and_cell(tmp_path):
    rec = _good_record()
    assert rec["record"] == "mem" and rec["leaked_pages"] == 0
    assert rec["host"].endswith("/cpu") and rec["torch_version"] == torch.__version__
    path = write_run_mem(rec, str(tmp_path))
    assert json.load(open(path)) == json.loads(json.dumps(rec))
    cell = mem_cell(rec)
    assert cell["enabled"] is True
    assert cell["live_bytes_peak"] > 0
    assert cell["budget"]["within_band"] is True
    assert cell["leaked_pages"] == 0
    assert cell["growth_violations"] == 0


@pytest.mark.parametrize("config, capability, want", [
    (None, (9, 0), 32 << 20),
    (None, (8, 0), (8 << 20) + (128 << 10)),
    (":4096:8", (8, 0), 32 << 20),
    (":4096:2:16:8", (9, 0), (8 << 20) + (128 << 10)),
])
def test_blas_workspace_bytes_follows_torchs_rule(monkeypatch, config, capability, want):
    """The serving band's workspace term: ``CUBLAS_WORKSPACE_CONFIG``'s
    ``:KiB:count`` pairs, else PyTorch's default for the card's arch; none
    on the CPU."""
    if config is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", config)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: capability)
    assert memscope.blas_workspace_bytes("cuda:0") == want
    assert memscope.blas_workspace_bytes("cpu") == 0


def test_budget_cell_band_semantics():
    assert budget_cell(149, 100, tol=0.5)["within_band"] is True
    assert budget_cell(151, 100, tol=0.5)["within_band"] is False
    assert budget_cell(100, None)["available"] is False
    assert budget_cell(100, 0)["available"] is False
    assert memscope.describe_budget_bytes("dp") is None


def test_budget_and_mem_cells_are_the_jax_cells():
    """Parity: ``budget_cell`` and ``mem_cell`` give JAX's dicts on the same
    inputs (the record's identity keys aside, which name the framework)."""
    from ddl25spring_tpu.obs import memscope as jmem

    for args in ((149, 100, 0.5, "static"), (151, 100, 0.5, "x"), (100, None, None, "y"),
                 (3, 7, None, "serve_static_accounting")):
        m, b, tol, src = args
        assert budget_cell(m, b, tol=tol, source=src) == jmem.budget_cell(m, b, tol=tol,
                                                                          source=src)
    pool = {"n_pages": 16, "used_pages": 3, "occupancy": 0.1875, "cache_held_pages": 2,
            "table_held_pages": 1, "fragmentation": 0.1, "free_runs": {}}
    rec = _good_record(pool=pool, leaked_pages=1, growth_violations=2, reshape_steps=[
        {"step_down_bytes": 600}, {"step_down_bytes": 50}])
    assert mem_cell(rec) == jmem.mem_cell(rec)
    assert mem_cell(_good_record()) == jmem.mem_cell(_good_record())


def test_mem_report_check_passes_clean_and_fails_injected_leak(tmp_path):
    from tools.mem_report import main as mem_main

    good = tmp_path / "good"
    good.mkdir()
    write_run_mem(_good_record(), str(good))
    assert mem_main(["--run", str(good), "--check"]) == 0

    leaky = tmp_path / "leaky"
    leaky.mkdir()
    write_run_mem(_good_record(
        leaked_pages=2,
        leaks=[{"ok": False, "leaked_pages": 2, "leaks": [
            {"page": 7, "refcount": 1, "held_by": "page_table", "slot": 1, "rid": 3},
            {"page": 9, "refcount": 2, "held_by": "orphan_refcount"},
        ]}],
    ), str(leaky))
    assert mem_main(["--run", str(leaky), "--check"]) == 1

    breach = tmp_path / "breach"
    breach.mkdir()
    write_run_mem(_good_record(budget=budget_cell(200, 100, tol=0.5)), str(breach))
    assert mem_main(["--run", str(breach), "--check"]) == 1
    # no mem.json at all -> no-data exit, distinct from a failure
    assert mem_main(["--run", str(tmp_path / "void"), "--check"]) == 2


def test_mem_report_require_step_down(tmp_path):
    from tools.mem_report import main as mem_main

    flat = tmp_path / "flat"
    flat.mkdir()
    write_run_mem(_good_record(reshape_steps=[]), str(flat))
    assert mem_main(["--run", str(flat), "--check", "--require-step-down"]) == 1

    stepped = tmp_path / "stepped"
    stepped.mkdir()
    write_run_mem(_good_record(reshape_steps=[{
        "scope": "serve", "reason": "device_loss",
        "live_bytes_before": 1000, "live_bytes_after": 400,
        "step_down_bytes": 600, "leak_ok": True, "leaked_pages": 0,
    }]), str(stepped))
    assert mem_main(["--run", str(stepped), "--check", "--require-step-down"]) == 0


def test_obs_report_exit_code_4_on_mem_violation(tmp_path):
    """The exit-code matrix of the port's report CLI: a leaky mem.json under
    --check-health exits 4, distinct from health's 3."""
    from ddl25spring_tpu_torch.obs.report import main as obs_main

    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "metrics.jsonl").write_text("")
    write_run_mem(_good_record(leaked_pages=1), str(run_dir))
    assert obs_main([str(run_dir), "--check-health"]) == 4
    write_run_mem(_good_record(), str(run_dir))
    assert obs_main([str(run_dir), "--check-health"]) == 0


# ------------------------------------------------- counter tracks


def test_trace_export_renders_the_engines_counter_tracks(params, tmp_path):
    """The engine's own ``mem_sample`` events become Perfetto counters on the
    timeline's time base, and ``--min-counter-tracks`` gates their number."""
    from tools.trace_export import main as export_main, merge

    run_dir = tmp_path / "run"
    timeline.configure(str(run_dir))
    try:
        with state.scoped(True):
            eng = make_engine(params)
            assert eng.submit(eng.make_request([5, 9, 11, 3], 4)) is None
            drain(eng)
            timeline.flush()
    finally:
        timeline.configure(None)
    doc, notes = merge(str(run_dir))
    counters = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    names = {e["name"] for e in counters}
    assert notes["counter_tracks"] == len(names) == 5
    for e in counters:
        (field,) = e["args"].keys()
        assert e["name"].startswith(f"{field} [serve/r0]")
    assert export_main([str(run_dir), "--check", "--min-counter-tracks", "5"]) == 0
    assert export_main([str(run_dir), "--check", "--min-counter-tracks", "6"]) == 1


def test_trace_export_counter_gate_fails_without_mem_samples(tmp_path):
    from tools.trace_export import main as export_main

    run_dir = tmp_path / "run"
    timeline.configure(str(run_dir))
    timeline.configure(None)  # the header alone
    assert export_main([str(run_dir), "--check"]) == 0
    assert export_main([str(run_dir), "--check", "--min-counter-tracks", "1"]) == 1


# ------------------------------------------------ the bench's wiring


def test_bench_serve_smoke_writes_mem_and_goodput_beside_serve_json(tmp_path, capsys):
    """``bench --serve --smoke --device cpu --obs-dir D``: telemetry.mem and
    telemetry.goodput on, ``mem.json`` and ``goodput.json`` beside
    ``serve.json``, and the ledger's rows through ``mem_report --check`` and
    ``goodput_report --check`` unedited."""
    from ddl25spring_tpu_torch import bench, obs
    from tools import goodput_report, mem_report

    d, led = tmp_path / "obs", str(tmp_path / "l.jsonl")
    held = torch.empty(8 << 20)  # 32 MiB the process holds before the bench: under its floor
    prev = obs.get_recorder()
    try:
        with obs.scoped(False):  # --obs-dir turns telemetry on for the run
            rec = bench.main(["--serve", "--smoke", "--device", "cpu", "--obs-dir", str(d),
                              "--perf-ledger", led, "--serve-duration", "0.5", "--serve-rate", "20",
                              "--no-serve-prefix-ab"])
    finally:
        obs.set_recorder(prev)
        obs.timeline.configure(None)
    tel = rec["telemetry"]
    band = tel["mem"]["budget"]
    assert tel["mem"]["enabled"] is True and band["within_band"]
    assert band["floor_bytes"] >= held.nbytes > band["measured_peak_bytes"] > 0
    serve = tel["serve"]
    assert band["budget_bytes"] == serve["param_bytes_per_chip"] + serve["pool_bytes_per_chip"]
    assert band["blas_workspaces"] == 0 and band["ratio_on_bill"] == band["ratio"]
    assert tel["mem"]["leaked_pages"] == 0 and tel["mem"]["samples"] > 0
    assert tel["goodput"]["scope"] == "serve" and tel["goodput"]["slo_attainment"] is not None
    for name in ("serve.json", "mem.json", "goodput.json"):
        assert (d / name).exists(), name
    rows = [json.loads(line)["record"] for line in open(led)]
    assert rows == ["serve", "mem", "goodput"]
    assert mem_report.main(["--run", str(d), "--check"]) == 0
    assert mem_report.main(["--ledger", led, "--check"]) == 0
    assert goodput_report.main(["--ledger", led, "--check"]) == 0
    capsys.readouterr()
