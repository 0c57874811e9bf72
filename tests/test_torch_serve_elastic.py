"""The port's elastic serving (``serve/driver.elastic_serve_run``, the
engine's drain handoff and retirement) on the CPU: the twins of the serve
cases of the JAX package's ``tests/test_elastic.py``, and the run's cell
held to JAX's on the same trace and chaos.

The load-bearing pins:

- **zero drops, exact tokens**: a replica lost mid-traffic drains its live
  slots, its queue re-admits on the survivors (forced past a full queue),
  nothing accepted is lost and every stream is the dense one;
- **the JAX ``elastic_serve_run``**: events, replica counts, admission counts and
  per-request tokens equal JAX's ``elastic_serve_run`` exactly;
- **retirement gives the memory back**: a retired replica holds no pool and
  no captured program; on the CPU its step-down is recorded as absent.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.ft import ChaosInjector as JaxChaos  # noqa: E402
from ddl25spring_tpu.ft import parse_chaos as jax_parse  # noqa: E402
from ddl25spring_tpu.serve import driver as jdriver  # noqa: E402
from ddl25spring_tpu_torch import obs  # noqa: E402
from ddl25spring_tpu_torch.ft import ChaosInjector, parse_chaos  # noqa: E402
from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.obs import memscope  # noqa: E402
from ddl25spring_tpu_torch.serve import driver  # noqa: E402
from ddl25spring_tpu_torch.serve.driver import elastic_serve_run  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import REJECT_DRAINING, ServeEngine  # noqa: E402

CFG = driver.serve_model("tiny")
KNOBS = dict(page_len=4, n_pages=16, max_slots=2, prefill_batch=2, max_prompt_len=8,
             max_queue=32, token_budget=None, eos_id=None, prefix_cache=False, spec_k=0,
             draft_layers=1)
SPIKE = "traffic_spike@1:12,device_loss@8"
SPIKE_TRACE = [{"t": 0.001 * i, "prompt": [5, 9, 11, 3], "max_new": 6} for i in range(8)]


@pytest.fixture(scope="module")
def params():
    m = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return m.requires_grad_(False)


def dense(params, prompt, max_new):
    return dm.generate(params, torch.tensor([prompt], dtype=torch.int32), CFG,
                       max_new).numpy()[0].tolist()


def chaos(spec, tmp_path):
    return ChaosInjector(parse_chaos(spec), state_dir=tmp_path)


def test_scale_down_handoff_zero_drops_token_exact(params, tmp_path):
    """device_loss mid-traffic: the victim drains through the release
    discipline, its queue re-admits on the survivor, nothing accepted is
    lost, and every stream is the dense one."""
    a, b = ([5, 9, 11, 3], 9), ([7, 2, 8], 6)
    trace = [{"t": t, "prompt": p, "max_new": n}
             for t in (0.0, 0.001, 0.002) for p, n in (a, b)]
    cell = elastic_serve_run(params, CFG, trace, KNOBS, chaos=chaos("device_loss@2", tmp_path),
                             replicas=2, keep_requests=True)
    assert cell["dropped_requests"] == 0 and cell["submitted"] == 6
    assert cell["completed"] + cell["rejected"] == 6 and cell["completed"] >= 4
    (ev,) = cell["events"]
    assert (ev["reason"], ev["old"], ev["new"]) == ("device_loss", 2, 1)
    assert ev["t_end"] >= ev["t"] and cell["replicas_end"] == 1
    oracle = {tuple(p): dense(params, p, n) for p, n in (a, b)}
    for req in cell["_requests"]:
        assert req.tokens == oracle[tuple(req.prompt)], req.rid


def test_handoff_forces_past_full_survivor_queue(params, tmp_path):
    """The victim's queued (accepted) requests re-admit even when the
    survivor's queue sits at max_queue: the handoff seats them directly."""
    trace = ([{"t": 0.0, "prompt": [5, 9, 11, 3], "max_new": 6}] * 4
             + [{"t": 0.005, "prompt": [5, 9, 11, 3], "max_new": 6}] * 4)
    cell = elastic_serve_run(params, CFG, trace, dict(KNOBS, max_queue=2),
                             chaos=chaos("device_loss@3", tmp_path), replicas=2, tick_s=0.01)
    (ev,) = cell["events"]
    assert ev["requeued"] == 2, cell["events"]
    assert (cell["submitted"], cell["rejected"], cell["completed"]) == (8, 0, 8)
    assert cell["dropped_requests"] == 0


def test_traffic_spike_autoscales_and_windows_defined(params, tmp_path):
    """A spike drives the queue-depth autoscaler into a scale-up, the cell
    splits TTFT into window and steady, and --check-reshape passes it."""
    from tools.serve_report import check_reshape

    cell = elastic_serve_run(params, CFG, SPIKE_TRACE, KNOBS, chaos=chaos(SPIKE, tmp_path),
                             replicas=2, max_replicas=3)
    reasons = [e["reason"] for e in cell["events"]]
    assert "traffic_spike_scale_up" in reasons and "device_loss" in reasons, cell["events"]
    assert cell["dropped_requests"] == 0 and cell["reshape_window_requests"] >= 1
    assert cell["ttft_s_p95_reshape"] is not None
    assert check_reshape([{"reshape": cell}], ttft_factor=50.0) == []
    assert check_reshape([{"reshape": driver._reshape_cell(cell)}], ttft_factor=50.0) == []


def test_check_reshape_gate_refuses_bad_cells():
    from tools.serve_report import check_reshape

    good = driver._reshape_cell({
        "events": [{"reason": "device_loss", "old": 2, "new": 1, "t": 0.1, "t_end": 0.2}],
        "dropped_requests": 0, "admitted": 10, "completed": 10,
        "ttft_s_p95_steady": 0.1, "ttft_s_p95_reshape": 0.2,
        "reshape_window_requests": 3, "steady_requests": 7})
    assert check_reshape([{"reshape": good}]) == []
    assert check_reshape([{}])
    assert any("no events" in f for f in check_reshape([{"reshape": {**good, "events": []}}]))
    assert any("dropped_requests=2" in f for f in check_reshape(
        [{"reshape": {**good, "dropped_requests": 2, "completed": 8}}]))
    assert any("vacuous" in f for f in check_reshape(
        [{"reshape": {**good, "reshape_window_requests": 0}}]))
    assert any("exceeds" in f for f in check_reshape(
        [{"reshape": {**good, "ttft_s_p95_reshape": 0.5}}]))
    assert check_reshape([{"reshape": {**good, "ttft_s_p95_reshape": 0.5}}],
                         ttft_factor=10.0) == []


def test_engine_begin_drain_blocks_admission_hands_off_and_retires(params):
    """A draining engine admits nothing, returns its queued requests,
    reports drained once its live slots release, bounces direct submits,
    and once retired holds no pool and no captured program."""
    eng = ServeEngine(params, CFG, clock="virtual", **KNOBS)
    r1, r2, r3 = (eng.make_request(p, 3) for p in ([5, 9, 11, 3], [7, 2, 8], [7, 2, 8, 1]))
    for r in (r1, r2, r3):
        assert eng.submit(r) is None
    eng.step()  # admits r1 + r2 (prefill width 2)
    assert eng.admitted == 2
    assert [r.rid for r in eng.begin_drain()] == [r3.rid]
    assert not eng.drained
    steps = 0
    while not eng.drained:
        eng.step()
        steps += 1
        assert steps < 50
    assert eng.completed == 2 and eng.admitted == 2
    assert eng.submit(eng.make_request([5], 2)) == REJECT_DRAINING and eng.drained
    eng.retire()
    assert eng.pool is None and eng._tick.static is None and eng._tick.outs is None
    assert eng.completed == 2 and len(eng.done) == 2


def test_flight_record_and_recovery_report_carry_reshape(tmp_path):
    """A reshape flight record lands in the port's dump, and the JAX
    package's run summary reads it under recovery with the health gate
    green."""
    from ddl25spring_tpu.obs.report import summarize_run

    fr = obs.FlightRecorder()
    fr.configure(run_dir=str(tmp_path))
    fr.record(kind="reshape", scope="serve", reason="device_loss", old=2, new=1, wall_s=0.5,
              steps_lost=0)
    doc = json.loads(open(fr.dump(reason="end_of_run")).read())
    assert doc["counts"]["reshape"] == 1
    s = summarize_run(str(tmp_path))
    assert s["recovery"]["reshapes"] == 1
    assert s["recovery"]["last_reshape"]["reason"] == "device_loss"
    assert s["health"].get("violations", 0) == 0


# ------------------------------------------------- JAX's elastic_serve_run


@pytest.fixture(scope="module")
def jax_elastic_ref(params, tmp_path_factory):
    jp = jax.tree.map(jnp.asarray, llama.export_params(params))
    return jdriver.elastic_serve_run(
        jp, CFG, SPIKE_TRACE, KNOBS, replicas=2, max_replicas=3, keep_requests=True,
        chaos=JaxChaos(jax_parse(SPIKE), state_dir=tmp_path_factory.mktemp("jax_chaos")))


def test_elastic_cell_equals_jax(params, jax_elastic_ref, tmp_path):
    ref = jax_elastic_ref
    cell = elastic_serve_run(params, CFG, SPIKE_TRACE, KNOBS, chaos=chaos(SPIKE, tmp_path),
                             replicas=2, max_replicas=3, keep_requests=True)

    def events(c):
        return [{k: v for k, v in e.items() if k != "wall_s"} for e in c["events"]]

    assert events(cell) == events(ref) and len(cell["events"]) == 2
    for key in ("replicas_start", "replicas_end", "submitted", "admitted", "completed",
                "rejected", "dropped_requests", "generated_tokens", "iters", "wall_virtual_s",
                "ttft_s_p50_steady", "ttft_s_p95_steady", "ttft_s_p50_reshape",
                "ttft_s_p95_reshape", "reshape_window_requests", "steady_requests"):
        assert cell[key] == ref[key], key
    assert cell["dropped_requests"] == 0
    assert (sorted((r.rid, r.tokens) for r in cell["_requests"])
            == sorted((r.rid, [int(t) for t in r.tokens]) for r in ref["_requests"]))


def test_retired_replicas_record_their_step_down(params, tmp_path):
    """With memscope on, each retired replica leaves a ``mem_steps`` entry:
    leak-checked, its pool bytes, and the live bytes before and after its
    retirement (on the CPU a walk of the live tensors): the step-down frees
    at least its pools; the retired engine holds no device state."""
    with obs.scoped(True), memscope.scoped(True):
        cell = elastic_serve_run(params, CFG, SPIKE_TRACE, KNOBS, chaos=chaos(SPIKE, tmp_path),
                                 replicas=2, max_replicas=3, keep_requests=True)
    (step,) = cell["mem_steps"]
    assert step["reason"] == "device_loss" and step["leak_ok"] and step["pool_bytes"] > 0
    assert step["live_bytes_before"] - step["live_bytes_after"] == step["step_down_bytes"]
    assert step["step_down_bytes"] >= step["pool_bytes"]
    assert json.loads(json.dumps(driver._reshape_cell(cell)))


def test_bench_serve_arms_elastic_from_the_chaos_env(tmp_path, monkeypatch):
    """``DDL25_CHAOS=device_loss@k bench --serve``: the reshape cell in the
    record, the ledger row and serve.json, keyed apart as elastic; a spec
    engine skips it with a warning."""
    monkeypatch.setenv("DDL25_CHAOS", "device_loss@3")
    led = str(tmp_path / "l.jsonl")
    rec = driver.run_serve_bench(smoke=True, duration_s=1.0, rate_rps=12.0, skip_ab=True,
                                 skip_prefix_ab=True, device="cpu", obs_dir=str(tmp_path),
                                 ledger_path=led)
    assert rec["key"]["elastic"] is True
    cell = driver.serve_cell(rec)["reshape"]
    assert cell["dropped_requests"] == 0 and cell["events"][0]["reason"] == "device_loss"
    rows = [json.loads(line) for line in open(led).read().splitlines()]
    (row,) = [r for r in rows if r["record"] == "serve"]
    assert row["reshape"] == cell
    # the elastic run's SLO goodput, on its virtual clock, rides the doc
    el = rec["goodput"]["elastic"]
    assert el["slo"]["clock"] == "virtual" and el["drain_demand"] >= 0
    assert el["offered"] == cell["admitted"] + cell["rejected"]
    assert json.loads((tmp_path / "serve.json").read_text())["reshape"]["events"]
    monkeypatch.setenv("DDL25_SERVE_SPEC", "1")
    with pytest.warns(UserWarning, match="elastic serve reshaping skipped"):
        rec = driver.run_serve_bench(smoke=True, duration_s=0.5, rate_rps=12.0, skip_ab=True,
                                     skip_prefix_ab=True, skip_spec_ab=True, device="cpu",
                                     obs_dir=str(tmp_path / "spec"))
    assert "reshape" not in rec
