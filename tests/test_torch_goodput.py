"""The port's goodput observatory (``ddl25spring_tpu_torch/obs/goodput.py``,
its serving and bench wiring, and the stdlib gates ``tools/goodput_report.py``,
``tools/trace_export.py`` and the report's ``--check-health``): the twins of
``tests/test_goodput.py`` that pass at the reference, on the CPU, and parity
with the JAX package's module on the same inputs.

- **decomposition sums to wall**: every bucket, the ``other`` residual
  included, sums to the wall within ``SUM_TOLERANCE``; only over-attribution
  fails.
- **replayed steps are the durable gap**: only resumable dispatches on it
  bill ``replayed_steps``.
- **SLO attainment on the engine's clock**: a seeded drain on the virtual
  clock attains deterministically; an impossible SLO flips every request
  without touching the streams.
- **the gates** trip on a seeded violation and pass the near miss.
- **zero cost when off**: metered ``timed_run`` losses and obs-off serving
  streams are bitwise the unmetered ones.
- **parity**: JAX's ``GoodputMeter`` on a fake clock, ``serve_goodput_cell``,
  ``merge_lineage`` and ``ledger_row`` give the port's dicts, apart from the
  host, sha and wall-clock keys.

Not twinned here (the JAX retry driver, ROADMAP A10b):
``test_sigterm_lineage_goodput_end_to_end``.
"""

from __future__ import annotations

import json
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models.llama import Llama  # noqa: E402
from ddl25spring_tpu_torch.obs import goodput as gp  # noqa: E402
from ddl25spring_tpu_torch.obs import state  # noqa: E402
from ddl25spring_tpu_torch.serve import driver  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import ServeEngine  # noqa: E402

CFG = driver.serve_model("tiny")


@pytest.fixture(scope="module")
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


# ------------------------------------------------------------- meter


def meter(**kw):
    kw.setdefault("t0_perf", 0.0)
    return gp.GoodputMeter("lintest000001", **kw)


def test_decomposition_sums_to_wall_with_other_residual():
    m = meter()
    m.add("warmup_compile", 0.0, 1.0)
    m.note_step(0, 1.0, 2.0)
    m.note_step(1, 2.0, 3.0)
    m.add("checkpoint_save", 3.0, 3.5)
    doc = m.finalize(total_wall_s=5.0)
    s = doc["seconds"]
    assert s["warmup_compile"] == 1.0
    assert s["useful_step"] == 2.0
    assert s["checkpoint_save"] == 0.5
    assert s["other"] == pytest.approx(1.5)  # the residual, reported
    assert sum(s.values()) == pytest.approx(doc["total_wall_s"])
    assert doc["sum_check"]["ok"] is True
    assert doc["fraction_useful"] == pytest.approx(2.0 / 5.0)
    assert set(s) == set(gp.BUCKETS)


def test_overbilled_meter_fails_the_sum_contract():
    m = meter()
    m.add("useful_step", 0.0, 10.0)
    doc = m.finalize(total_wall_s=5.0)
    assert doc["sum_check"]["ok"] is False
    assert doc["overrun_s"] == pytest.approx(5.0)
    # the near-miss: within tolerance stays ok
    m2 = meter()
    m2.add("useful_step", 0.0, 5.0 * (1 + gp.SUM_TOLERANCE) - 1e-4)
    assert m2.finalize(total_wall_s=5.0)["sum_check"]["ok"] is True


def test_unknown_bucket_refused():
    m = meter()
    with pytest.raises(ValueError):
        m.add("coffee_break", 0.0, 1.0)
    with pytest.raises(ValueError):
        m.add_seconds("coffee_break", 1.0)


def test_replay_window_prices_only_resumable_durable_gap_steps():
    m = meter()
    m.set_replay_window(4, 5)  # durable gap: steps 4..5 re-run
    for i in range(4, 8):
        m.note_step(i, float(i), float(i) + 1.0)
    # a secondary phase restarts its own count — indices 4..5 collide
    # numerically but are NOT on the resume axis
    for i in range(4, 6):
        m.note_step(i, 10.0 + i, 11.0 + i, resumable=False)
    doc = m.finalize(total_wall_s=20.0)
    assert doc["replayed_steps_count"] == 2  # == the manifest gap
    assert doc["seconds"]["replayed_steps"] == pytest.approx(2.0)
    assert doc["seconds"]["useful_step"] == pytest.approx(4.0)
    assert doc["steps"] == {"replayed_steps": 2, "useful_step": 4}


def test_stall_seconds_accumulate_without_windows():
    m = meter()
    m.add_seconds("stall", 0.75)
    doc = m.finalize(total_wall_s=2.0)
    assert doc["seconds"]["stall"] == 0.75
    assert all(w["bucket"] != "stall" for w in doc["windows"])


def test_window_cap_truncates_windows_but_not_seconds():
    m = meter()
    n = gp.MAX_WINDOWS + 7
    for i in range(n):
        m.add("useful_step", float(i), float(i) + 0.5)
    doc = m.finalize(total_wall_s=float(n))
    assert doc["seconds"]["useful_step"] == pytest.approx(0.5 * n)
    assert doc["windows_truncated"] == 7
    assert doc["sum_check"]["ok"] is True


def test_touching_same_bucket_windows_coalesce():
    m = meter()
    for i in range(5):
        m.note_step(i, float(i), float(i) + 1.0)
    m.add("checkpoint_save", 5.0, 5.2)
    doc = m.finalize(total_wall_s=6.0)
    useful = [w for w in doc["windows"] if w["bucket"] == "useful_step"]
    assert len(useful) == 1 and useful[0]["n"] == 5
    assert useful[0]["t0_s"] == 0.0 and useful[0]["t1_s"] == 5.0


# ---------------------------------------------------- lineage merge


def _flight_doc():
    return {
        "records": [
            {"kind": "step", "step": s, "wall_s": 1.0,
             "resumable": True}
            for s in range(6)
        ] + [
            # a secondary phase's record: no resumable marker, never
            # priced into the lineage
            {"kind": "step", "step": 0, "wall_s": 99.0},
        ]
    }


def test_failed_attempt_facts_split_on_the_durable_step():
    facts = gp.failed_attempt_facts(_flight_doc(), durable_step=3)
    assert facts["useful_steps"] == 4 and facts["lost_steps"] == 2
    assert facts["useful_wall_s"] == pytest.approx(4.0)
    assert facts["lost_wall_s"] == pytest.approx(2.0)
    # no durable checkpoint: the whole attempt is the lost tail
    none = gp.failed_attempt_facts(_flight_doc(), durable_step=None)
    assert none["useful_steps"] == 0 and none["lost_steps"] == 6


def test_merge_lineage_folds_attempts_onto_one_axis():
    final = meter()
    final.attempt = 2
    final.note_step(4, 0.0, 2.0)
    fdoc = final.finalize(
        total_wall_s=4.0, strategy="dp", mesh={"data": 2})
    failure = {
        "attempt": 1, "reason": "preempted", "wall_s": 10.0,
        "backoff_s": 1.0,
        "goodput": {"useful_wall_s": 4.0, "lost_wall_s": 2.0,
                    "useful_steps": 4, "lost_steps": 2,
                    "durable_step": 3},
    }
    doc = gp.merge_lineage(fdoc, [failure], lineage_id="lintest000001")
    assert doc["scope"] == "train_lineage"
    assert doc["attempts"] == 2
    assert doc["strategy"] == "dp" and doc["mesh"] == {"data": 2}
    s = doc["seconds"]
    # dead attempt: 4 s vouched useful, 2 s lost tail + 1 s backoff as
    # recovery, 4 s unattributed setup as other; final: 2 s useful + 2
    # s residual other on its own axis
    assert s["useful_step"] == pytest.approx(6.0)
    assert s["recovery"] == pytest.approx(3.0)
    assert s["other"] == pytest.approx(6.0)
    assert doc["total_wall_s"] == pytest.approx(15.0)
    assert doc["sum_check"]["ok"] is True
    # the final attempt's windows shifted past the dead attempt's span
    shifted = [w for w in doc["windows"] if w.get("step") == 4]
    assert shifted and shifted[0]["t0_s"] == pytest.approx(11.0)
    outcomes = [a["outcome"] for a in doc["attempts_detail"]]
    assert outcomes == ["failed", "succeeded"]


def test_merge_lineage_nothing_to_merge_is_none():
    assert gp.merge_lineage(None, []) is None


# -------------------------------------------------- serving goodput


def test_serve_slo_reads_the_env_boundary(monkeypatch):
    monkeypatch.setenv(gp.ENV_SLO_TTFT_MS, "123.5")
    monkeypatch.setenv(gp.ENV_SLO_TOK_MS, "7.25")
    assert gp.serve_slo() == {"ttft_ms": 123.5, "tok_ms": 7.25}
    monkeypatch.delenv(gp.ENV_SLO_TTFT_MS)
    monkeypatch.delenv(gp.ENV_SLO_TOK_MS)
    assert gp.serve_slo() == {
        "ttft_ms": gp.DEFAULT_SLO_TTFT_MS,
        "tok_ms": gp.DEFAULT_SLO_TOK_MS,
    }


def test_serve_goodput_cell_judges_each_request():
    slo = {"ttft_ms": 1000.0, "tok_ms": 100.0}
    done = [
        # compliant: ttft 0.5 s, per-token (1.0-0.5)/(6-1)=0.1 s
        {"arrival_t": 0.0, "first_token_t": 0.5, "done_t": 1.0,
         "tokens": [1] * 6},
        # TTFT miss
        {"arrival_t": 0.0, "first_token_t": 2.0, "done_t": 2.1,
         "tokens": [1] * 3},
        # per-token miss
        {"arrival_t": 0.0, "first_token_t": 0.1, "done_t": 3.0,
         "tokens": [1] * 3},
    ]
    cell = gp.serve_goodput_cell(
        done, clock="virtual", wall_s=2.0, n_chips=2, offered=10,
        rejected=2, completed=3, dropped=1, drain_demand=1, slo=slo,
    )
    assert cell["requests_evaluated"] == 3
    assert cell["slo_compliant"] == 1
    assert cell["slo_attainment"] == pytest.approx(1 / 3)
    assert cell["ttft_misses"] == 1 and cell["tok_latency_misses"] == 1
    assert cell["completed_tokens"] == 12
    assert cell["slo_compliant_tokens"] == 6
    # SLO-compliant tokens only, per second per chip
    assert cell["goodput_tokens_per_sec_per_chip"] == pytest.approx(
        6 / 2.0 / 2)
    # availability = 1 - (rejects + drops + drain demand) / offered
    assert cell["availability"] == pytest.approx(1 - 4 / 10)
    assert cell["slo"]["clock"] == "virtual"
    # nothing offered -> availability undefined, not 1.0
    empty = gp.serve_goodput_cell([], clock="wall", wall_s=None)
    assert empty["availability"] is None
    assert empty["slo_attainment"] is None
    assert empty["goodput_tokens_per_sec_per_chip"] is None


def test_seeded_virtual_clock_drain_attains_the_slo(params, monkeypatch):
    """A seeded shared-profile-shaped drain on the virtual clock: SLO
    attainment is deterministic (1.0 under the smoke defaults, 0.0
    under an impossible env-boundary SLO) and re-judging never touches
    the token streams."""
    eng = make_engine(params, prefill_batch=2)
    with state.scoped(False):
        reqs = [eng.make_request([5 + i, 9, 11, 3], 6) for i in range(4)]
        for r in reqs:
            assert eng.submit(r) is None
        drain(eng)
    tokens_before = [list(r.tokens) for r in reqs]
    cell = gp.serve_goodput_cell(
        eng.done, clock=eng.clock, wall_s=eng.now(), offered=4,
        completed=4, slo={"ttft_ms": 1e6, "tok_ms": 1e6},
    )
    assert cell["requests_evaluated"] == 4
    assert cell["slo_attainment"] == 1.0
    assert cell["availability"] == 1.0
    monkeypatch.setenv(gp.ENV_SLO_TTFT_MS, "0")
    monkeypatch.setenv(gp.ENV_SLO_TOK_MS, "0")
    strict = gp.serve_goodput_cell(
        eng.done, clock=eng.clock, wall_s=eng.now(), offered=4,
        completed=4,
    )
    assert strict["slo_attainment"] == 0.0
    assert strict["slo_compliant_tokens"] == 0
    assert [list(r.tokens) for r in reqs] == tokens_before


# --------------------------------------------- artifacts + ledger row


def test_goodput_json_round_trips(tmp_path):
    m = meter()
    m.note_step(0, 0.0, 1.0)
    doc = m.finalize(total_wall_s=2.0)
    path = gp.write_run_goodput(doc, str(tmp_path))
    assert os.path.basename(path) == gp.GOODPUT_BASENAME
    assert gp.read_run_goodput(str(tmp_path)) == json.loads(
        json.dumps(doc))
    assert gp.read_run_goodput(str(tmp_path / "nope")) is None


def test_goodput_cell_summarizes_without_windows():
    m = meter()
    m.note_step(0, 0.0, 1.0)
    cell = gp.goodput_cell(m.finalize(total_wall_s=2.0))
    assert "windows" not in cell
    assert cell["scope"] == "train_attempt"
    assert cell["sum_check"]["ok"] is True
    assert gp.goodput_cell(None) == {"enabled": False}


def test_ledger_row_keys_on_strategy_mesh_scope_not_lineage():
    m = meter()
    doc = m.finalize(total_wall_s=1.0)
    row = gp.ledger_row(doc, strategy="dp", mesh={"data": 2},
                        host="h/2cpu/cpu")
    assert row["record"] == "goodput"
    assert row["key"] == {"strategy": "dp", "mesh": {"data": 2},
                          "scope": "train_attempt"}
    assert "lineage_id" not in row["key"]  # identity, never the key
    assert row["lineage_id"] == "lintest000001"
    # serve rows carry the SLO cells, train rows don't
    assert "slo_attainment" not in row


# -------------------------------- goodput_report falsification matrix


def _trend_rows(led_path, fractions, scope="train_attempt", **serve):
    """A ledger of synthetic goodput rows sharing one trend key."""
    rows = []
    for i, f in enumerate(fractions):
        m = meter()
        m.note_step(0, 0.0, f * 10.0)
        doc = m.finalize(total_wall_s=10.0, scope=scope)
        doc["lineage_id"] = f"lin{i:09d}abc"  # unique per lineage
        if serve:
            doc.update(serve)
        row = gp.ledger_row(doc, strategy="dp", mesh={"data": 2},
                            host="h/2cpu/cpu")
        row["ts"] = 1_700_000_000 + i
        rows.append(row)
    with open(led_path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return rows


def test_goodput_report_check_bands_fraction_useful(tmp_path, capsys):
    import tools.goodput_report as goodput_report

    led = str(tmp_path / "ledger.jsonl")
    # near-miss passes: latest 0.70 vs median-0.80 baseline is inside
    # the default 0.35 band
    _trend_rows(led, [0.8, 0.8, 0.8, 0.7])
    assert goodput_report.main(["--ledger", led, "--check"]) == 0
    # seeded violation trips: latest craters to 0.2
    _trend_rows(led, [0.8, 0.8, 0.8, 0.2])
    assert goodput_report.main(["--ledger", led, "--check"]) == 1
    out = capsys.readouterr()
    assert "fraction_useful" in out.err
    # a single record is a note, not a failure (no baseline yet)
    _trend_rows(led, [0.8])
    assert goodput_report.main(["--ledger", led, "--check"]) == 0
    # an empty ledger is its own exit code
    open(led, "w").close()
    assert goodput_report.main(["--ledger", led, "--check"]) == 2


def test_goodput_report_check_fails_broken_sum_contract(tmp_path):
    import tools.goodput_report as goodput_report

    led = str(tmp_path / "ledger.jsonl")
    _trend_rows(led, [0.8, 0.8])
    # corrupt the latest row's sum_check in place
    rows = [json.loads(ln) for ln in open(led)]
    rows[-1]["sum_check"]["ok"] = False
    with open(led, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    assert goodput_report.main(["--ledger", led, "--check"]) == 1


def test_goodput_report_slo_floor(tmp_path, capsys):
    import tools.goodput_report as goodput_report

    led = str(tmp_path / "ledger.jsonl")
    _trend_rows(led, [0.8, 0.8], scope="serve", slo_attainment=0.95,
                availability=1.0)
    assert goodput_report.main(
        ["--ledger", led, "--check", "--slo-floor", "0.9"]) == 0
    assert goodput_report.main(
        ["--ledger", led, "--check", "--slo-floor", "0.99"]) == 1
    # an engine that finished zero requests did not attain its SLO
    _trend_rows(led, [0.8], scope="serve", slo_attainment=None)
    assert goodput_report.main(
        ["--ledger", led, "--check", "--slo-floor", "0.5"]) == 1


def test_goodput_report_check_elastic_is_strict(tmp_path):
    import tools.goodput_report as goodput_report

    def write_doc(name, fraction):
        m = meter()
        m.note_step(0, 0.0, fraction * 10.0)
        d = str(tmp_path / name)
        gp.write_run_goodput(m.finalize(total_wall_s=10.0), d)
        return d

    el, rl = write_doc("elastic", 0.6), write_doc("relaunch", 0.5)
    assert goodput_report.main(["--check-elastic", el, rl]) == 0
    # a tie is NOT strictly higher — elastic must beat relaunch
    tie = write_doc("tie", 0.5)
    assert goodput_report.main(["--check-elastic", tie, rl]) == 1
    assert goodput_report.main(["--check-elastic", rl, el]) == 1
    assert goodput_report.main(
        ["--check-elastic", str(tmp_path / "missing"), rl]) == 2


def test_goodput_report_run_view_checks_the_artifact(tmp_path):
    import tools.goodput_report as goodput_report

    m = meter()
    m.add("useful_step", 0.0, 30.0)  # over-billed vs 10 s wall
    gp.write_run_goodput(m.finalize(total_wall_s=10.0), str(tmp_path))
    assert goodput_report.main(
        ["--run", str(tmp_path), "--check"]) == 1
    m2 = meter()
    m2.add("useful_step", 0.0, 8.0)
    gp.write_run_goodput(m2.finalize(total_wall_s=10.0), str(tmp_path))
    assert goodput_report.main(
        ["--run", str(tmp_path), "--check"]) == 0


# ------------------------------------ trace_export goodput gate


def _export_dir(tmp_path, doc):
    from ddl25spring_tpu_torch.obs.timeline import timeline

    d = tmp_path / "run"
    timeline.configure(str(d))
    timeline.configure(None)  # header flushed; exporter needs only it
    gp.write_run_goodput(doc, str(d))
    return str(d)


def test_trace_export_renders_goodput_windows(tmp_path):
    import tools.trace_export as trace_export

    m = meter()
    m.add("warmup_compile", 0.0, 1.0)
    m.note_step(0, 1.0, 2.0)
    d = _export_dir(tmp_path, m.finalize(total_wall_s=3.0))
    assert trace_export.main([d, "--check"]) == 0
    merged = json.load(open(os.path.join(d, "trace_merged.json")))
    gp_evs = [e for e in merged["traceEvents"]
              if e.get("pid") == trace_export.PID_GOODPUT
              and e.get("ph") == "X"]
    assert {e["name"] for e in gp_evs} == {"warmup_compile",
                                           "useful_step"}


def test_trace_export_check_refuses_overlap_and_overrun(tmp_path):
    import tools.trace_export as trace_export

    # overlapping windows double-bill the interval
    m = meter()
    m.add("useful_step", 0.0, 2.0)
    m.add("warmup_compile", 1.0, 3.0)
    doc = m.finalize(total_wall_s=4.0)
    assert trace_export.check_goodput(doc)
    d = _export_dir(tmp_path, doc)
    assert trace_export.main([d, "--check"]) == 1
    # a window past total wall
    m2 = meter()
    m2.add("useful_step", 0.0, 9.0)
    doc2 = m2.finalize(total_wall_s=5.0)
    assert any("runs past total wall" in f
               for f in trace_export.check_goodput(doc2))
    # the clean near-miss: touching windows are not an overlap
    m3 = meter()
    m3.add("useful_step", 0.0, 2.0)
    m3.add("warmup_compile", 2.0, 3.0)
    assert trace_export.check_goodput(
        m3.finalize(total_wall_s=4.0)) == []


def test_obs_report_exit_5_on_goodput_violation(tmp_path):
    from ddl25spring_tpu_torch.obs import report as obs_report

    run = tmp_path / "run"
    run.mkdir()
    with open(run / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"record": "header", "layout": "dp"}) + "\n")
    m = meter()
    m.add("useful_step", 0.0, 30.0)  # breaks the sum contract
    gp.write_run_goodput(m.finalize(total_wall_s=10.0), str(run))
    assert obs_report.main([str(run), "--check-health"]) == 5
    # healthy decomposition passes the same gate
    m2 = meter()
    m2.add("useful_step", 0.0, 8.0)
    gp.write_run_goodput(m2.finalize(total_wall_s=10.0), str(run))
    assert obs_report.main([str(run), "--check-health"]) == 0
    # serve SLO floor: exit 5 again
    m3 = meter()
    doc3 = m3.finalize(total_wall_s=1.0, scope="serve")
    doc3["slo_attainment"] = 0.4
    gp.write_run_goodput(doc3, str(run))
    assert obs_report.main(
        [str(run), "--check-health", "--slo-floor", "0.9"]) == 5


# ------------------------------------------------- zero cost when off


def test_metered_timed_run_is_bitwise_identical():
    from ddl25spring_tpu_torch.benchmarks import timed_run

    def run(meter_):
        params = torch.ones(4)

        def step(batch):
            params.sub_(1e-3 * batch.sum() * params)
            return (params * params).sum()

        feed = lambda: torch.ones(2)  # noqa: E731
        dt, losses, _ = timed_run(step, feed, 3, 1, goodput=meter_)
        return params, losses

    base = run(None)
    m = meter()
    metered = run(m)
    assert torch.equal(base[0], metered[0]) and base[1] == metered[1]
    # and the meter measured the run it rode along with
    assert m.seconds["useful_step"] > 0
    assert m.seconds["warmup_compile"] > 0


def test_disabled_obs_serve_tokens_identical_and_cell_matches(params):
    """DDL25_OBS=0: token streams are bitwise identical to an
    instrumented run, so the goodput cell computed post-hoc from the
    virtual clock matches field-for-field (modulo nothing)."""

    def run(on):
        eng = make_engine(params, prefill_batch=2)
        with state.scoped(on):
            reqs = [eng.make_request([5 + i, 9, 11, 3], 6)
                    for i in range(3)]
            for r in reqs:
                assert eng.submit(r) is None
            drain(eng)
        cell = gp.serve_goodput_cell(
            eng.done, clock=eng.clock, wall_s=eng.now(), offered=3,
            completed=3, slo={"ttft_ms": 1e6, "tok_ms": 1e6},
        )
        return [list(r.tokens) for r in reqs], cell

    off_tokens, off_cell = run(False)
    on_tokens, on_cell = run(True)
    assert on_tokens == off_tokens
    assert on_cell == off_cell


# --------------------------------------------------- parity with JAX


def _both():
    from ddl25spring_tpu.obs import goodput as jgp

    return gp, jgp


WALL_KEYS = ("time_origin_unix_s", "ts", "host", "git_sha")


def _strip(d):
    return {k: v for k, v in d.items() if k not in WALL_KEYS}


def _metered(mod):
    """The same windows on both meters' fake clocks."""
    m = mod.GoodputMeter("lintest000001", 2, t0_perf=0.0, chips=2)
    m.set_replay_window(3, 4)
    m.add("warmup_compile", 0.0, 1.0, label="hbm")
    for i in range(2, 7):
        m.note_step(i, 1.0 + i, 2.0 + i, resumable=True)
    m.note_step(3, 9.0, 9.5, resumable=False)
    m.add("checkpoint_save", 9.5, 9.75)
    m.add_seconds("stall", 0.3)
    return m.finalize(total_wall_s=12.0, strategy="dp", mesh={"data": 2})


def test_meter_doc_is_the_jax_meters():
    port, jax_mod = _both()
    assert _strip(_metered(port)) == _strip(_metered(jax_mod))
    assert port.BUCKETS == jax_mod.BUCKETS and port.SUM_TOLERANCE == jax_mod.SUM_TOLERANCE


def test_serve_goodput_cell_is_the_jax_cell(params):
    port, jax_mod = _both()
    eng = make_engine(params, prefill_batch=2)
    with state.scoped(False):
        for i in range(4):
            assert eng.submit(eng.make_request([5 + i, 9, 11, 3], 6)) is None
        drain(eng)
    done = [{"arrival_t": 0.0, "first_token_t": 0.5, "done_t": 1.0, "tokens": [1] * 6},
            {"arrival_t": 0.0, "first_token_t": 2.0, "done_t": 2.1, "tokens": [1] * 3}]
    for reqs, kw in ((eng.done, {"slo": {"ttft_ms": 60.0, "tok_ms": 1e6}}),
                     (done, {"slo": {"ttft_ms": 1000.0, "tok_ms": 100.0}, "dropped": 1,
                             "drain_demand": 1, "rejected": 2})):
        args = dict(clock="virtual", wall_s=2.0, n_chips=2, offered=10, completed=2, **kw)
        assert port.serve_goodput_cell(reqs, **args) == jax_mod.serve_goodput_cell(reqs, **args)


def test_merge_lineage_and_ledger_row_are_the_jax_ones():
    port, jax_mod = _both()
    failure = {"attempt": 1, "reason": "preempted", "wall_s": 10.0, "backoff_s": 1.0,
               "goodput": {"useful_wall_s": 4.0, "lost_wall_s": 2.0, "useful_steps": 4,
                           "lost_steps": 2, "durable_step": 3}}
    merged = [m.merge_lineage(_metered(m), [failure], lineage_id="lintest000001")
              for m in (port, jax_mod)]
    assert _strip(merged[0]) == _strip(merged[1])
    rows = [m.ledger_row(_metered(m), strategy="dp", mesh={"data": 2}, host="h/2cpu/cpu",
                         git_sha="abc", extra_key={"profile": "ramp"}) for m in (port, jax_mod)]
    assert _strip(rows[0]) == _strip(rows[1])
    flight = {"records": [{"kind": "step", "step": s, "wall_s": 1.0, "resumable": True}
                          for s in range(6)]}
    assert (port.failed_attempt_facts(flight, 3) == jax_mod.failed_attempt_facts(flight, 3))
