"""The port's run timeline (``ddl25spring_tpu_torch/obs/timeline.py``) against
the JAX package's, on the CPU: the twins of the cases of
``tests/test_timeline.py`` that do not need the serving engine.

- the event table is the JAX package's, serve kinds included, so both
  packages write one file format; every kind round-trips strict JSON
  through ``timeline.jsonl`` with its required fields and a monotone
  ``seq``;
- ``emit`` is a no-op when telemetry is off and refuses unknown kinds and
  missing fields when on; a NaN payload stays strict JSON;
- the flight tap mirrors only the narrating kinds, a sentinel violation
  among them;
- ``tools/trace_export.py`` merges a run directory the port wrote
  (``timeline.jsonl``, the spans' ``trace.json``, ``flight.json``) and its
  ``--check`` passes, and fails on an admitted request without a terminal.
"""

from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch import obs  # noqa: E402
from ddl25spring_tpu_torch.obs import sentinels, state  # noqa: E402
from ddl25spring_tpu_torch.obs.recorder import flight  # noqa: E402
from ddl25spring_tpu_torch.obs.timeline import (  # noqa: E402
    EVENT_KINDS,
    MIRRORED_FLIGHT_KINDS,
    read_timeline,
    timeline,
)


@pytest.fixture()
def tl(tmp_path):
    """The module-singleton timeline, configured at a fresh dir and handed
    back reset afterwards (other tests share the singleton)."""
    flight.reset()
    timeline.configure(str(tmp_path))
    try:
        yield timeline
    finally:
        timeline.configure(None)
        flight.reset()
        sentinels.reset()


def _fill(fields):
    return {f: ("device_loss" if f == "reason" else 1) for f in fields}


def test_event_table_is_the_jax_packages():
    from ddl25spring_tpu.obs.timeline import EVENT_KINDS as JAX_KINDS
    from ddl25spring_tpu.obs.timeline import MIRRORED_FLIGHT_KINDS as JAX_MIRRORED
    from ddl25spring_tpu.obs.timeline import TIMELINE_BASENAME

    from ddl25spring_tpu_torch.obs.timeline import TIMELINE_BASENAME as mine

    assert EVENT_KINDS == JAX_KINDS and MIRRORED_FLIGHT_KINDS == JAX_MIRRORED
    assert mine == TIMELINE_BASENAME


def test_every_event_kind_round_trips_strict_json(tl, tmp_path):
    with state.scoped(True):
        for kind, req in EVENT_KINDS.items():
            tl.emit(kind, vt=0.5, engine="t", replica=0, **_fill(req))
        tl.flush()
    header, events = read_timeline(str(tmp_path))
    assert header["time_origin_unix_s"] > 0 and header["capacity"] == tl._ring.maxlen
    assert len(events) == len(EVENT_KINDS)
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    by_kind = {e["kind"]: e for e in events}
    for kind, req in EVENT_KINDS.items():
        e = by_kind[kind]
        assert all(f in e for f in req)
        assert e["record"] == "event" and isinstance(e["t_wall_s"], float)
        assert e["vt_s"] == 0.5 and e["engine"] == "t" and e["replica"] == 0
    assert tl.counts() == {k: 1 for k in EVENT_KINDS}


def test_the_jax_reader_reads_the_ports_file(tl, tmp_path):
    from ddl25spring_tpu.obs.timeline import read_timeline as jread

    with state.scoped(True):
        tl.emit("serve_submit", rid=3, prompt_len=4, max_new=2)
        tl.flush()
    assert jread(str(tmp_path)) == read_timeline(str(tmp_path))


def test_emit_is_gated_and_typed(tl):
    assert state.enabled() is False
    assert tl.emit("serve_submit", rid=1) is None
    assert tl.emit("no_such_kind") is None
    assert tl.events() == []
    with state.scoped(True):
        with pytest.raises(ValueError, match="unknown timeline event"):
            tl.emit("no_such_kind")
        with pytest.raises(ValueError, match="missing required"):
            tl.emit("serve_submit", rid=1)


def test_non_finite_payloads_stay_strict_json(tl, tmp_path):
    with state.scoped(True):
        tl.emit("serve_submit", rid=1, prompt_len=4, max_new=float("nan"))
        tl.flush()
    _, events = read_timeline(str(tmp_path))
    assert events[0]["max_new"] == "nan"


def test_flight_tap_mirrors_only_narrating_kinds(tl):
    with state.scoped(True):
        flight.record(kind="chaos", fault="device_loss", step=2)
        flight.record(kind="serve_tick", step=3)
        flight.record(kind="step", step=4)
    mirrored = tl.events("chaos")
    assert len(mirrored) == 1 and mirrored[0]["fault"] == "device_loss"
    assert "flight_seq" in mirrored[0]
    assert tl.events("serve_tick") == [] and tl.events("step") == []
    flight.record(kind="chaos", fault="bit_flip", step=4)  # disabled: no mirror
    assert len(tl.events("chaos")) == 1


def test_a_sentinel_violation_reaches_the_timeline(tl):
    from ddl25spring_tpu_torch.parallel.dp import TinyMlp, make_train_step, tiny_mlp_loss

    model = TinyMlp()
    with sentinels.scoped(True, policy="log"):
        step = make_train_step(model, tiny_mlp_loss, torch.optim.SGD(model.parameters(), 0.1))
    x = torch.ones(4, 16)
    x[0, 0] = float("nan")
    with state.scoped(True):
        step((x, torch.zeros(4, 4)))
    (v,) = tl.events("violation")
    assert v["strategy"] == "serial" and v["step"] == 0
    assert v["violating_metric"] == "grads['b1']"


def test_configure_hooks_the_flush_into_the_flight_shutdown_chain(tl):
    assert flight._shutdown_hooks.get("timeline") == tl.flush
    assert tl.snapshot()["path"].endswith("timeline.jsonl")


def _run_dir(path):
    """A run directory as the port writes it: timeline, spans, flight."""
    timeline.configure(str(path), meta={"lineage_id": "t"})
    rec = obs.SpanRecorder()
    with state.scoped(True):
        with rec.span("train.step", step=0):
            flight.record(kind="step", strategy="serial", step=0, loss=1.0)
        flight.record(kind="violation", strategy="serial", step=1, violating_metric="loss")
        timeline.flush()
    rec.save(str(path / "trace.json"))
    flight.dump(path=str(path / "flight.json"), reason="end_of_run")
    timeline.configure(None)


def test_trace_export_merges_a_port_run_and_checks(tl, tmp_path):
    from tools.trace_export import main as export_main

    run = tmp_path / "run"
    run.mkdir()
    _run_dir(run)
    assert export_main([str(run), "--check"]) == 0
    merged = json.load(open(run / "trace_merged.json"))
    names = {e.get("name") for e in merged["traceEvents"]}
    assert "train.step" in names and any("violation" in str(n) for n in names)


def test_trace_export_check_fails_on_orphan_admit(tl, tmp_path):
    from tools.trace_export import main as export_main

    run = tmp_path / "orphan"
    timeline.configure(str(run))
    with state.scoped(True):
        timeline.emit("serve_submit", rid=1, prompt_len=4, max_new=4, engine="serve",
                      replica=0)
        timeline.emit("serve_admit", rid=1, slot=0, engine="serve", replica=0)
        timeline.flush()
    timeline.configure(None)
    assert export_main([str(run), "--check"]) == 1
    assert export_main([str(run)]) == 0
