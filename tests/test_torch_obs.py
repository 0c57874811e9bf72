"""The port's telemetry core against the JAX package's, on the CPU (the twins
of ``tests/test_obs.py``): span JSON against the Chrome-trace schema and the
JAX recorder's events, JSONL round-trips, counters fed from the train steps
(copied off the card without a sync there, folded at once here), the
``torch.profiler`` trace with the spans in it, and the builders' statics.

One spawned gloo world of 2 ranks runs the multi-rank cases (``Mesh.regrid``
from 2 x 1 to 1 x 2): the DP step's ``dp.loss`` and ``dp.grad_norm`` against
JAX's instrumented step on a 2-device mesh (rtol 1e-5), nothing counted
when the flag is off, and the pipeline's statics, tick series and MoE aux on
every rank.  The ranks import this module, so it imports jax only inside
the fixtures and tests.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch import obs  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import dp  # noqa: E402
from ddl25spring_tpu_torch.parallel.het_pipeline import make_het_pipeline_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402
from ddl25spring_tpu_torch.utils.tracing import StepTimer, annotate, trace  # noqa: E402

RTOL = 1e-5
_g = np.random.default_rng(7)
MLP_W = {"w1": 0.3 * _g.normal(size=(16, 32)), "b1": 0.3 * _g.normal(size=32),
         "w2": 0.3 * _g.normal(size=(32, 4))}
MLP_W = {k: v.astype(np.float32) for k, v in MLP_W.items()}
MLP_X = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
MLP_Y = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
MOE = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=8, dtype="float32",
           n_experts=4, capacity_factor=2.0)
TOKENS = np.random.default_rng(3).integers(0, 64, (2, 8)).astype(np.int64)
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process too, as in the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts (and leaves) with telemetry disabled and a clean
    counter set: the global flag must never leak between tests."""
    obs.enable(False)
    obs.counters.reset()
    yield
    obs.enable(False)
    obs.counters.reset()


def _mlp():
    model = dp.TinyMlp()
    with torch.no_grad():
        for k, p in model.param_tree().items():
            p.copy_(torch.from_numpy(MLP_W[k]))
    return model


def obs_rank(rdv):
    """The DP counters with ``instrument`` on and following the (off) flag;
    the pipeline's statics, ticks and MoE aux, and the het pipeline's."""
    out = {}
    batch = (torch.from_numpy(MLP_X), torch.from_numpy(MLP_Y))
    with init_mesh(rdv, 2, stages=1, device="cpu") as mesh:
        for name, instrument in (("on", True), ("default", None)):
            obs.counters.reset()
            m = _mlp()
            step = dp.make_dp_train_step(m, dp.tiny_mlp_loss,
                                         torch.optim.SGD(m.parameters(), lr=0.1), mesh,
                                         instrument=instrument)
            losses = [step(batch).item() for _ in range(STEPS)]
            out["dp", name] = (losses, obs.counters.snapshot())
        pipe = mesh.regrid(1, stages=2)
        obs.counters.reset()
        cfg = LlamaConfig(**MOE)
        params = llama.export_params(llama.Llama(cfg, device="cpu",
                                                 generator=torch.Generator().manual_seed(0)))
        stage = shard_staged_params(params, cfg, pipe)
        step = make_pipeline_train_step(stage, cfg, torch.optim.SGD(stage.parameters(), lr=0.1),
                                        pipe, 2, instrument=True)
        for _ in range(STEPS):
            step(torch.from_numpy(TOKENS))
        out["pipeline"] = obs.counters.snapshot()
        obs.counters.reset()
        lin = torch.nn.Linear(16, 16 if pipe.coords[1] == 0 else 4)
        het = make_het_pipeline_train_step(
            lin, lambda y, b: ((y - b["y"]) ** 2).mean(), [(16,), (4,)],
            torch.optim.SGD(lin.parameters(), lr=0.1), pipe, 4, instrument=True)
        het({"x": torch.from_numpy(MLP_X), "y": torch.from_numpy(MLP_Y)})
        out["het"] = obs.counters.snapshot()
    return out


def _jax_dp_counters(devices8):
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu import obs as jobs
    from ddl25spring_tpu.parallel.dp import make_dp_train_step
    from ddl25spring_tpu.utils.mesh import make_mesh

    def loss_fn(p, batch, key):
        x, y = batch
        return jnp.mean((jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)

    tx = optax.sgd(0.1)
    jobs.counters.reset()
    step = make_dp_train_step(loss_fn, tx, make_mesh(devices8[:2], data=2),
                              per_shard_rng=False, instrument=True)
    p = {k: jnp.asarray(v) for k, v in MLP_W.items()}
    o = tx.init(p)
    for _ in range(STEPS):
        p, o, _ = step(p, o, (jnp.asarray(MLP_X), jnp.asarray(MLP_Y)), jax.random.PRNGKey(0))
    jax.effects_barrier()
    snap = jobs.counters.snapshot()
    jobs.counters.reset()
    return snap


@pytest.fixture(scope="module")
def world(devices8, tmp_path_factory):
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, obs_rank, 2, timeout=240,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        ref = _jax_dp_counters(devices8)
        return ranks.result(), ref


def test_dp_counters_match_jax(world):
    ranks, ref = world
    for r in ranks:
        _, snap = r["dp", "on"]
        for name in ("dp.loss", "dp.grad_norm"):
            mine, theirs = snap["scalars"][name], ref["scalars"][name]
            assert mine["count"] == theirs["count"] == STEPS
            for k in ("sum", "min", "max", "last"):
                np.testing.assert_allclose(mine[k], theirs[k], rtol=RTOL, err_msg=(name, k))


def test_dp_counts_nothing_when_the_flag_is_off(world):
    ranks, _ = world
    for r in ranks:
        losses_on, _ = r["dp", "on"]
        losses, snap = r["dp", "default"]
        assert snap["scalars"] == {} and snap["series"] == {} and snap["static"] == {}
        assert losses == losses_on  # the instrumented step's arithmetic is the same


def test_pipeline_statics_ticks_and_moe_aux_on_every_rank(world):
    ranks, _ = world
    for r in ranks:
        snap = r["pipeline"]
        assert snap["static"] == {"pipeline.num_stages": 2, "pipeline.num_microbatches": 2,
                                  "pipeline.num_chunks": 1,
                                  "pipeline.bubble_fraction_gpipe": obs.gpipe_bubble_fraction(2, 2)}
        ticks = snap["series"]["pipeline.tick"]
        per_step = len(ticks) // STEPS
        assert per_step > 0 and len(ticks) == per_step * STEPS
        assert [int(i) for i, _ in ticks] == list(range(per_step)) * STEPS
        times = [t for _, t in ticks]
        assert times == sorted(times)
        aux = snap["scalars"]["pipeline.moe_aux"]
        # gpipe: one forward of the rank's chunk per microbatch and step
        assert aux["count"] == 2 * STEPS and 0.5 < aux["mean"] < 4.0


def test_het_pipeline_statics(world):
    ranks, _ = world
    for r in ranks:
        static = r["het"]["static"]
        assert static["pipeline.num_stages"] == 2 and static["pipeline.num_microbatches"] == 4
        assert static["pipeline.bubble_fraction_gpipe"] == pytest.approx(0.2)
        assert len(r["het"]["series"]["pipeline.tick"]) > 0


# ---------------------------------------------------------------- spans


def _chrome_events(rec):
    with rec.span("outer", cat="host", k=1), rec.span("inner"):
        time.sleep(0.002)
    rec.instant("marker", note="x")
    return rec.to_chrome_trace()


def test_span_json_validates_against_chrome_trace_schema(tmp_path):
    out = _chrome_events(obs.SpanRecorder(process_name="test-proc"))
    assert isinstance(out["traceEvents"], list)
    assert out["displayTimeUnit"] in ("ms", "ns")
    json.dumps(out)
    phs = {e["ph"] for e in out["traceEvents"]}
    assert "X" in phs and "M" in phs and "i" in phs
    for e in out["traceEvents"]:
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["pid"], int) and "tid" in e
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0 and isinstance(e["cat"], str)
        if e["ph"] == "i":
            assert e["s"] in ("g", "p", "t")
    spans = {e["name"]: e for e in out["traceEvents"] if e["ph"] == "X"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e3
    meta = [e for e in out["traceEvents"] if e["ph"] == "M"]
    assert any(e["args"].get("name") == "test-proc" for e in meta)
    assert out["otherData"]["time_origin_unix_s"] > 0
    p = obs.SpanRecorder().save(str(tmp_path / "trace.json"))
    assert json.load(open(p))["traceEvents"]


def test_span_events_are_the_jax_recorders():
    from ddl25spring_tpu import obs as jobs

    def shape(out):
        return [(e["name"], e["ph"], e.get("cat"), e.get("args"), e.get("s"))
                for e in out["traceEvents"]]

    mine = _chrome_events(obs.SpanRecorder(process_name="p"))
    theirs = _chrome_events(jobs.SpanRecorder(process_name="p"))
    assert shape(mine) == shape(theirs)
    assert set(mine) == set(theirs) and set(mine["otherData"]) == set(theirs["otherData"])


def test_spans_threadsafe_and_disabled_is_noop():
    rec = obs.SpanRecorder()

    def worker(i):
        with rec.span(f"w{i}"):
            time.sleep(0.001)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    names = {e["name"] for e in rec.to_chrome_trace()["traceEvents"]}
    assert {f"w{i}" for i in range(8)} <= names
    before = len(obs.get_recorder())
    with obs.span("ignored"):
        pass
    obs.instant("ignored")
    assert len(obs.get_recorder()) == before


def test_trace_holds_the_spans_and_annotations(tmp_path):
    with trace(str(tmp_path)), obs.scoped(True):
        with obs.span("obs.step", step=0), annotate("tracing.region"):
            torch.ones(64).mul(2).sum()
    doc = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"obs.step", "tracing.region"} <= names
    assert any(str(n).startswith("aten::") for n in names)


# --------------------------------------------------------------- logger


def test_metrics_jsonl_roundtrip(tmp_path):
    run = str(tmp_path / "run")
    meta = obs.run_metadata(mesh={"data": 2, "stage": 2}, layout="dppp", n_chips=4)
    assert meta["torch_version"] == torch.__version__
    assert "cuda_version" in meta and meta["device"] is None  # no card here
    with obs.MetricsLogger(run, meta=meta) as lg:
        for i in range(3):
            lg.log(step=i, wall_s=0.1 * (i + 1), samples=64,
                   loss=torch.tensor(2.5 - i), label="primary")
    recs = obs.read_jsonl(lg.path)
    assert len(recs) == 4 and recs[0]["record"] == "header"
    assert recs[0]["mesh"] == {"data": 2, "stage": 2} and recs[0]["layout"] == "dppp"
    assert "git_sha" in recs[0]
    for i, r in enumerate(recs[1:]):
        assert r["record"] == "step" and r["step"] == i
        assert isinstance(r["loss"], float)
    with obs.MetricsLogger(run) as lg2:
        lg2.log(step=3, wall_s=0.4)
    assert len(obs.read_jsonl(lg.path)) == 5
    with obs.MetricsLogger(run, meta=meta) as lg3:
        lg3.log(step=0, wall_s=0.2)
    assert len(obs.read_jsonl(lg3.path)) == 2


def test_run_metadata_reads_the_rank_grid():
    from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid

    mesh = Mesh(RankGrid(2, 3, "stage"), 4, torch.device("cpu"), "gloo", None)
    meta = obs.run_metadata(mesh, layout="dppp")
    assert meta["mesh"] == {"data": 2, "stage": 3}
    assert meta["rank"] == {"rank": 4, "coords": [1, 1]}


# -------------------------------------------------------------- counters


def test_counters_fold_a_step_value_at_once_on_the_cpu():
    obs.enable()
    obs.counters.emit("t.loss", torch.tensor(4.0))
    obs.counters.emit_many({"t.loss": torch.tensor(8.0), "t.other": 1.5})
    s = obs.counters.snapshot()["scalars"]["t.loss"]
    assert s["count"] == 2 and s["sum"] == 12.0 and s["last"] == 8.0
    assert s["min"] == 4.0 and s["max"] == 8.0 and s["mean"] == 6.0
    assert obs.counters.snapshot()["scalars"]["t.other"]["count"] == 1


def test_mark_series_are_host_times_in_order():
    obs.enable()
    for t in range(5):
        obs.counters.mark("t.tick", t)
    series = obs.counters.snapshot()["series"]["t.tick"]
    assert [int(i) for i, _ in series] == [0, 1, 2, 3, 4]
    times = [t for _, t in series]
    assert times == sorted(times)


def test_counters_record_nothing_when_disabled_unless_forced():
    assert obs.enabled() is False
    obs.counters.emit("t.x", torch.tensor(1.0))
    obs.counters.mark("t.m", 0)
    assert obs.counters.snapshot()["scalars"] == {}
    assert obs.counters.snapshot()["series"] == {}
    obs.counters.emit("t.x", torch.tensor(1.0), force=True)
    obs.counters.mark("t.m", 0, force=True)
    snap = obs.counters.snapshot()
    assert snap["scalars"]["t.x"]["count"] == 1 and len(snap["series"]["t.m"]) == 1


def test_counters_save_and_nan_is_skipped(tmp_path):
    obs.counters.add("t.a", float("nan"))
    obs.counters.add("t.a", 2.0)
    obs.counters.add_static("t.s", 7)
    doc = json.load(open(obs.counters.save(str(tmp_path))))
    assert doc["scalars"]["t.a"]["count"] == 1 and doc["static"] == {"t.s": 7}


def test_gpipe_bubble_fraction_math():
    from ddl25spring_tpu.obs import gpipe_bubble_fraction as jfrac

    for s, m in ((1, 8), (2, 2), (4, 12), (3, 3), (3, 6)):
        assert obs.gpipe_bubble_fraction(s, m) == jfrac(s, m)
    np.testing.assert_allclose(obs.gpipe_bubble_fraction(4, 12), 0.2)


def test_the_obs_package_exports_the_jax_names():
    from ddl25spring_tpu import obs as jobs

    assert sorted(obs.__all__) == sorted(jobs.__all__)


# -------------------------------------------------------------- StepTimer


def test_steptimer_percentiles_and_p50_rate():
    st = StepTimer(warmup=0)
    st.times = [0.1] * 9 + [1.0]
    np.testing.assert_allclose(st.p50_step_s, 0.1)
    assert st.p95_step_s > 0.5
    np.testing.assert_allclose(st.min_step_s, 0.1)
    np.testing.assert_allclose(st.mean_step_s, 0.19)
    np.testing.assert_allclose(st.steps_per_sec(), 10.0)
    with pytest.raises(ValueError, match="no timed steps"):
        StepTimer().p50_step_s


def test_steptimer_ticks_discard_warmup():
    st = StepTimer(warmup=1)
    for _ in range(4):
        st.tick(torch.ones(2))
    assert len(st.times) == 2
