"""The port's serving engine (``ddl25spring_tpu_torch/serve``) on the CPU:
the twins of the JAX package's ``tests/test_serve.py`` (but its compile
signature pins, which wait for the ``describe()`` registry, and its goodput
and ``obs_report`` asserts, which wait for the rest of the observability
port), held to the JAX engine where the two must agree.

The load-bearing pins:

- **paged == dense**: greedy fp32 decode through the page pool equals the
  port's dense ``generate`` token for token, across a page boundary and a
  mid-batch admission;
- **the JAX engine's schedule and streams**: on the seeded trace, under the
  virtual clock, the port's engine emits JAX's per-request tokens, token
  timeline, rejection counts and A/B numbers exactly;
- **continuous beats static**, and the report tool reads the port's
  ``serve.json`` and ledger row unchanged.

The weights are the port's seeded ``Llama`` exported as the JAX pytree.
Tolerances: tokens and schedules exact; every token compared with JAX's
first clears a top-2 logit margin of ``MARGIN`` (10x the 1e-5 fp32 logit
band), measured on the port's full forward.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.serve import driver as jdriver  # noqa: E402
from ddl25spring_tpu.serve import engine as jengine  # noqa: E402
from ddl25spring_tpu.serve import traffic as jtraffic  # noqa: E402
from ddl25spring_tpu_torch.analysis import host_sanitizer  # noqa: E402
from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.serve import driver, kv_pages  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import (  # noqa: E402
    REJECT_BAD_REQUEST,
    REJECT_POOL_EXHAUSTED,
    REJECT_QUEUE_FULL,
    REJECT_TOKEN_BUDGET,
    REJECT_TOO_LONG,
    ServeEngine,
    make_decode_tick,
)
from ddl25spring_tpu_torch.serve.traffic import (  # noqa: E402
    PROFILES,
    TrafficSpec,
    synth_trace,
    trace_tokens,
)

CFG = driver.serve_model("tiny")
MARGIN = 1e-4


@pytest.fixture(scope="module")
def params():
    m = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return m.requires_grad_(False)


@pytest.fixture(scope="module")
def jparams(params):
    return jax.tree.map(jnp.asarray, llama.export_params(params))


def dense_greedy(params, prompt: list[int], max_new: int) -> list[int]:
    return dm.generate(params, torch.tensor([prompt], dtype=torch.int32), CFG,
                       max_new).numpy()[0].tolist()


def assert_margins(params, prompt, tokens):
    """The port's full forward over ``prompt + tokens`` picks each token by a
    top-2 margin above ``MARGIN`` (so a JAX-vs-port token flip is a defect)."""
    seq = torch.tensor([list(prompt) + list(tokens)])
    logits = llama.llama_forward(params, seq, CFG)[0, len(prompt) - 1:-1]
    top2 = logits.topk(2, dim=-1)
    assert top2.indices[:, 0].tolist() == list(tokens)
    assert float((top2.values[:, 0] - top2.values[:, 1]).min()) > MARGIN


def make_engine(params, **kw):
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


def used(eng) -> int:
    return int((~eng.pool["free"]).sum())


# ------------------------------------------------- equivalence pins


def test_paged_reproduces_dense_across_a_page_boundary(params):
    """Prompt 4 + 9 generated crosses the page_len=4 boundary twice."""
    prompt, max_new = [5, 9, 11, 3], 9
    dense = dense_greedy(params, prompt, max_new)
    eng = make_engine(params)
    eng.warmup()  # also pins: warmup leaves no state behind
    assert eng.generated_tokens == 0 and eng.admitted == 0
    assert not eng.ttft_s and not eng.done and used(eng) == 0
    req = eng.make_request(prompt, max_new)
    assert eng.submit(req) is None
    drain(eng)
    assert req.tokens == dense
    assert eng.pool_ok_failures == 0


def test_mid_batch_admission_is_token_exact(params):
    a_prompt, a_new = [5, 9, 11, 3], 9
    b_prompt, b_new = [7, 2, 8], 6
    eng = make_engine(params)
    ra = eng.make_request(a_prompt, a_new)
    assert eng.submit(ra) is None
    eng.step()
    eng.step()
    assert eng.slots[0] is ra and len(ra.tokens) >= 2
    rb = eng.make_request(b_prompt, b_new)
    assert eng.submit(rb) is None
    eng.step()  # admits B mid-flight while A stays resident
    assert rb.admitted_t is not None and ra.done_t is None
    drain(eng)
    assert ra.tokens == dense_greedy(params, a_prompt, a_new)
    assert rb.tokens == dense_greedy(params, b_prompt, b_new)
    assert eng.pool_ok_failures == 0


def test_eos_stops_a_sequence_and_frees_its_slot(params):
    prompt = [5, 9, 11, 3]
    dense = dense_greedy(params, prompt, 9)
    eos = dense[3]  # 4th generated token
    eng = make_engine(params, eos_id=eos)
    req = eng.make_request(prompt, 9)
    eng.submit(req)
    drain(eng)
    assert req.tokens == dense[:4] and req.tokens[-1] == eos
    eng.step()  # flush the release mask
    assert int(eng.pool["free"].sum()) == eng.n_pages
    assert not eng.pool["active"].any()


def test_pages_freed_on_completion_and_host_mirror(params):
    eng = make_engine(params)
    req = eng.make_request([5, 9, 11, 3], 5)
    eng.submit(req)
    eng.step()
    assert eng._host_pages_used() > 0
    drain(eng)
    eng.step()  # flush release
    assert eng._host_pages_used() == 0 and used(eng) == 0
    # 4 prompt + 4 appended tokens = 8 written positions -> 2 pages of 4
    assert eng.peak_pages == 2
    assert eng.metrics()["page_pool_peak_pages"] == 2
    leak = eng.mem_leak_check()
    assert leak["ok"] and leak["leaked_pages"] == 0
    assert eng.mem_pool_snapshot()["used_pages"] == 0


def test_leak_check_names_a_stranded_page(params):
    eng = make_engine(params)
    eng.submit(eng.make_request([5, 9, 11], 3))
    eng.step()  # 4 positions written: one page
    eng.slots = [None] * eng.max_slots  # the host forgets a live sequence
    leak = eng.mem_leak_check()
    assert not leak["ok"] and leak["leaked_pages"] == 1
    assert leak["leaks"][0]["held_by"] == "page_table" and leak["leaks"][0]["rid"] == 0


def test_sanitizer_checks_the_page_mirror_at_every_step(params, monkeypatch):
    monkeypatch.setenv("DDL25_SANITIZE", "1")
    eng = make_engine(params, prefill_batch=2)
    assert eng._sanitize
    for prompt in ([5, 9, 11, 3], [7, 2], [1, 2, 3, 4, 5]):
        eng.submit(eng.make_request(prompt, 6))
    drain(eng)  # check_serve_mirror ran after every step
    eng.submit(eng.make_request([5, 9], 3))
    eng.step()
    eng.slots[0].tokens.extend([0] * 8)  # the host's count drifts
    with pytest.raises(host_sanitizer.SanitizerError, match="mirror drift"):
        host_sanitizer.check_serve_mirror(eng)


# ------------------------------------------------- the JAX engine's twin


AB_KNOBS = dict(page_len=4, n_pages=16, max_slots=2, prefill_batch=2, max_prompt_len=8,
                max_queue=64, token_budget=None, eos_id=None)


@pytest.fixture(scope="module")
def seeded_trace():
    trace = synth_trace(TrafficSpec(seed=3, duration_s=0.2, rate_rps=120.0,
                                    profile="flat", vocab_size=CFG.vocab_size))
    assert len(trace) >= 10
    return trace


def _jax_engine(jparams, **kw):
    return jengine.ServeEngine(jparams, jdriver.serve_model("tiny"), **kw)


def test_continuous_beats_static_as_the_jax_engine_does(params, jparams, seeded_trace):
    """THE acceptance pin, and the port's A/B is JAX's number for number:
    same budget, same tokens by the budget, same per-arm ticks, prefills
    and drain times on the virtual clock."""
    ab = driver.ab_compare(params, CFG, seeded_trace, AB_KNOBS)
    assert ab["continuous_tokens_at_budget"] > ab["static_tokens_at_budget"]
    assert ab["advantage_tokens"] > 0
    assert ab["continuous"]["generated_tokens"] == ab["static"]["generated_tokens"]
    assert ab["continuous"]["drain_wall_s"] < ab["static"]["drain_wall_s"]
    ref = jdriver.ab_compare(jparams, jdriver.serve_model("tiny"), seeded_trace, AB_KNOBS)
    assert ab == ref


@pytest.mark.parametrize("knobs", [
    dict(AB_KNOBS),
    # admission pressure: a short queue and a token budget reject at the door
    dict(AB_KNOBS, max_queue=3, token_budget=30),
], ids=["unloaded", "rejecting"])
def test_engine_streams_timeline_and_rejections_equal_jax(params, jparams, seeded_trace,
                                                          knobs):
    """The same trace through the port's and JAX's continuous engines on the
    virtual clock: identical per-request token streams, token timeline and
    rejection counts."""
    tick_s = driver.ab_tick_s(seeded_trace, knobs["max_slots"])
    eng = make_engine(params, **{**knobs, "pages_per_seq": None}, tick_s=tick_s,
                      trace_label=None)
    m = eng.run(seeded_trace, max_steps=5_000)
    ref = _jax_engine(jparams, **knobs, clock="virtual", tick_s=tick_s, trace_label=None)
    jm = ref.run(seeded_trace, max_steps=5_000)
    streams = {r.rid: r.tokens for r in eng.done}
    assert streams == {r.rid: [int(t) for t in r.tokens] for r in ref.done}
    for r in eng.done:
        assert_margins(params, r.prompt, r.tokens)
    assert eng.token_log == ref.token_log
    assert m["rejected_by_reason"] == jm["rejected_by_reason"]
    for k in ("admitted", "completed", "generated_tokens", "ticks", "prefills", "wall_s",
              "ttft_s_p50", "ttft_s_p95", "page_pool_peak_pages", "queue_depth_max"):
        assert m[k] == jm[k], k
    if knobs["token_budget"]:
        assert m["rejected"] > 0


def test_ab_compare_equalizes_prefill_width(params):
    trace = [{"t": 0.0, "prompt": [1 + i, 2 + i], "max_new": 3} for i in range(4)]
    knobs = dict(AB_KNOBS, prefill_batch=1)
    ab = driver.ab_compare(params, CFG, trace, knobs)
    assert ab["static"]["prefills"] == 2
    assert ab["static"]["completed"] == 4
    assert ab["advantage_tokens"] >= 0


def test_token_timeline_readout(params):
    eng = make_engine(params)
    eng.submit(eng.make_request([5, 9], 4))
    drain(eng)
    assert eng.tokens_at(0.0) == 0
    assert eng.tokens_at(float("inf")) == eng.generated_tokens == 4
    counts = [n for _, n in eng.token_log]
    assert counts == sorted(counts)


# ------------------------------------------------- admission control


def test_rejection_reasons(params):
    eng = make_engine(params, max_queue=1, token_budget=16)
    # over the prefill program's static prompt width: malformed for this build
    assert eng.submit(eng.make_request(list(range(1, 10)), 2)) == REJECT_BAD_REQUEST
    assert eng.submit(eng.make_request([1, 2, 3], 30)) == REJECT_TOO_LONG
    small = make_engine(params, n_pages=2, pages_per_seq=4)
    assert small.submit(small.make_request([1, 2, 3, 4], 8)) == REJECT_POOL_EXHAUSTED
    assert eng.submit(eng.make_request([1], 2)) is None
    assert eng.submit(eng.make_request([1], 2)) == REJECT_QUEUE_FULL
    eng2 = make_engine(params, token_budget=16)
    assert eng2.submit(eng2.make_request([1, 2, 3], 2)) is None
    assert eng2.submit(eng2.make_request([1, 2, 3, 4], 10)) == REJECT_TOKEN_BUDGET
    assert eng2.submit(eng2.make_request([], 3)) == REJECT_BAD_REQUEST
    assert eng2.submit(eng2.make_request([1, 2], 0)) == REJECT_BAD_REQUEST
    counts = eng.metrics()["rejected_by_reason"]
    assert counts == {REJECT_BAD_REQUEST: 1, REJECT_TOO_LONG: 1, REJECT_QUEUE_FULL: 1}
    assert eng2.metrics()["rejected_by_reason"][REJECT_BAD_REQUEST] == 2


def test_head_of_line_backpressure_until_pages_free(params):
    eng = make_engine(params, n_pages=3, max_slots=2, prefill_batch=2)
    ra = eng.make_request([1, 2, 3, 4], 8)   # 12 positions -> 3 pages
    rb = eng.make_request([5, 6, 7, 8], 8)   # 3 more pages: must wait
    assert eng.submit(ra) is None and eng.submit(rb) is None
    eng.step()
    assert ra.admitted_t is not None and rb.admitted_t is None
    drain(eng)
    assert rb.admitted_t is not None and rb.admitted_t > ra.done_t - 1e-9
    assert len(ra.tokens) == 8 and len(rb.tokens) == 8
    assert eng.pool_ok_failures == 0


def test_static_admission_waits_for_the_batch_to_drain(params):
    eng = make_engine(params, admission="static", prefill_batch=1)
    ra = eng.make_request([1, 2], 6)
    rb = eng.make_request([3, 4], 2)
    eng.submit(ra)
    eng.submit(rb)
    eng.step()
    assert ra.admitted_t is not None and rb.admitted_t is None
    for _ in range(3):
        eng.step()
        if ra.done_t is None:
            assert rb.admitted_t is None
    drain(eng)
    assert rb.tokens and rb.admitted_t >= ra.done_t - 1e-9


def test_prefill_completed_request_skips_the_decode_tick(params):
    eng = make_engine(params, prefill_batch=2)
    ra = eng.make_request([5, 9, 11, 3], 6)
    rb = eng.make_request([7, 2], 1)
    assert eng.submit(ra) is None and eng.submit(rb) is None
    eng.step()  # prefill admits both; rb completes at its first token
    assert rb.done_t is not None and rb.tokens == dense_greedy(params, [7, 2], 1)
    assert ra.done_t is None
    assert not bool(eng.pool["active"][1])
    assert used(eng) == eng._host_pages_used()
    drain(eng)
    eng.step()
    assert used(eng) == 0 and eng.pool_ok_failures == 0


# ------------------------------------------------- refusals


def test_geometry_and_argument_refusals(params):
    with pytest.raises(ValueError, match="num_heads=0"):
        kv_pages.resolve_heads(CFG, 0)
    with pytest.raises(ValueError, match="num_heads=-2"):
        kv_pages.resolve_heads(CFG, -2)
    assert kv_pages.resolve_heads(CFG, None) == CFG.num_heads
    with pytest.raises(ValueError, match="n_pages=0"):
        kv_pages.init_page_pool(CFG, n_pages=0, page_len=2, max_slots=1, pages_per_seq=1)
    with pytest.raises(ValueError, match="pages_per_seq=0"):
        make_engine(params, pages_per_seq=0)
    with pytest.raises(ValueError, match="prefill_batch=0"):
        make_engine(params, prefill_batch=0)
    with pytest.raises(ValueError, match="admission"):
        make_engine(params, admission="fifo")


def test_a9b_options_raise_not_implemented(params, monkeypatch):
    """The A9b-3 options, once refused, now build (their serving runs are
    ``test_torch_serve_tp.py``'s, on a world of 2 ranks): a ``tp=2`` engine
    holds its rank's heads and slices, the streamed one its ZeRO-3 rows; the
    decode tick over an axis of one rank is the single-card tick; the knobs
    read ``DDL25_SERVE_TP`` and ``DDL25_SERVE_WEIGHT_STREAM``.  What stays
    refused: ``weight_stream`` without ``tp``, and ``tp`` without the ranks."""
    from ddl25spring_tpu_torch.parallel.comm import Axis
    from ddl25spring_tpu_torch.parallel.zero import StreamRows
    from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid

    mesh = Mesh(RankGrid(1, 2, "model"), 0, torch.device("cpu"), "gloo", None,
                {"data": None, "model": None})
    for kw in (dict(tp=2), dict(tp=2, weight_stream=True)):
        eng = make_engine(params, mesh=mesh, graphs=False, **kw)
        assert eng.tp == 2 and eng.weight_stream is kw.get("weight_stream", False)
        assert eng.pool["k"].shape[3] == CFG.num_heads // 2
        assert isinstance(eng.params, StreamRows) is eng.weight_stream
    with pytest.raises(ValueError, match="tp > 1"):
        make_engine(params, weight_stream=True)
    with pytest.raises(ValueError, match="ranks"):
        make_engine(params, tp=2)
    one = Axis("model", None, None, (0,), 0)
    toks = torch.tensor([3, 5], dtype=torch.int32)
    outs = []
    for axis in (one, None):
        eng = make_engine(params)
        eng.pool = kv_pages.init_page_pool(CFG, n_pages=16, page_len=4, max_slots=2,
                                           pages_per_seq=4)
        eng.pool["active"][:] = True
        outs.append(make_decode_tick(CFG, tp_axis=axis)(params, eng.pool, toks, None))
    assert torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in outs[0][0])
    with pytest.raises(ValueError, match="mesh"):
        driver.run_serve_bench(smoke=True, device="cpu", serve_tp=2)
    monkeypatch.setenv("DDL25_SERVE_TP", "2")
    monkeypatch.setenv("DDL25_SERVE_WEIGHT_STREAM", "1")
    knobs = driver.engine_knobs(smoke=True)
    assert knobs["tp"] == 2 and knobs["weight_stream"] is True


# ------------------------------------------------- kv_pages units


def test_page_pool_reserve_write_release_roundtrip():
    pool = kv_pages.init_page_pool(CFG, n_pages=4, page_len=2, max_slots=2, pages_per_seq=2)
    slots = torch.arange(2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    pool, ok = kv_pages.reserve_pages(pool, slots, pos, torch.tensor([True, True]))
    assert bool(ok) and int(kv_pages.used_pages(pool)) == 2
    table = pool["page_table"].numpy()
    assert (table[:, 0] >= 0).all() and (table[:, 1] == -1).all()
    assert table[0, 0] != table[1, 0]  # distinct pages
    pages, offs = kv_pages.write_page_ids(pool, slots, pos, torch.tensor([True, False]))
    assert int(pages[1]) == 4  # the trash row (n_pages)
    pool = kv_pages.release_slots(pool, torch.tensor([True, False]))
    assert int(kv_pages.used_pages(pool)) == 1
    assert (pool["page_table"][0] == -1).all()


def test_reserve_pages_refusals_are_atomic():
    pool = kv_pages.init_page_pool(CFG, n_pages=4, page_len=4, max_slots=2, pages_per_seq=2)
    pool2, ok = kv_pages.reserve_pages(pool, torch.tensor([0]), torch.tensor([2 * 4]),
                                       torch.tensor([True]))  # entry 2 >= pages_per_seq
    assert not bool(ok) and int(pool2["free"].sum()) == 4
    assert torch.equal(pool2["page_table"], pool["page_table"])
    pool = kv_pages.init_page_pool(CFG, n_pages=1, page_len=2, max_slots=2, pages_per_seq=2)
    pool, ok = kv_pages.reserve_pages(pool, torch.arange(2), torch.zeros(2, dtype=torch.int32),
                                      torch.tensor([True, True]))
    assert not bool(ok) and int(kv_pages.used_pages(pool)) == 0


# ------------------------------------------------- traffic


def test_trace_is_seed_deterministic_and_byte_identical_to_jax():
    spec = TrafficSpec(seed=7, duration_s=1.0, rate_rps=10.0)
    a, b = synth_trace(spec), synth_trace(spec)
    assert a == b and len(a) > 0
    assert a != synth_trace(TrafficSpec(seed=8, duration_s=1.0, rate_rps=10.0))
    assert all(0.0 <= r["t"] < 1.0 for r in a)
    assert trace_tokens(a) == sum(len(r["prompt"]) + r["max_new"] for r in a)
    assert PROFILES == jtraffic.PROFILES
    for profile in PROFILES:
        kw = dict(seed=3, duration_s=3.0, rate_rps=8.0, profile=profile, vocab_size=64)
        mine = json.dumps(synth_trace(TrafficSpec(**kw)))
        assert mine == json.dumps(jtraffic.synth_trace(jtraffic.TrafficSpec(**kw))), profile


def test_ramp_and_spike_profiles_shape_the_rate():
    ramp = TrafficSpec(profile="ramp", rate_rps=10.0, duration_s=10.0)
    assert ramp.rate_at(0.0) == pytest.approx(1.0)
    assert ramp.rate_at(10.0) == pytest.approx(10.0)
    spike = TrafficSpec(profile="spike", rate_rps=10.0, duration_s=9.0)
    assert spike.rate_at(1.0) == pytest.approx(3.0)
    assert spike.rate_at(4.5) == pytest.approx(10.0)
    assert spike.rate_at(8.0) == pytest.approx(3.0)
    with pytest.raises(ValueError, match="profile"):
        TrafficSpec(profile="bogus").rate_at(1.0)
    assert synth_trace(TrafficSpec(rate_rps=0.0)) == []


# ------------------------------------------------- driver + tooling


@pytest.fixture(scope="module")
def smoke_record(tmp_path_factory):
    """One tiny end-to-end driver run on the shared-prefix trace (so both A/Bs
    have something to show), shared by the contract tests."""
    out = tmp_path_factory.mktemp("serve_run")
    led = str(out / "ledger.jsonl")
    rec = driver.run_serve_bench(smoke=True, obs_dir=str(out), duration_s=2.0, rate_rps=6.0,
                                 profile="shared", seed=0, ledger_path=led, device="cpu")
    return rec, out, led


SERVE_CONTRACT_KEYS = (
    "tokens_per_sec_per_chip", "ttft_s_p50", "ttft_s_p95",
    "tok_latency_s_p50", "tok_latency_s_p95", "admitted", "rejected",
    "completed", "page_pool_peak_occupancy", "page_pool_peak_pages",
)


def test_driver_emits_the_telemetry_serve_contract(smoke_record):
    rec, out, led = smoke_record
    cell = driver.serve_cell(rec)
    for k in SERVE_CONTRACT_KEYS:
        assert cell.get(k) is not None, k
    assert cell["ab"]["advantage_tokens"] > 0
    assert cell["pool_leak"]["ok"] and cell["completed"] == cell["admitted"]
    assert json.loads(json.dumps(cell))  # BENCH-line serializable
    doc = json.loads((out / "serve.json").read_text())
    assert doc["record"] == "serve" and doc["ramp"]["admitted"] > 0
    rows = [json.loads(line) for line in open(led) if line.strip()]
    # a serve row and a goodput row a run (the mem row needs obs on)
    assert [r["record"] for r in rows] == ["serve", "goodput"]
    assert rows[1]["key"] == {"strategy": "serve/tiny", "mesh": {"replicas": 1},
                              "scope": "serve", "profile": "shared"}
    assert rows[1]["slo_attainment"] == rec["goodput"]["slo_attainment"] is not None
    assert rows[0]["ab"]["advantage_tokens"] > 0
    assert "ttft_s" not in rows[0] and "tick_wall_s" not in rows[0]


def test_serve_report_reads_the_ports_record_unchanged(smoke_record, capsys):
    import tools.serve_report as serve_report

    rec, out, led = smoke_record
    assert serve_report.main([str(out), "--ledger", led, "--check", "--check-ab",
                              "--check-prefix-ab"]) == 0
    cap = capsys.readouterr()
    assert "TTFT histogram" in cap.out and "no baseline yet" in cap.err
    good = serve_report.read_ledger(led)[0]
    bad = dict(good, tokens_per_sec_per_chip=good["tokens_per_sec_per_chip"] * 0.1,
               ttft_s_p95=good["ttft_s_p95"] * 10)
    led2 = str(out / "regressed.jsonl")
    with open(led2, "w") as f:
        for r in (good, good, bad):
            f.write(json.dumps(r) + "\n")
    assert serve_report.main(["--ledger-only", "--ledger", led2, "--check"]) == 1
    assert "tokens_per_sec_per_chip" in capsys.readouterr().err


def test_bench_serve_entry_prints_the_bench_line(tmp_path, capsys):
    from ddl25spring_tpu_torch import bench, obs

    prev = obs.get_recorder()
    try:
        with obs.scoped(False):  # --obs-dir turns telemetry on for the run
            rec = bench.main(["--serve", "--smoke", "--device", "cpu", "--obs-dir",
                              str(tmp_path), "--perf-ledger", str(tmp_path / "l.jsonl"),
                              "--serve-duration", "0.5", "--serve-rate", "20",
                              "--no-serve-prefix-ab"])
    finally:
        obs.set_recorder(prev)
        obs.timeline.configure(None)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(rec, default=str))
    assert last["metric"] == "serve_tokens_per_sec_per_chip" and last["chip"] == "cpu x1"
    tel = last["telemetry"]
    assert tel["serve"]["ab"]["advantage_tokens"] >= 0 and "prefix_ab" not in tel["serve"]
    assert tel["health"]["violations"] == 0
    assert tel["goodput"]["scope"] == "serve" and tel["goodput"]["lineage_id"]
    assert tel["mem"]["enabled"] is True and tel["mem"]["samples"] > 0
    assert (tmp_path / "mem.json").exists() and (tmp_path / "goodput.json").exists()
    assert (tmp_path / "timeline.jsonl").exists() and (tmp_path / "trace.json").exists()
