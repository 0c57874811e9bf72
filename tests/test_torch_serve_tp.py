"""TP-sharded serving and the ZeRO-3 weight-streaming decode of the port
(``serve/engine.py`` at ``tp > 1``, ``parallel/zero.py``'s stream helpers,
``serve/driver.py``'s ``tp_ab_compare``, ``bench --serve --serve-tp``)
against the JAX package's TP program bodies, JAX's dense ``generate`` and the
port's own single-card engine, on the CPU.

One spawned gloo world of 2 ranks (the ``model`` axis; one torch thread
each) runs every engine case of the JAX tests' tiny config
(``tests/test_serve_tp.py``: vocab 64, dmodel 16, 2 heads, 2 layers, ctx 32,
fp32) from the port's seeded ``Llama``; the JAX references run meanwhile,
each TP body under ``shard_map`` on 2 of conftest's 8 CPU devices (the
reference's own ``_tp_jit`` wrapper fails under this jax, its bodies do not).

- **programs**: the port's TP tick, TP prefill (start 0 and the page-aligned
  start 4), streamed tick and streamed prefill against the JAX bodies on the
  same inputs: tokens equal, each rank's k/v slice within 1e-6 of the JAX
  device shard; streamed logits and pools equal resident ones bitwise;
- **engines**: ``tp=2`` resident and streamed engines give the single-card
  engine's tokens and JAX ``generate``'s, each greedy token clear of a
  ``MARGIN`` top-2 gap; a prefix-cache hit and ``spec_k=2`` give the
  ``tp=1`` streams; the refcount invariant holds at every step of seeded
  interleavings, the accounting equal to the ``tp=1`` engine's;
- **stream helpers**: JAX's bucket plan, JAX's row shards bitwise, gathers
  that give back the leaves bitwise;
- **budgets, A/B and bench**: the per-rank bill shrinks, the global one does
  not; ``tp_ab_compare`` gates green; ``bench --serve --smoke --serve-tp 2
  --device cpu`` (its other A/Bs skipped) then ``serve_report --check-tp``
  exits 0.

The ranks import this module, so it imports jax only inside fixtures and
tests.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import tp as ptp  # noqa: E402
from ddl25spring_tpu_torch.parallel import zero  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.serve import driver, kv_pages  # noqa: E402
from ddl25spring_tpu_torch.serve import engine as eng_mod  # noqa: E402
from ddl25spring_tpu_torch.serve import spec as spec_mod  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import KV_POOL_HEAD_DIM, ServeEngine  # noqa: E402
from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid, init_mesh  # noqa: E402

SIZES = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=32, dtype="float32")
CFG = LlamaConfig(**SIZES)
ENGINE_KW = dict(page_len=4, n_pages=16, max_slots=2, pages_per_seq=4, prefill_batch=1,
                 max_prompt_len=8, clock="virtual", graphs=False)
POOL_KEYS = ("page_table", "seq_len", "active", "free", "refcount")
MARGIN = 1e-4   # the top-2 gap every compared greedy token must clear
KV_BAND = 1e-6  # a rank's k/v slice against the JAX device shard
# the JAX test's requests: A crosses a page boundary, B is admitted mid-batch
REQ_A, REQ_B = ([5, 9, 11, 3], 9), ([7, 2, 8], 6)
SHARED = [5, 9, 11, 3, 7, 2, 8, 6]  # 2 full pages: a clean radix hit
# the program-parity inputs: prompts [2, 8], prefill at start 0 and 4
PROMPTS = np.random.default_rng(5).integers(1, 64, size=(2, 8)).astype(np.int32)
PREFILLS = {0: (np.array([5, 3], np.int32), np.array([0, 0], np.int32)),
            4: (np.array([7, 6], np.int32), np.array([4, 4], np.int32))}
SLOT_IDS = np.array([0, 1], np.int32)
# bench --serve --serve-tp 2's command line (the A/Bs other than TP's are
# other tests')
BENCH_ARGS = ["--serve", "--smoke", "--serve-tp", "2", "--device", "cpu", "--no-serve-ab",
              "--no-serve-prefix-ab"]


def _model(cfg=CFG, seed=0):
    m = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return m.requires_grad_(False)


def make_engine(params, **kw):
    return ServeEngine(params, CFG, **{**ENGINE_KW, **kw})


def drain(eng, max_steps: int = 500):
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


def serve_tokens(eng, requests, together: bool = False) -> list[list[int]]:
    """Each request's tokens: one after another (each drains first), or, with
    ``together``, the JAX test's schedule (A, two steps, B mid-flight)."""
    if together:
        (pa, na), (pb, nb) = requests
        ra = eng.make_request(pa, na)
        assert eng.submit(ra) is None
        eng.step()
        eng.step()
        rb = eng.make_request(pb, nb)
        assert eng.submit(rb) is None
        drain(eng)
        return [list(ra.tokens), list(rb.tokens)]
    out = []
    for prompt, max_new in requests:
        r = eng.make_request(prompt, max_new)
        assert eng.submit(r) is None
        drain(eng)
        out.append(list(r.tokens))
    return out


def _np_pool(pool) -> dict:
    return {k: t.numpy().copy() for k, t in pool.items()}


def fake_mesh(n: int) -> Mesh:
    """A rank's view of a ``1 x n`` model grid with no world behind it: what
    the constructor checks read."""
    return Mesh(RankGrid(1, n, "model"), 0, torch.device("cpu"), "gloo", None,
                {"data": None, "model": None})


def assert_pool_invariants(eng):
    """``free`` is exactly the zero-refcount set, and every reference is
    accounted: one per page-table entry holding the page plus one iff the
    cache holds a node on it."""
    p = _np_pool(eng.pool)
    refcount, free, table = p["refcount"], p["free"], p["page_table"]
    n_pages = free.shape[0]
    assert (free == (refcount == 0)).all() and (refcount >= 0).all()
    table_refs = np.bincount(table[table >= 0].ravel(), minlength=n_pages)[:n_pages]
    cache_refs = np.zeros((n_pages,), np.int64)
    cache_refs[eng.prefix.pages()] = 1
    assert (refcount == table_refs + cache_refs).all(), (refcount, table_refs)


# ------------------------------------------------------------ the ranks


def _programs(model, mesh) -> dict:
    """The TP programs on the parity inputs: resident and streamed bodies of
    two engines, each on fresh pools."""
    res = make_engine(model, tp=2, mesh=mesh)
    st = make_engine(model, tp=2, mesh=mesh, weight_stream=True)
    out = {}

    def pool():
        return kv_pages.init_page_pool(CFG, n_pages=16, page_len=4, max_slots=2,
                                       pages_per_seq=4, num_heads=1)

    for name, e in (("resident", res), ("streamed", st)):
        lens, starts = PREFILLS[0]
        p1, first, _ = e._prefill_at(0).body(
            e.params, pool(), torch.from_numpy(PROMPTS), torch.from_numpy(lens),
            torch.from_numpy(starts), torch.from_numpy(SLOT_IDS), None)
        before_tick = _np_pool(p1)
        p2, new, _ = e._tick.body(e.params, {k: t.clone() for k, t in p1.items()}, first, None)
        lens4, starts4 = PREFILLS[4]
        p4, first4, _ = e._prefill_at(4).body(
            e.params, pool(), torch.from_numpy(PROMPTS), torch.from_numpy(lens4),
            torch.from_numpy(starts4), torch.from_numpy(SLOT_IDS), None)
        out[name] = {"prefill0": (first.numpy(), before_tick), "tick": (new.numpy(), _np_pool(p2)),
                     "prefill4": (first4.numpy(), _np_pool(p4))}
        # the tick's logits, from its own position step on a copy of p1
        stack = None if e._stream is None else eng_mod._stream_layer_stack(e.axis, *e._stream)
        step = spec_mod._position_step(CFG, e.axis, stack)
        _, logits, _ = step(e.params, {k: t.clone() for k, t in p1.items()}, first,
                            p1["seq_len"], p1["active"])
        out[name]["logits"] = logits.numpy()
    return out


def _engines(model, mesh) -> dict:
    """Token streams of the tp=2 engines (resident, streamed; the JAX test's
    schedule), the prefix-cache hit and spec runs, each with the tp=1
    engine's beside it."""
    out = {}
    for name, kw in (("single", {}), ("resident", dict(tp=2, mesh=mesh)),
                     ("streamed", dict(tp=2, mesh=mesh, weight_stream=True))):
        e = make_engine(model, **kw)
        out[name] = serve_tokens(e, [REQ_A, REQ_B], together=True)
        out[name + " ok"] = e.pool_ok_failures == 0
        if name != "single":
            out[name + " heads"] = e.pool["k"].shape[KV_POOL_HEAD_DIM]
            out[name + " metrics"] = {k: e.metrics()[k] for k in (
                "tp", "weight_stream", "n_chips", "pool_bytes_per_chip", "param_bytes_per_chip")}
            out[name + " graphs"] = e.metrics()["config"]["graphs"]
    for tp in (1, 2):
        kw = dict(tp=2, mesh=mesh) if tp == 2 else {}
        e = make_engine(model, prefix_cache=True, **kw)
        out["prefix", tp] = (serve_tokens(e, [(SHARED, 6), (SHARED, 6)]), e.prefix.hits,
                             e.prefill_tokens_saved)
        e = make_engine(model, spec_k=2, **kw)
        out["spec", tp] = (serve_tokens(e, [REQ_A, REQ_B]), e.draft_tokens_accepted,
                           e.pool_ok_failures)
        if tp == 2:
            out["spec heads"] = (e.pool["k"].shape[KV_POOL_HEAD_DIM],
                                 e.draft_pool["k"].shape[KV_POOL_HEAD_DIM])
        # sampled: each rank draws the same noise from its generator, seeded alike
        e = make_engine(model, temperature=0.8, seed=3, **kw)
        out["sampled", tp] = serve_tokens(e, [REQ_A, REQ_B], together=True)
        e.check_lockstep()
    return out


def _interleave(eng, seed, check):
    """40 steps of seeded shared-prefix arrivals against a tight pool,
    ``check(step)`` after each, then drain and flush.  Returns the streams."""
    rng = np.random.RandomState(seed)
    prefixes = [[int(x) for x in rng.randint(1, CFG.vocab_size, size=6)] for _ in range(3)]
    for i in range(40):
        if rng.uniform() < 0.6:
            k = int(rng.randint(len(prefixes)))
            suffix = [int(x) for x in rng.randint(1, CFG.vocab_size, size=2)]
            eng.submit(eng.make_request(prefixes[k] + suffix, int(rng.randint(1, 4))))
        eng.step()
        check(i)
    drain(eng)
    eng.step()  # flush the final releases
    check("drained")
    return {r.rid: [int(t) for t in r.tokens] for r in eng.done}


def _interleavings(model, mesh) -> list:
    """The invariant at every step at tp=2, the accounting equal to the tp=1
    engine's on the same script; then a teardown frees every page."""
    out = []
    kw = dict(n_pages=8, max_slots=2, prefill_batch=2, prefix_cache=True)
    for seed in (0, 1):
        states = []
        single = make_engine(model, **kw)
        ref = _interleave(single, seed, lambda i: states.append(
            {k: single.pool[k].numpy().copy() for k in POOL_KEYS}))
        eng = make_engine(model, tp=2, mesh=mesh, **kw)
        steps = [0]

        def check(i):
            assert_pool_invariants(eng)
            want = states.pop(0)
            for k in POOL_KEYS:
                np.testing.assert_array_equal(eng.pool[k].numpy(), want[k], err_msg=f"{i} {k}")
            steps[0] += 1

        streams = _interleave(eng, seed, check)
        evicted = eng.prefix.evict(eng.n_pages, set())
        pages = np.full((eng.n_pages,), -1, np.int32)
        pages[: len(evicted)] = evicted
        eng._pool_op(kv_pages.unref_pages, pages)
        out.append((streams == ref, steps[0], eng.prefix.held_pages,
                    int(eng.pool["refcount"].abs().sum()), bool(eng.pool["free"].all())))
    return out


def _stream_helpers(model, mesh) -> dict:
    axis = mesh.axis("model")
    plan = zero.stream_block_plan(model, 2)
    rows = zero.zero_stream_llama_params(model, mesh, "model")
    _, layers = zero._llama_leaves(model)
    bufs = zero.stream_layer_bufs(plan, rows.blocks)
    packed_once = all(torch.equal(a, b) for a, b in zip(bufs, rows.bufs))
    layer_ok = all(
        all(torch.equal(a, b) for a, (_, b) in zip(
            zero.stream_gather_layer(plan, [buf[i] for buf in bufs], axis), layers[i]))
        for i in range(CFG.n_layers))
    stack_ok = all(all(torch.equal(a, b) for a, (_, b) in zip(got, layer))
                   for got, layer in zip(zero.stream_gather_blocks(plan, rows.bufs, axis),
                                         layers))
    return {"rows": [[r.numpy() for r in layer] for layer in rows.blocks],
            "outer": [t.numpy() for t in (rows.embed, rows.ln_f, rows.unembed)],
            "paths": rows.paths, "layer_ok": layer_ok, "stack_ok": stack_ok,
            "packed_once": packed_once and rows.plan == plan}


def _sharing_ops(model, mesh) -> dict:
    """The sharing ops on a tp=2 engine's pool and a tp=1 one's, in place:
    the k/v keep the rank's heads, the accounting is the single card's."""
    out = {}
    for name, kw in (("tp2", dict(tp=2, mesh=mesh)), ("tp1", {})):
        e = make_engine(model, **kw)
        S, P = e.max_slots, e.pages_per_seq
        (ok,) = e._pool_op(kv_pages.reserve_pages, np.arange(1, dtype=np.int32),
                           np.zeros(1, np.int32), np.ones(1, bool))
        page0 = int(e.pool["page_table"][0, 0])
        e._pool_op(kv_pages.ref_pages, np.array([page0], np.int32))
        adopt = np.full((1, P), -1, np.int32)
        adopt[0, 0] = page0
        (ok2,) = e._pool_op(kv_pages.adopt_prefix, np.array([1], np.int32), adopt,
                            np.array([page0], np.int32))
        e._pool_op(kv_pages.truncate_to, np.zeros(S, np.int32), np.ones(S, bool))
        e._pool_op(kv_pages.unref_pages, np.array([page0], np.int32))
        out[name] = (bool(ok) and bool(ok2), tuple(e.pool["k"].shape), tuple(e.pool["v"].shape),
                     {k: e.pool[k].numpy().copy() for k in POOL_KEYS})
    return out


def _budgets(model, mesh) -> dict:
    out = {}
    for name, kw in (("dense", {}), ("tp2", dict(tp=2, mesh=mesh)),
                     ("stream", dict(tp=2, mesh=mesh, weight_stream=True)),
                     ("spec", dict(tp=2, mesh=mesh, spec_k=2))):
        e = make_engine(model, **kw)
        out[name] = (e.mem_budget_bytes(), e.mem_budget_bytes(per_chip=False))
    return out


def _ab(model, mesh) -> dict:
    trace = synth_trace(TrafficSpec(**driver.SMOKE_TRAFFIC, vocab_size=CFG.vocab_size))
    knobs = {**driver.engine_knobs(smoke=True), "tp": 2}
    out = {"resident": driver.tp_ab_compare(model, CFG, trace, knobs, mesh=mesh),
           "streamed": driver.tp_ab_compare(model, CFG, trace, {**knobs, "weight_stream": True},
                                            mesh=mesh)}
    # the wall clock: rank 0's readings drive both ranks' schedulers
    wall = driver._build_engine(model, CFG, knobs, mesh, clock="wall", trace_label=None)
    wall.run(synth_trace(TrafficSpec(seed=1, duration_s=0.5, rate_rps=8.0, profile="flat",
                                     vocab_size=CFG.vocab_size)))
    out["wall"] = {r.rid: list(r.tokens) for r in wall.done}
    return out


def _drift(model, mesh) -> str:
    """A rank whose counters differ from its peer's must raise."""
    e = make_engine(model, tp=2, mesh=mesh)
    serve_tokens(e, [REQ_B])
    e.check_lockstep()  # equal: no raise
    if mesh.rank == 1:
        e.generated_tokens += 1
    try:
        e.check_lockstep()
    except RuntimeError as err:
        return str(err)
    return ""


def serve_tp_rank(rdv):
    """One rank of the file's world: every case, results as numpy."""
    model = _model()
    with init_mesh(rdv, 1, model=2, device="cpu") as mesh:
        return {"index": mesh.axis("model").index,
                "programs": _programs(model, mesh), "engines": _engines(model, mesh),
                "interleavings": _interleavings(model, mesh),
                "stream": _stream_helpers(model, mesh), "sharing": _sharing_ops(model, mesh),
                "budgets": _budgets(model, mesh), "ab": _ab(model, mesh),
                "drift": _drift(model, mesh)}


def tp_generate_rank(rdv, cases):
    """One rank of ``tests/test_torch_decode.py``'s TP generate world: each
    case ``(cfg, params, prompt, max_new, shard_vocab, temperature, top_k,
    seed)`` through ``make_tp_generate`` on the rank's slices (the sampling
    generator seeded with ``seed``, None when greedy); tokens as numpy."""
    out = []
    with init_mesh(rdv, 1, model=2, device="cpu") as mesh:
        index = mesh.axis("model").index
        for cfg, params, prompt, max_new, sv, temperature, top_k, seed in cases:
            model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            ptp.load_tp_params(model, ptp.shard_tp_params(params, 2, index, shard_vocab=sv))
            gen = dm.make_tp_generate(cfg, mesh, max_new, shard_vocab=sv,
                                      temperature=temperature, top_k=top_k)
            key = None if seed is None else torch.Generator().manual_seed(seed)
            out.append(gen(model.requires_grad_(False), torch.from_numpy(prompt), key).numpy())
    return out


# ------------------------------------------------------------ references


def _jax_refs(model, devices8) -> dict:
    """JAX's TP bodies on the parity inputs (under shard_map over 2 CPU
    devices, as ``_tp_jit`` would put them), its stream layout and plan, and
    dense ``generate`` for the engine requests."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ddl25spring_tpu.models import decode as jdecode
    from ddl25spring_tpu.parallel import zero as jzero
    from ddl25spring_tpu.parallel.tp import shard_tp_params
    from ddl25spring_tpu.serve import engine as je
    from ddl25spring_tpu.serve import kv_pages as jkv
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.compat import shard_map
    from ddl25spring_tpu.utils.mesh import make_mesh

    jcfg = jconfig.LlamaConfig(**SIZES)
    jparams = jax.tree.map(jnp.asarray, llama.export_params(model))
    mesh = make_mesh(devices8[:2], model=2)
    pool_specs = je._tp_pool_specs("model")

    def prog(body, stream, n_extra):
        specs = je._tp_param_specs(jcfg, "model", stream)
        return jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, pool_specs) + (P(),) * n_extra,
                                 out_specs=(pool_specs, P(), P())))

    stack, plan = je._stream_layer_stack(jcfg, "model", 2)
    inner = je.make_prefill(jcfg, max_prompt_len=8, start=0, tp_axis="model")

    def streamed_prefill(params, pool, *rest):  # _tp_prefill_variant's streamed shell
        blocks = jzero.stream_gather_blocks(plan, params["blocks"], "model", 2)
        full = {**{k: v for k, v in params.items() if k != "blocks"},
                "blocks": je._tp_slice_block(blocks, "model", 2, stacked=True)}
        return inner(full, pool, *rest)

    params = {False: shard_tp_params(jparams, mesh, "model", shard_vocab=False),
              True: jzero.zero_stream_llama_params(jparams, mesh, "model")}
    key = jax.random.PRNGKey(0)

    def fresh_pool():
        return jkv.init_page_pool(jcfg, n_pages=16, page_len=4, max_slots=2, pages_per_seq=4)

    refs = {}
    for name, stream in (("resident", False), ("streamed", True)):
        tick = prog(je.make_decode_tick(jcfg, tp_axis="model",
                                        layer_stack=stack if stream else None), stream, 2)
        pre0 = prog(streamed_prefill if stream else je.make_prefill(
            jcfg, max_prompt_len=8, start=0, tp_axis="model"), stream, 5)
        got, first, _ = pre0(params[stream], fresh_pool(), PROMPTS, *PREFILLS[0], SLOT_IDS, key)
        p2, new, _ = tick(params[stream], got, first, key)
        refs[name] = {"prefill0": (np.asarray(first), jax.tree.map(np.asarray, got)),
                      "tick": (np.asarray(new), jax.tree.map(np.asarray, p2))}
    pre4 = prog(je.make_prefill(jcfg, max_prompt_len=8, start=4, tp_axis="model"), False, 5)
    got, first, _ = pre4(params[False], fresh_pool(), PROMPTS, *PREFILLS[4], SLOT_IDS, key)
    refs["resident"]["prefill4"] = (np.asarray(first), jax.tree.map(np.asarray, got))
    refs["plan"] = jzero.stream_block_plan(
        jax.eval_shape(lambda: jparams)["blocks"], 2)
    refs["rows"] = jax.tree.map(np.asarray, params[True]["blocks"])
    refs["generate"] = [
        np.asarray(jax.jit(lambda p, t, n=n: jdecode.generate(p, t, jcfg, n))(
            jparams, jnp.asarray([prompt])))[0].tolist()
        for prompt, n in (REQ_A, REQ_B, (SHARED, 6))]
    return refs


def _margins(model, prompt, tokens) -> float:
    seq = torch.tensor([prompt + tokens])
    top2 = llama.llama_forward(model, seq, CFG)[0, len(prompt) - 1:-1].topk(2, -1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    """The 2 ranks' results, the JAX references (computed meanwhile) and the
    bench's run through its entry point."""
    from ddl25spring_tpu_torch import bench

    d = tmp_path_factory.mktemp("serve_tp")
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn, serve_tp_rank, 2, timeout=300,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        cli = pool.submit(bench.main, [*BENCH_ARGS, "--obs-dir", str(d / "obs"),
                                       "--perf-ledger", str(d / "ledger.jsonl")])
        refs = _jax_refs(_model(), devices8)
        return ranks.result(), refs, (cli.result(), d)


@pytest.fixture(scope="module")
def model():
    return _model()


# ------------------------------------------------------------ programs


@pytest.mark.parametrize("program", ["prefill0", "tick", "prefill4"])
@pytest.mark.parametrize("weights", ["resident", "streamed"])
def test_tp_programs_match_the_jax_bodies(runs, program, weights):
    """Tokens equal JAX's; each rank's k/v slice is the JAX device shard's
    heads within ``KV_BAND``; the accounting equals JAX's exactly."""
    ranks, refs, _ = runs
    # the JAX reference streams the start-0 prefill only: a streamed start-4
    # prefill is held to its resident one
    want_tok, want_pool = refs["resident" if program == "prefill4" else weights][program]
    for r in ranks:
        got_tok, got_pool = r["programs"][weights][program]
        np.testing.assert_array_equal(got_tok, want_tok)
        i = r["index"]
        for k in ("k", "v"):
            np.testing.assert_allclose(got_pool[k], want_pool[k][:, :, :, i:i + 1], rtol=0,
                                       atol=KV_BAND, err_msg=k)
        for k in POOL_KEYS:
            np.testing.assert_array_equal(got_pool[k], want_pool[k], err_msg=k)


def test_streamed_programs_equal_resident_bitwise(runs):
    """A gathered layer is the original bits, so the streamed tick's logits
    and every streamed pool equal the resident ones exactly."""
    ranks, _, _ = runs
    for r in ranks:
        res, st = r["programs"]["resident"], r["programs"]["streamed"]
        assert np.array_equal(res["logits"], st["logits"])
        for program in ("prefill0", "tick", "prefill4"):
            assert np.array_equal(res[program][0], st[program][0])
            for k, t in res[program][1].items():
                assert np.array_equal(t, st[program][1][k]), (program, k)
    np.testing.assert_array_equal(ranks[0]["programs"]["resident"]["logits"],
                                  ranks[1]["programs"]["resident"]["logits"])


# ------------------------------------------------------------ engines


def test_tp2_engines_match_single_card_and_jax(runs, model):
    """fp32 greedy decode through the head-split pool, resident and streamed,
    equals the single-card engine and JAX ``generate`` token for token (A
    crosses a page boundary, B is admitted mid-flight), each token clear of
    the top-2 margin."""
    ranks, refs, _ = runs
    want = refs["generate"][:2]
    for (prompt, _), toks in zip((REQ_A, REQ_B), want):
        assert _margins(model, prompt, toks) > MARGIN
    for r in ranks:
        e = r["engines"]
        assert e["single"] == want
        assert e["resident"] == want and e["streamed"] == want
        assert e["resident ok"] and e["streamed ok"] and e["single ok"]
        assert e["resident heads"] == e["streamed heads"] == CFG.num_heads // 2
        assert e["resident graphs"] is False and e["streamed graphs"] is False
        m_res, m_st = e["resident metrics"], e["streamed metrics"]
        assert m_res["tp"] == m_st["tp"] == 2 and m_res["n_chips"] == 1
        assert m_res["weight_stream"] is False and m_st["weight_stream"] is True
        # the JAX pins of the same shapes (tests/test_serve_tp.py)
        assert m_res["param_bytes_per_chip"] == 24896
        assert m_st["param_bytes_per_chip"] == 24768


def test_tp2_prefix_cache_hit_and_spec_give_the_single_card_streams(runs, model):
    ranks, refs, _ = runs
    assert _margins(model, SHARED, refs["generate"][2]) > MARGIN
    for r in ranks:
        e = r["engines"]
        toks2, hits, saved = e["prefix", 2]
        assert toks2 == e["prefix", 1][0] == [refs["generate"][2]] * 2
        assert hits >= 1 and saved > 0 and (hits, saved) == e["prefix", 1][1:]
        spec2, spec1 = e["spec", 2], e["spec", 1]
        assert spec2 == spec1 and spec2[0] == refs["generate"][:2] and spec2[2] == 0
        assert e["spec heads"] == (1, 1)


def test_tp2_sampled_streams_stay_in_lockstep(runs):
    """Temperature 0.8: both ranks sample the same tokens (the logits are the
    same bits after the sums, the generators seeded alike; ``check_lockstep``
    passed in the ranks), the single-card engine's with the same seed."""
    ranks, _, _ = runs
    assert ranks[0]["engines"]["sampled", 2] == ranks[1]["engines"]["sampled", 2]
    for r in ranks:
        assert r["engines"]["sampled", 2] == r["engines"]["sampled", 1]
        assert r["engines"]["sampled", 2] != r["engines"]["single"]  # not the greedy stream


def test_tp2_refcount_pool_invariant_under_interleavings(runs):
    """Seeded shared-prefix traffic against a tight pool (evictions, copies,
    backpressure, mid-flight completions): the invariant holds after every
    step, the accounting equals the single-card engine's, the streams too,
    and a teardown frees every page."""
    ranks, _, _ = runs
    for r in ranks:
        for same, steps, held, refs, free in r["interleavings"]:
            assert same and steps > 40 and held == 0 and refs == 0 and free


def test_ranks_that_drift_apart_raise(runs):
    ranks, _, _ = runs
    assert all("drifted apart" in r["drift"] and "generated_tokens" in r["drift"]
               for r in ranks)


# ------------------------------------------------------------ stream helpers


def test_stream_block_plan_is_jax_plan(runs, model):
    _, refs, _ = runs
    plan, want = zero.stream_block_plan(model, 2), refs["plan"]
    assert [list(b) for b in plan.buckets] == [list(b) for b in want.buckets]
    assert list(plan.sizes) == list(want.sizes)
    with pytest.raises(ValueError, match="bucket_bytes"):
        zero.stream_block_plan(model, 2, bucket_bytes=0)


def test_zero_stream_params_are_jax_shards_bitwise(runs, model):
    ranks, refs, _ = runs
    from ddl25spring_tpu_torch.parallel.bucketing import flatten

    want = dict(flatten(refs["rows"]))
    outer = [t.detach().numpy() for t in (model.embed, model.ln_f, model.unembed)]
    for r in ranks:
        s, i = r["stream"], r["index"]
        assert s["paths"] == tuple(want)
        for layer, rows in enumerate(s["rows"]):
            for path, row in zip(s["paths"], rows):
                assert np.array_equal(row, want[path][layer, i:i + 1]), (layer, path)
        assert all(np.array_equal(a, b) for a, b in zip(s["outer"], outer))
    assert zero.stream_param_specs(model)["blocks"]["wq"] == (None, "model")
    assert zero.stream_param_specs(model)["embed"] == ()


def test_stream_gathers_give_back_the_leaves_bitwise(runs):
    ranks, _, _ = runs
    assert all(r["stream"]["layer_ok"] and r["stream"]["stack_ok"] and r["stream"]["packed_once"]
               for r in ranks)


# ------------------------------------------------------------ JAX twins


def test_sharing_ops_preserve_the_head_split(runs):
    """reserve / ref / adopt (with a copy) / truncate / unref on the tp=2
    pool: k/v keep the rank's heads, the accounting is the single card's
    and the same on both ranks."""
    ranks, _, _ = runs
    H = CFG.num_heads
    for r in ranks:
        ok, k_shape, v_shape, acct = r["sharing"]["tp2"]
        ok1, k1, _, acct1 = r["sharing"]["tp1"]
        assert ok and ok1
        assert k_shape[KV_POOL_HEAD_DIM] == v_shape[KV_POOL_HEAD_DIM] == H // 2
        assert k1[KV_POOL_HEAD_DIM] == H and k_shape[:3] == k1[:3]
        for k in POOL_KEYS:
            np.testing.assert_array_equal(acct[k], acct1[k], err_msg=k)
            np.testing.assert_array_equal(acct[k], ranks[0]["sharing"]["tp2"][3][k])


def test_tp_unset_keeps_the_exact_single_device_build(model, monkeypatch):
    monkeypatch.delenv("DDL25_SERVE_TP", raising=False)
    monkeypatch.delenv("DDL25_SERVE_WEIGHT_STREAM", raising=False)
    knobs = driver.engine_knobs(smoke=True)
    assert knobs["tp"] == 1 and knobs["weight_stream"] is False
    eng = make_engine(model)
    assert eng.tp == 1 and eng.mesh is None and eng.axis is None
    tick, prefill, release = eng_mod._compiled_programs(CFG, max_prompt_len=8, temperature=0.0,
                                                        sentinel=None)
    assert eng._tick.body is tick
    assert eng._prefill_programs[0].body is prefill
    assert eng._release.body is release
    monkeypatch.setenv("DDL25_SERVE_TP", "2")
    monkeypatch.setenv("DDL25_SERVE_WEIGHT_STREAM", "1")
    knobs = driver.engine_knobs(smoke=True)
    assert knobs["tp"] == 2 and knobs["weight_stream"] is True


def test_tp_constructor_validation(model):
    with pytest.raises(ValueError, match="tp=0"):
        make_engine(model, tp=0)
    with pytest.raises(ValueError, match="requires tp > 1"):
        make_engine(model, tp=1, weight_stream=True)
    with pytest.raises(ValueError, match="spec_k"):
        make_engine(model, tp=2, mesh=fake_mesh(2), weight_stream=True, spec_k=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_engine(model, tp=4, mesh=fake_mesh(4))  # 2 heads over 4 ranks
    with pytest.raises(ValueError, match="ranks"):
        make_engine(model, tp=16, mesh=fake_mesh(2))  # the mesh has 2
    with pytest.raises(ValueError, match="ranks"):
        make_engine(model, tp=2)  # no mesh at all
    with pytest.raises(ValueError, match="not graphed"):
        make_engine(model, tp=2, mesh=fake_mesh(2), graphs=True)


def test_tp_mem_budget_divides_per_chip_only(runs):
    """The per-rank bill strictly shrinks at tp=2 and again under streaming;
    the global bill is the same across the three builds."""
    ranks, _, _ = runs
    for r in ranks:
        b = r["budgets"]
        assert b["tp2"][0] < b["dense"][0] and b["stream"][0] < b["tp2"][0]
        assert b["dense"][0] == b["dense"][1]
        assert b["tp2"][1] == b["stream"][1] == b["dense"][1]
        assert b["spec"][0] < b["spec"][1]


# ------------------------------------------------------------ driver + bench


@pytest.mark.parametrize("weights", ["resident", "streamed"])
def test_driver_tp_ab_gates_green(runs, weights):
    from tools import serve_report

    ranks, _, _ = runs
    for r in ranks:
        tab = r["ab"][weights]
        assert tab["tp"] == 2 and tab["tokens_match"] is True and tab["compared_requests"] > 0
        assert tab["budget_shrunk"] is True and tab["first_mismatch"] is None
        assert (tab["sharded"]["mem_budget_bytes_per_chip"]
                < tab["dense"]["mem_budget_bytes_per_chip"])
        assert tab["sharded"]["generated_tokens"] == tab["dense"]["generated_tokens"]
        assert tab["sharded"]["weight_stream"] is (weights == "streamed")
        assert serve_report.check_tp([{"tp_ab": tab}]) == []
        assert serve_report.check_tp([{"tp_ab": driver._tp_ab_cell(tab)}]) == []
        assert any("token-for-token" in f
                   for f in serve_report.check_tp([{"tp_ab": dict(tab, tokens_match=False)}]))
        assert any("budget_shrunk" in f
                   for f in serve_report.check_tp([{"tp_ab": dict(tab, budget_shrunk=False)}]))
    assert ranks[0]["ab"] == ranks[1]["ab"]
    assert ranks[0]["ab"]["wall"] and ranks[0]["ab"]["wall"] == ranks[1]["ab"]["wall"]


def test_tp_ab_first_mismatch_names_request_position_and_gap(model):
    """Where the arms' streams differ, the A/B says where: the lowest
    request id that differs, the first position there, both tokens, and the
    dense forward's top-2 gap at that position; None where they agree."""
    dense = SimpleNamespace(done=[SimpleNamespace(rid=r, prompt=p)
                                  for r, p in ((0, REQ_A[0]), (1, REQ_B[0]), (2, [4, 4]))])
    streams = {"sharded": {0: [1, 2, 3], 1: [4, 5, 6], 2: [7, 8]},
               "dense": {0: [1, 2, 3], 1: [4, 9, 6], 2: [7, 9]}}
    got = driver._first_mismatch(model, CFG, dense, streams, {0, 1, 2})
    logits = llama.llama_forward(model, torch.tensor([REQ_B[0] + [4]]), CFG)[0, -1]
    top2 = logits.topk(2).values
    assert got == {"rid": 1, "position": 1, "sharded": 5, "dense": 9,
                   "top2_gap": float(top2[0] - top2[1])}
    streams["dense"][1] = [4, 5, 6, 3]  # the same prefix, one arm longer
    got = driver._first_mismatch(model, CFG, dense, streams, {0, 1})
    assert (got["rid"], got["position"], got["sharded"], got["dense"]) == (1, 3, None, 3)
    assert driver._first_mismatch(model, CFG, dense, streams, {0}) is None


def test_bench_serve_tp2_then_check_tp(runs):
    """``bench --serve --smoke --serve-tp 2 --device cpu`` through the entry
    point (the other A/Bs skipped; rank 0's record printed, its files
    written), then ``serve_report --check-tp`` exits 0."""
    from tools import serve_report

    _, _, (rec, d) = runs
    cell = rec["telemetry"]["serve"]
    assert rec["tp"] == 2 and cell["tp"] == 2 and cell["key"]["tp"] == 2
    assert cell["tp_ab"]["tokens_match"] and cell["tp_ab"]["budget_shrunk"]
    assert cell["completed"] == cell["admitted"] > 0 and cell["pool_leak"]["ok"]
    assert serve_report.main([str(d / "obs"), "--ledger", str(d / "ledger.jsonl"),
                              "--check-tp"]) == 0


def test_obs_report_renders_the_tp_lines(runs):
    """The report's Serving section prints the per-chip pool and parameter
    bytes, the tp line and the tp A/B verdict: from the raw serve.json shape
    (the arms nested under sharded/dense), as the JAX test feeds it, and
    from the 2-rank bench's own serve.json."""
    from ddl25spring_tpu_torch.obs.report import format_report, summarize_run

    summary = {
        "run_dir": "/tmp/x",
        "serve": {
            "key": {"model": "tiny", "tp": 2},
            "requests": {"submitted": 2, "admitted": 2, "rejected": 0,
                         "rejected_by_reason": {}, "completed": 2},
            "ramp": {
                "admitted": 2, "rejected": 0, "completed": 2,
                "tokens_per_sec_per_chip": 10.0,
                "page_pool_peak_pages": 4, "page_pool_pages": 16,
                "page_pool_peak_occupancy": 0.25,
                "pool_bytes_per_chip": 8868,
                "param_bytes_per_chip": 24896,
                "tp": 2, "weight_stream": False,
                "queue_depth_max": 1, "pool_ok_failures": 0,
            },
            "tp_ab": {
                "tp": 2, "budget_s": 1.0, "tokens_match": True,
                "tp_tokens_at_budget": 8, "dense_tokens_at_budget": 8,
                "budget_shrunk": True, "compared_requests": 2,
                "sharded": {"mem_budget_bytes_per_chip": 33722},
                "dense": {"mem_budget_bytes_per_chip": 58810},
            },
        },
    }
    text = format_report(summary)
    assert "8.7 KiB/chip" in text
    assert "tp 2" in text and "params 24.3 KiB/chip" in text
    assert "tp A/B (tp=2)" in text
    assert "shrunk True" in text
    assert "32.9 vs 57.4 KiB" in text

    _, _, (rec, d) = runs
    cell = rec["telemetry"]["serve"]
    text = format_report(summarize_run(str(d / "obs")))
    assert f"{cell['pool_bytes_per_chip'] / 1024:.1f} KiB/chip" in text
    assert f"params {cell['param_bytes_per_chip'] / 1024:.1f} KiB/chip" in text
    assert "tp A/B (tp=2)" in text and "shrunk True" in text


def test_tp_mem_record_bands_the_rank_and_passes_mem_report(runs):
    """The 2-rank bench's rank 0 writes the ``mem`` record keyed by the mesh
    ``{"replicas": 1, "tp": 2}`` and banded against its own bill (this rank's
    shard and pool) plus the dense copy of the weights the A/B keeps, and
    ``tools/mem_report.py --check`` passes it, from the run dir and the
    ledger."""
    from tools import mem_report

    _, _, (rec, d) = runs
    mem = rec["telemetry"]["mem"]
    assert mem["enabled"] and mem["samples"] > 0 and mem["leaked_pages"] == 0
    doc = json.loads((d / "obs" / "mem.json").read_text())
    assert doc["mesh"] == {"replicas": 1, "tp": 2} and doc["strategy"] == "serve/tiny"
    tab = rec["telemetry"]["serve"]["tp_ab"]
    dense = sum(p.numel() * p.element_size() for p in _model().parameters())
    band = doc["budget"]
    # the CPU keeps no cuBLAS workspace: the bill is the shard's and the copy
    assert band["budget_bytes"] == tab["tp_mem_budget_bytes_per_chip"] + dense
    assert band["dense_copy_bytes"] == dense and band["blas_workspaces"] == 0
    assert band["floor_bytes"] >= 0 and band["ratio_on_bill"] == band["ratio"]
    assert band["within_band"] and band["source"] == "serve_static_accounting"
    assert mem_report.main(["--run", str(d / "obs"), "--check"]) == 0
    assert mem_report.main(["--ledger", str(d / "ledger.jsonl"), "--check"]) == 0
