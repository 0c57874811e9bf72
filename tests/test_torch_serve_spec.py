"""The port's speculative decoding (``ddl25spring_tpu_torch/serve/spec.py``
and the spec half of the engine and ``serve/driver.py``) on the CPU: the twins of the
JAX package's ``tests/test_serve_spec.py`` (but its two compile-signature
pins, which wait for the ``describe()`` registry of A12), held to the JAX
engine where the two must agree.

The load-bearing pins:

- **spec == dense, exactly**: greedy speculative decode (drafts, the verify
  pass's argmaxes, rollback through ``truncate_to``) emits the port's dense
  ``generate`` stream token for token, across accept-all, reject-first (a
  random drafter), mid-draft rejection, EOS inside a draft and windows
  straddling page boundaries;
- **pool invariants on both pools** at every step of a seeded interleaving
  (prefix cache on, the host/device page mirror asserted), none leaked;
- **the JAX engine's numbers**: on one seeded ``tiny-deep`` trace with
  ``spec_k=2`` on the virtual clock, the port's per-request tokens, accept
  histogram, acceptance rate and ``spec_ab_compare`` numbers are JAX's
  exactly, every compared token clearing a top-2 margin of ``MARGIN``.

The weights are the port's seeded ``Llama`` exported as the JAX pytree.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.serve import driver as jdriver  # noqa: E402
from ddl25spring_tpu.serve import spec as jspec  # noqa: E402
from ddl25spring_tpu_torch.analysis import host_sanitizer  # noqa: E402
from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.serve import driver, kv_pages  # noqa: E402
from ddl25spring_tpu_torch.serve import spec as spec_mod  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace  # noqa: E402
from ddl25spring_tpu_torch.utils.config import replace  # noqa: E402

CFG = driver.serve_model("tiny")
DEEP_CFG = driver.serve_model("tiny-deep")
K = 3  # the engine tests' k, as JAX's (the A/B runs the bench's 2)
MARGIN = 1e-4


def _model(cfg, seed=0):
    m = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return m.requires_grad_(False)


@pytest.fixture(scope="module")
def params():
    return _model(CFG)


@pytest.fixture(scope="module")
def deep():
    return _model(DEEP_CFG)


def dense_greedy(params, prompt, max_new, cfg=CFG):
    return dm.generate(params, torch.tensor([prompt], dtype=torch.int32), cfg,
                       max_new).numpy()[0].tolist()


def assert_margins(params, cfg, prompt, tokens):
    """The port's full forward picks each token by a top-2 margin above
    ``MARGIN`` (so a JAX-vs-port flip would be a defect, not a tie)."""
    seq = torch.tensor([list(prompt) + list(tokens)])
    top2 = llama.llama_forward(params, seq, cfg)[0, len(prompt) - 1:-1].topk(2, dim=-1)
    assert top2.indices[:, 0].tolist() == list(tokens)
    assert float((top2.values[:, 0] - top2.values[:, 1]).min()) > MARGIN


def make_engine(params, cfg=CFG, **kw):
    kw.setdefault("page_len", 4)
    kw.setdefault("n_pages", 16)
    kw.setdefault("max_slots", 2)
    kw.setdefault("pages_per_seq", 4)
    kw.setdefault("prefill_batch", 1)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("clock", "virtual")
    kw.setdefault("spec_k", K)
    return ServeEngine(params, cfg, **kw)


def drain(eng, max_steps: int = 500):
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


def used(pool) -> int:
    return int((~pool["free"]).sum())


def assert_draft_pool_invariants(eng):
    """No cache claims drafter pages: ``refcount`` is exactly the page-table
    reference count, ``free`` the zero-refcount set."""
    p = {k: v.numpy() for k, v in eng.draft_pool.items() if k != "k" and k != "v"}
    refcount, free, table = p["refcount"], p["free"], p["page_table"]
    n_pages = free.shape[0]
    assert (free == (refcount == 0)).all() and (refcount >= 0).all()
    table_refs = np.bincount(table[table >= 0].ravel(), minlength=n_pages)[:n_pages]
    assert (refcount == table_refs).all(), (refcount.tolist(), table_refs.tolist())


# ------------------------------------------------- truncate_to units


def test_truncate_to_frees_rolled_back_pages():
    pool = kv_pages.init_page_pool(CFG, n_pages=6, page_len=4, max_slots=2, pages_per_seq=4)
    for pos in (0, 4, 8):  # slot 0 takes entries 0..2
        pool, ok = kv_pages.reserve_pages(pool, torch.tensor([0, 1]),
                                          torch.tensor([pos, 0], dtype=torch.int32),
                                          torch.tensor([True, False]))
        assert bool(ok)
    pool = {**pool, "seq_len": torch.tensor([9, 0], dtype=torch.int32),
            "active": torch.tensor([True, False])}
    assert used(pool) == 3
    # back to 5 written positions: entry 2 (start 8) drops, entry 1 (holds
    # position 4) is the kept frontier page
    pool2 = kv_pages.truncate_to(pool, torch.tensor([5, 0]), torch.tensor([True, False]))
    assert used(pool2) == 2
    table = pool2["page_table"]
    assert table[0, 0] >= 0 and table[0, 1] >= 0 and table[0, 2] == -1
    assert int(pool2["seq_len"][0]) == 5
    assert torch.equal(pool2["page_table"][1], pool["page_table"][1])  # unmasked slot
    # a new_len at or above the frontier is a no-op (never grows)
    pool3 = kv_pages.truncate_to(pool, torch.tensor([12, 0]), torch.tensor([True, False]))
    assert used(pool3) == 3 and int(pool3["seq_len"][0]) == 9


def test_truncate_to_decrements_shared_pages():
    """A truncated entry on a shared page (refcount 2) drops one reference
    and the page survives, as under release_slots."""
    pool = kv_pages.init_page_pool(CFG, n_pages=4, page_len=4, max_slots=2, pages_per_seq=2)
    pool, ok = kv_pages.reserve_pages(pool, torch.tensor([0, 1]),
                                      torch.tensor([0, 0], dtype=torch.int32),
                                      torch.tensor([True, False]))
    page = int(pool["page_table"][0, 0])
    pool = kv_pages.ref_pages(pool, torch.tensor([page, -1]))  # the cache's reference
    pool = kv_pages.truncate_to(pool, torch.tensor([0, 0]), torch.tensor([True, False]))
    assert int(pool["refcount"][page]) == 1 and not bool(pool["free"][page])
    assert (pool["page_table"][0] == -1).all()


# ------------------------------------------------- the drafter


def test_early_exit_drafter_shapes_and_ratio(params):
    dp, dcfg = spec_mod.early_exit_drafter(params, CFG, 1)
    assert dcfg.n_layers == 1 and dcfg.dmodel == CFG.dmodel
    assert len(dp.blocks) == 1 and dp.blocks[0] is params.blocks[0]
    # shared tensors, not copies
    assert dp.embed is params.embed and dp.unembed is params.unembed
    r = spec_mod.flop_ratio(dp, params)
    assert 0.0 < r < 1.0
    full, _ = spec_mod.early_exit_drafter(params, CFG, CFG.n_layers)
    assert spec_mod.flop_ratio(full, params) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="draft_layers=0"):
        spec_mod.early_exit_drafter(params, CFG, 0)
    with pytest.raises(ValueError, match="draft_layers=3"):
        spec_mod.early_exit_drafter(params, CFG, 3)
    dp8, dcfg8 = spec_mod.early_exit_drafter(params, CFG, 1, draft_dim=8)
    assert dcfg8.dmodel == 8 and dcfg8.ffn_dim == 32
    assert dp8.embed.shape == (CFG.vocab_size, 8)
    assert dp8.blocks[0].wq.shape == (8, 8) and dp8.blocks[0].w_down.shape == (32, 8)
    assert dp8.unembed.shape == (8, CFG.vocab_size)
    assert dp8.embed.data_ptr() == params.embed.data_ptr()  # a view
    assert spec_mod.flop_ratio(dp8, params) < r
    with pytest.raises(ValueError, match="head_dim"):
        spec_mod.early_exit_drafter(params, CFG, 1, draft_dim=6)
    # the JAX drafter over the same weights: the same leaves, the same ratios
    jp = llama.export_params(params)
    for layers, dim in ((1, None), (2, None), (1, 8)):
        ours, _ = spec_mod.early_exit_drafter(params, CFG, layers, draft_dim=dim)
        theirs, _ = jspec.early_exit_drafter(jp, CFG, layers, draft_dim=dim)
        assert spec_mod.flop_ratio(ours, params) == jspec.flop_ratio(theirs, jp)
        mine = llama._param_tree(ours)
        for key in ("embed", "ln_f", "unembed"):
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]))
        for key, leaf in theirs["blocks"].items():
            np.testing.assert_array_equal(np.stack([t.numpy() for t in mine["blocks"][key]]),
                                          np.asarray(leaf))


def test_spec_refuses_sampling_and_a_drafter_without_its_cfg(params):
    with pytest.raises(ValueError, match="greedy-only"):
        make_engine(params, temperature=0.7)
    with pytest.raises(ValueError, match="draft_cfg"):
        make_engine(params, draft_params=_model(replace(CFG, n_layers=1), seed=9))
    with pytest.raises(ValueError, match="steps=5"):
        spec_mod.make_draft(CFG, k=3, steps=5)
    moe = replace(CFG, n_experts=2)
    for build in (lambda: spec_mod.make_draft(moe, k=2), lambda: spec_mod.make_verify(moe, k=2)):
        with pytest.raises(NotImplementedError, match="dense-FFN"):
            build()
    with pytest.raises(NotImplementedError, match="A12"):
        spec_mod.describe(None, "verify")


# --------------------------------------- bitwise spec == sequential


@pytest.fixture(scope="module")
def spec_engine_run(params):
    """One drained spec engine over prompts chosen to exercise the whole
    acceptance surface, shared by the bitwise/coverage/pool pins."""
    reqs = [
        ([5, 9, 11, 3], 9),   # crosses the page_len=4 boundary twice
        ([7, 2, 8], 6),
        ([1, 2], 4),
        ([3, 3, 3, 3, 3], 11),  # fills its last page exactly
    ]
    eng = make_engine(params)
    eng.warmup()  # the draft_k1 capture on the engine's own pools leaves no state
    assert eng.generated_tokens == 0 and used(eng.pool) == 0 and used(eng.draft_pool) == 0
    for prompt, max_new in reqs:
        r = eng.make_request(prompt, max_new)
        assert eng.submit(r) is None
        drain(eng)
    return eng, reqs


def test_spec_decode_is_bitwise_dense_across_page_boundaries(params, spec_engine_run):
    """THE pin: greedy speculative decode emits the dense fp32 stream token
    for token, with draft windows straddling page boundaries."""
    eng, reqs = spec_engine_run
    for (prompt, max_new), req in zip(reqs, eng.done):
        assert req.tokens == dense_greedy(params, prompt, max_new), prompt
    assert eng.pool_ok_failures == 0
    assert eng.generated_tokens == sum(m for _, m in reqs)


def test_spec_round_coverage_and_counters(spec_engine_run):
    """The accept histogram covers reject-first, a mid-draft rejection and a
    full accept (whose next round takes the (k+1)-step draft), and the
    counters reconcile."""
    eng, _ = spec_engine_run
    counts = eng.spec_accept_counts
    assert counts.get(0, 0) > 0 and any(0 < a < K for a in counts) and counts.get(K, 0) > 0
    assert eng._draft_steps > K * eng._spec_rounds  # some round ran k + 1 steps
    m = eng.metrics()
    assert m["acceptance_rate"] > 0
    assert (m["draft_tokens_accepted"] + m["draft_tokens_rejected"]
            == m["spec"]["draft_tokens_proposed"] == K * m["spec"]["rounds"])
    assert m["spec"]["enabled"] and m["spec"]["k"] == K
    assert 0.0 < m["spec"]["flop_ratio"] < 1.0 and m["config"]["spec_k"] == K
    # both pools and the drafter's parameters are in the bill
    assert m["pool_bytes_per_chip"] == sum(
        t.numel() * t.element_size() for pool in (eng.pool, eng.draft_pool)
        for t in pool.values())
    assert eng.mem_budget_bytes() == m["pool_bytes_per_chip"] + m["param_bytes_per_chip"]


def test_spec_pools_drain_clean(spec_engine_run):
    eng, _ = spec_engine_run
    eng.step()  # flush the final releases
    assert used(eng.pool) == 0 and used(eng.draft_pool) == 0
    assert_draft_pool_invariants(eng)
    leak = eng.mem_leak_check()
    assert leak["ok"] and leak["draft"]["ok"]


def test_reject_first_path_with_a_random_drafter(params):
    """Correctness never depends on agreement: a drafter of independent
    random weights nearly always loses its first draft, and the stream is
    still the dense one."""
    dcfg = replace(CFG, n_layers=1)
    eng = make_engine(params, draft_params=_model(dcfg, seed=99), draft_cfg=dcfg)
    prompt, max_new = [5, 9, 11, 3], 9
    r = eng.make_request(prompt, max_new)
    assert eng.submit(r) is None
    drain(eng)
    assert r.tokens == dense_greedy(params, prompt, max_new)
    assert eng.spec_accept_counts.get(0, 0) > 0
    assert eng.metrics()["acceptance_rate"] < 0.5 and eng.pool_ok_failures == 0


def test_eos_inside_draft_stops_and_frees(params):
    prompt = [5, 9, 11, 3]
    dense = dense_greedy(params, prompt, 9)
    eng = make_engine(params, eos_id=dense[3])  # mid-stream, mid-window
    req = eng.make_request(prompt, 9)
    eng.submit(req)
    drain(eng)
    assert req.tokens == dense[:4]
    eng.step()  # flush the release
    assert used(eng.pool) == 0 and used(eng.draft_pool) == 0
    assert not eng.pool["active"].any() and not eng.draft_pool["active"].any()


def test_spec_mid_batch_admission_isolated(params):
    a_prompt, a_new = [5, 9, 11, 3], 9
    b_prompt, b_new = [7, 2, 8], 6
    eng = make_engine(params)
    ra = eng.make_request(a_prompt, a_new)
    assert eng.submit(ra) is None
    eng.step()  # its prefill and first round (two full accepts would finish it here)
    assert ra.done_t is None and len(ra.tokens) >= 2
    rb = eng.make_request(b_prompt, b_new)
    assert eng.submit(rb) is None
    eng.step()
    assert rb.admitted_t is not None
    drain(eng)
    assert ra.tokens == dense_greedy(params, a_prompt, a_new)
    assert rb.tokens == dense_greedy(params, b_prompt, b_new)
    assert eng.pool_ok_failures == 0


def test_spec_max_new_one_completes_in_prefill(params):
    """A request done at its first token never reaches a round; its drafter
    slot releases with the target's."""
    eng = make_engine(params)
    r = eng.make_request([7, 2], 1)
    assert eng.submit(r) is None
    eng.step()
    assert r.tokens == dense_greedy(params, [7, 2], 1) and r.done_t is not None
    assert eng._spec_rounds == 0
    eng.step()
    assert used(eng.draft_pool) == 0


def test_draft_writes_bounded_at_the_table_edge(params):
    """Two requests ending exactly at the page table's last position run
    together: an unmasked drafter write at the edge would fail the whole
    batched reserve and corrupt the other slot."""
    eng = make_engine(params, prefill_batch=2)
    ra = eng.make_request([9, 7, 5, 1], 12)  # 4 + 12 = 16 = the table's edge
    rb = eng.make_request([2, 4], 14)
    assert eng.submit(ra) is None and eng.submit(rb) is None
    drain(eng)
    assert ra.tokens == dense_greedy(params, [9, 7, 5, 1], 12)
    assert rb.tokens == dense_greedy(params, [2, 4], 14)
    assert eng.pool_ok_failures == 0


def test_spec_admission_covers_the_shareless_drafter_pool(params):
    """The prefix cache discounts the TARGET bill only; spec admission bills
    the full worst case, or a tight pool would exhaust the drafter's."""
    eng = make_engine(params, n_pages=7, prefill_batch=2, prefix_cache=True)
    prompt = [11, 12, 13, 14, 15, 16, 17, 18]
    for _ in range(2):  # the second is a radix hit
        r = eng.make_request(prompt, 8)
        assert eng.submit(r) is None
        drain(eng)
        assert r.tokens == dense_greedy(params, prompt, 8)
    assert eng.pool_ok_failures == 0 and eng.prefix.hits >= 1
    assert_draft_pool_invariants(eng)


# ------------------------------------------ pool-invariant sweep


def test_pool_invariants_under_spec_interleavings(params):
    """Seeded shared-prefix traffic against tight pools with speculation and
    the prefix cache on: the invariants hold on BOTH pools and the host
    mirror equals the device's at every step; teardown frees every page."""
    from test_torch_serve_prefix import assert_pool_invariants

    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        eng = make_engine(params, n_pages=8, prefill_batch=2, prefix_cache=True)
        prefixes = [[int(x) for x in rng.randint(1, CFG.vocab_size, size=6)]
                    for _ in range(3)]
        for _ in range(40):
            if rng.uniform() < 0.6:
                suffix = [int(x) for x in rng.randint(1, CFG.vocab_size, size=2)]
                eng.submit(eng.make_request(prefixes[int(rng.randint(len(prefixes)))] + suffix,
                                            int(rng.randint(1, 5))))
            eng.step()
            assert_pool_invariants(eng)
            assert_draft_pool_invariants(eng)
            host_sanitizer.check_serve_mirror(eng)
        drain(eng)
        eng.step()
        assert_pool_invariants(eng)
        assert_draft_pool_invariants(eng)
        evicted = eng.prefix.evict(eng.n_pages, set())
        if evicted:
            pages = np.full((eng.n_pages,), -1, np.int32)
            pages[: len(evicted)] = evicted
            eng._pool_op(kv_pages.unref_pages, pages)
        assert bool(eng.pool["free"].all()) and bool(eng.draft_pool["free"].all()), seed
        assert eng.pool_ok_failures == 0, seed


# ------------------------------------- the deterministic win, against JAX

DEEP_KNOBS = dict(page_len=4, n_pages=16, max_slots=2, prefill_batch=2, max_prompt_len=8,
                  max_queue=64, token_budget=None, eos_id=None, prefix_cache=False,
                  spec_k=2, draft_layers=1)


def _deep_trace():
    return synth_trace(TrafficSpec(seed=0, duration_s=2.0, rate_rps=6.0, profile="shared",
                                   vocab_size=DEEP_CFG.vocab_size, max_new_jitter=2))


def _spec_ab(module, params, monkeypatch):
    """``module.spec_ab_compare`` on the seeded tiny-deep trace, with the
    engines its arms built."""
    built = []
    build = module._build_engine

    def keep(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    monkeypatch.setattr(module, "_build_engine", keep)
    sab = module.spec_ab_compare(params, DEEP_CFG, _deep_trace(), DEEP_KNOBS)
    return sab, dict(zip(("spec", "nospec"), built))


@pytest.fixture(scope="module")
def deep_ab(deep):
    """The port's and JAX's spec A/B on the tiny-deep trace (k=2), once."""
    jp = jax.tree.map(jnp.asarray, llama.export_params(deep))
    with pytest.MonkeyPatch.context() as mp:
        return _spec_ab(driver, deep, mp), _spec_ab(jdriver, jp, mp)


def test_spec_ab_strict_win_on_the_deep_config(deep_ab):
    """On tiny-deep (a 1-of-6-layer drafter, FLOP ratio ~0.20) the spec arm
    strictly beats sequential decode on the virtual clock at equal admission
    budget, with matching streams, and ``check_spec_ab`` passes the cell in
    both shapes."""
    from tools import serve_report

    (sab, _), _ = deep_ab
    assert sab["compared_requests"] >= 4
    assert sab["advantage_tokens"] > 0
    assert sab["spec"]["tokens_per_sec_per_chip"] > sab["nospec"]["tokens_per_sec_per_chip"]
    assert sab["spec"]["drain_wall_s"] < sab["nospec"]["drain_wall_s"]
    assert sab["tokens_match"] is True and sab["spec"]["acceptance_rate"] > 0
    assert serve_report.check_spec_ab([{"key": {"spec": True},
                                        "spec_ab": driver._spec_ab_cell(sab)}]) == []
    assert serve_report.check_spec_ab([{"key": {"spec": True}, "spec_ab": sab}]) == []


def test_spec_engine_and_ab_equal_jax(deep, deep_ab):
    """The same trace through the port's and JAX's A/B: the spec arms' per-
    request tokens, accept histograms, token timelines and metrics, and
    every A/B number, equal; each token clears the top-2 margin."""
    (sab, engines), (jsab, jengines) = deep_ab
    eng, ref = engines["spec"], jengines["spec"]
    streams = {r.rid: r.tokens for r in eng.done}
    assert streams == {r.rid: [int(t) for t in r.tokens] for r in ref.done}
    for r in eng.done:
        assert_margins(deep, DEEP_CFG, r.prompt, r.tokens)
    assert eng.spec_accept_counts == ref.spec_accept_counts
    assert eng.token_log == ref.token_log
    m, jm = eng.metrics(), ref.metrics()
    for key in ("acceptance_rate", "draft_tokens_accepted", "draft_tokens_rejected", "spec",
                "ticks", "prefills", "wall_s", "ttft_s_p50", "ttft_s_p95",
                "page_pool_peak_pages", "generated_tokens"):
        assert m[key] == jm[key], key
    for key in ("budget_s", "spec_tokens_at_budget", "nospec_tokens_at_budget",
                "advantage_tokens", "advantage_frac", "tokens_match", "compared_requests",
                "tick_s"):
        assert sab[key] == jsab[key], key
    assert sab["spec"] == jsab["spec"] and sab["nospec"] == jsab["nospec"]


# --------------------------------------------------- report gates


def test_check_spec_ab_fails_on_defects():
    from tools import serve_report

    assert serve_report.check_spec_ab([{"key": {"spec": True}}]) != []  # no cell
    bad = {"key": {"spec": True}, "spec_ab": driver._spec_ab_cell({
        "budget_s": 1.0, "spec_tokens_at_budget": 10, "nospec_tokens_at_budget": 12,
        "advantage_tokens": -2, "tokens_match": False, "compared_requests": 3,
        "spec": {"tokens_per_sec_per_chip": 5.0, "acceptance_rate": 0.0,
                 "draft_tokens_accepted": 0},
        "nospec": {"tokens_per_sec_per_chip": 6.0},
    })}
    fails = serve_report.check_spec_ab([bad])
    assert len(fails) == 4 and any("accepted" in f for f in fails)
    # tokens_match over ZERO compared requests is vacuous
    vacuous = {"key": {"spec": True}, "spec_ab": {
        **bad["spec_ab"], "advantage_tokens": 2, "draft_tokens_accepted": 9,
        "acceptance_rate": 0.5, "spec_tokens_per_sec_per_chip": 7.0, "tokens_match": True,
        "compared_requests": 0}}
    fails = serve_report.check_spec_ab([vacuous])
    assert len(fails) == 1 and "compared request" in fails[0]


def test_check_group_gates_acceptance_rate_on_spec_runs():
    from tools import serve_report

    def row(acc, spec=True):
        return driver.ledger_record({
            "ts": 1.0, "git_sha": "abc", "host": "h",
            "key": {"spec": True, "profile": "shared"} if spec else {"profile": "shared"},
            "ramp": {"tokens_per_sec_per_chip": 10.0, "ttft_s_p95": 0.1,
                     "prefix_hit_rate": 0.8, "acceptance_rate": acc}})

    assert serve_report.check_group([row(0.6), row(0.5)]) == []
    fails = serve_report.check_group([row(0.6), row(0.6), row(0.1)])
    assert any("acceptance_rate" in f for f in fails)
    assert serve_report.check_group([row(0.6, False), row(0.6, False), row(0.0, False)]) == []


def test_ledger_and_cells_carry_the_spec_contract():
    record = {
        "record": "serve", "ts": 1.0, "git_sha": "abc", "host": "h",
        "key": {"spec": True, "spec_k": K, "draft_layers": 1},
        "requests": 3,
        "ramp": {"tokens_per_sec_per_chip": 10.0, "acceptance_rate": 0.6,
                 "draft_tokens_accepted": 12, "draft_tokens_rejected": 8,
                 "spec": {"enabled": True, "k": K, "rounds": 7}},
        "spec_ab": {
            "budget_s": 2.0, "spec_tokens_at_budget": 30, "nospec_tokens_at_budget": 25,
            "advantage_tokens": 5, "advantage_frac": 0.2, "tokens_match": True,
            "compared_requests": 3,
            "spec": {"tokens_per_sec_per_chip": 12.0, "acceptance_rate": 0.6,
                     "draft_tokens_accepted": 12, "draft_tokens_rejected": 8},
            "nospec": {"tokens_per_sec_per_chip": 10.0},
        },
    }
    row = driver.ledger_record(record)
    assert (row["acceptance_rate"], row["draft_tokens_accepted"],
            row["draft_tokens_rejected"]) == (0.6, 12, 8)
    assert row["spec_ab"]["advantage_tokens"] == 5
    assert row["spec_ab"]["spec_tokens_per_sec_per_chip"] == 12.0
    assert row["spec_ab"]["acceptance_rate"] == 0.6
    assert row["spec_ab"] == jdriver._spec_ab_cell(record["spec_ab"])
    cell = driver.serve_cell(record)
    assert cell["acceptance_rate"] == 0.6 and cell["spec"]["enabled"] is True
    assert cell["spec_ab"]["tokens_match"] is True and cell["spec_ab"]["compared_requests"] == 3


def test_bench_serve_with_spec_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``DDL25_SERVE_SPEC=1 bench --serve`` through the entry point: the spec
    ramp, the spec A/B with matching streams, the key, the flag that skips
    it, and ``serve_report --check-spec-ab`` reading the row."""
    from ddl25spring_tpu_torch import bench, obs
    from tools import serve_report

    monkeypatch.setenv("DDL25_SERVE_SPEC", "1")
    knobs = driver.engine_knobs(smoke=True)
    assert (knobs["spec_k"], knobs["draft_layers"]) == (2, 1)
    led = str(tmp_path / "l.jsonl")
    prev = obs.get_recorder()
    try:
        with obs.scoped(False):
            bench.main(["--serve", "--smoke", "--serve-model", "tiny-deep", "--device", "cpu",
                        "--obs-dir", str(tmp_path), "--perf-ledger", led,
                        "--serve-duration", "0.5", "--serve-rate", "20", "--no-serve-ab",
                        "--no-serve-prefix-ab"])
    finally:
        obs.set_recorder(prev)
        obs.timeline.configure(None)
    tel = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["telemetry"]["serve"]
    assert tel["spec"]["enabled"] and tel["key"]["spec"] and tel["key"]["spec_k"] == 2
    assert tel["spec_ab"]["tokens_match"] and tel["spec_ab"]["compared_requests"] > 0
    assert tel["pool_leak"]["ok"] and tel["pool_leak"]["draft"]["ok"]
    rows = serve_report.read_ledger(led)
    assert rows[-1]["spec_ab"] == tel["spec_ab"]
    timeline = [json.loads(line) for line in open(tmp_path / "timeline.jsonl")]
    assert any(e.get("kind") == "serve_spec_round" for e in timeline)
    rec = driver.run_serve_bench(smoke=True, model="tiny-deep", duration_s=0.5, rate_rps=20,
                                 skip_ab=True, skip_prefix_ab=True, skip_spec_ab=True,
                                 device="cpu")
    assert "spec_ab" not in rec and rec["ramp"]["spec"]["enabled"]


# -------------------------------------------------------- traffic


def test_shared_profile_max_new_jitter_is_seeded():
    base = TrafficSpec(seed=5, duration_s=3.0, rate_rps=8.0, profile="shared")
    jit = TrafficSpec(seed=5, duration_s=3.0, rate_rps=8.0, profile="shared", max_new_jitter=2)
    t0, t1 = synth_trace(base), synth_trace(jit)
    assert len(t0) == len(t1) > 4
    assert synth_trace(base) == t0
    assert {r["max_new"] for r in t1} != {r["max_new"] for r in t0}
    for a, b in zip(t0, t1):
        assert a["prompt"] == b["prompt"] and a["t"] == b["t"]
        assert abs(a["max_new"] - b["max_new"]) <= 2 and b["max_new"] >= 1
    assert synth_trace(jit) == t1
