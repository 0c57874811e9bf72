"""The port's radix prefix cache on the CPU: refcounted page sharing, copy on
write, LRU eviction and cached == cold — the twins of the JAX package's
``tests/test_serve_prefix.py`` (but its ``tp=2`` case, a reference failure,
and its ``serve_report`` gate unit tests, which test the tool alone).

The load-bearing pins:

- **prefix-cached == cold**: fp32 greedy decode through a radix hit (a
  shared full page + a copy-on-write partial page) equals the port's dense
  ``generate`` token for token, across an eviction-then-readmit too;
- **the pool against JAX's, step by step**: a seeded fuzz of
  allocate/adopt(COW)/release/evict against a tight pool keeps the pool
  invariant exact at every scheduler step, and the port's pool state (page
  tables, refcounts, free mask, lengths, active slots) and radix tree equal
  the JAX engine's after every step of the same script;
- **the saved work is countable**, and the cached engine strictly beats the
  cold one on the virtual clock with the identical tokens.

Tolerances: tokens and pool states exact.
"""

from __future__ import annotations

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu.serve import driver as jdriver  # noqa: E402
from ddl25spring_tpu.serve import engine as jengine  # noqa: E402
from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.serve import driver, kv_pages  # noqa: E402
from ddl25spring_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from ddl25spring_tpu_torch.serve.prefix import PrefixCache  # noqa: E402
from ddl25spring_tpu_torch.serve.traffic import PROFILES, TrafficSpec, synth_trace  # noqa: E402

CFG = driver.serve_model("tiny")
POOL_KEYS = ("page_table", "seq_len", "active", "free", "refcount")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: its tensors are tiny, and torch's
    thread pool beside JAX's (and the suite's other files) costs more than
    it parallelizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    m = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return m.requires_grad_(False)


def dense_greedy(params, prompt: list[int], max_new: int) -> list[int]:
    return dm.generate(params, torch.tensor([prompt], dtype=torch.int32), CFG,
                       max_new).numpy()[0].tolist()


ENGINE_KW = dict(page_len=4, n_pages=16, max_slots=2, pages_per_seq=4, prefill_batch=1,
                 max_prompt_len=8, clock="virtual", prefix_cache=True)


def make_engine(params, **kw):
    return ServeEngine(params, CFG, **{**ENGINE_KW, **kw})


def drain(eng, max_steps: int = 500):
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


def serve_tokens(eng, requests):
    """Submit sequentially (each drains before the next arrives) and return
    per-request token lists."""
    out = []
    for prompt, max_new in requests:
        r = eng.make_request(prompt, max_new)
        assert eng.submit(r) is None
        drain(eng)
        out.append(list(r.tokens))
    return out


def _np(pool):
    return {k: np.asarray(pool[k]) for k in POOL_KEYS}


def assert_pool_invariants(eng):
    """``free`` is exactly the zero-refcount set, and every reference is
    accounted: one per page-table entry holding the page plus one iff the
    cache holds a node on it."""
    p = _np(eng.pool)
    refcount, free, table = p["refcount"], p["free"], p["page_table"]
    n_pages = free.shape[0]
    assert (free == (refcount == 0)).all() and (refcount >= 0).all()
    table_refs = np.bincount(table[table >= 0].ravel(), minlength=n_pages)[:n_pages]
    cache_pages = eng.prefix.pages()
    assert len(cache_pages) == len(set(cache_pages))
    cache_refs = np.zeros((n_pages,), np.int64)
    cache_refs[cache_pages] = 1
    assert (refcount == table_refs + cache_refs).all(), (refcount, table_refs, cache_pages)


# ------------------------------------------------ kv_pages refcount ops


def _tiny_pool(n_pages=6, page_len=4, max_slots=3, pages_per_seq=4):
    return kv_pages.init_page_pool(CFG, n_pages=n_pages, page_len=page_len,
                                   max_slots=max_slots, pages_per_seq=pages_per_seq)


def _reserve_first(pool, need):
    return kv_pages.reserve_pages(pool, torch.arange(3), torch.zeros(3, dtype=torch.int32),
                                  torch.tensor(need))


def test_adopt_prefix_shares_by_reference_and_cow_copies_bitwise():
    pool, ok = _reserve_first(_tiny_pool(), [True, False, False])
    assert bool(ok)
    src = int(pool["page_table"][0, 0])
    pool["k"][src] = torch.randn(pool["k"].shape[1:], generator=torch.Generator().manual_seed(7))
    pool["v"][src] = pool["k"][src] + 1.0
    pool, ok = kv_pages.adopt_prefix(pool, torch.tensor([1, 2, -1]),
                                     torch.full((3, 4), -1, dtype=torch.int32),
                                     torch.tensor([src, src, -1]))
    assert bool(ok)
    c1, c2 = int(pool["page_table"][1, 0]), int(pool["page_table"][2, 0])
    # two adopters of one source each get their OWN copy
    assert len({src, c1, c2}) == 3
    for name in ("k", "v"):
        assert torch.equal(pool[name][c1], pool[name][src])
        assert torch.equal(pool[name][c2], pool[name][src])
    rc = pool["refcount"]
    assert rc[src] == 1 and rc[c1] == 1 and rc[c2] == 1


def test_adopt_prefix_by_reference_bumps_refcount():
    pool, _ = _reserve_first(_tiny_pool(), [True, False, False])
    page = int(pool["page_table"][0, 0])
    adopt = torch.full((3, 4), -1, dtype=torch.int32)
    adopt[1, 0] = page
    pool, ok = kv_pages.adopt_prefix(pool, torch.tensor([-1, 1, -1]), adopt,
                                     torch.full((3,), -1, dtype=torch.int32))
    assert bool(ok) and pool["refcount"][page] == 2
    # releasing ONE owner keeps the page resident; the second frees it
    pool = kv_pages.release_slots(pool, torch.tensor([True, False, False]))
    assert pool["refcount"][page] == 1 and not bool(pool["free"][page])
    pool = kv_pages.release_slots(pool, torch.tensor([False, True, False]))
    assert pool["refcount"][page] == 0 and bool(pool["free"][page])


def test_adopt_prefix_all_or_nothing_when_cow_cannot_fit():
    pool, ok = _reserve_first(_tiny_pool(n_pages=2), [True, True, False])
    assert bool(ok) and int(pool["free"].sum()) == 0
    before = {k: pool[k].clone() for k in ("refcount", "page_table")}
    src = int(before["page_table"][0, 0])
    adopt = torch.full((3, 4), -1, dtype=torch.int32)
    adopt[2, 0] = src
    pool, ok = kv_pages.adopt_prefix(pool, torch.tensor([-1, -1, 2]), adopt,
                                     torch.tensor([-1, -1, src]))
    # the copy cannot fit: NOTHING adopted, not even the by-reference entry
    assert not bool(ok)
    for k, t in before.items():
        assert torch.equal(pool[k], t), k


def test_ref_unref_roundtrip_and_pad_rows():
    pool, _ = _reserve_first(_tiny_pool(), [True, False, False])
    page = int(pool["page_table"][0, 0])
    pool = kv_pages.ref_pages(pool, torch.tensor([page, -1, -1]))
    assert pool["refcount"][page] == 2
    pool = kv_pages.release_slots(pool, torch.tensor([True, False, False]))
    assert not bool(pool["free"][page])  # the cache reference keeps it
    pool = kv_pages.unref_pages(pool, torch.tensor([page, -1, -1]))
    assert bool(pool["free"][page]) and int(pool["refcount"].sum()) == 0


def test_truncate_to_drops_pages_past_the_frontier():
    pool = _tiny_pool()
    for pos in (0, 4, 8):
        pool, ok = kv_pages.reserve_pages(pool, torch.tensor([0]), torch.tensor([pos]),
                                          torch.tensor([True]))
        assert bool(ok)
    pool = {**pool, "seq_len": torch.tensor([10, 0, 0], dtype=torch.int32)}
    pool = kv_pages.ref_pages(pool, pool["page_table"][0, 2:3])  # a shared last page
    pool = kv_pages.truncate_to(pool, torch.tensor([5, 0, 0], dtype=torch.int32),
                                torch.tensor([True, False, False]))
    assert pool["page_table"][0].tolist()[:2] != [-1, -1]
    assert pool["page_table"][0, 2] == -1 and pool["seq_len"][0] == 5
    assert int(kv_pages.used_pages(pool)) == 3  # the shared page survives


# ------------------------------------------------------- radix tree


def test_radix_match_always_leaves_a_suffix_token():
    c = PrefixCache(page_len=4)
    prompt = [1, 2, 3, 4, 5, 6]
    assert c.match(prompt).matched == 0
    c.insert(prompt, [10, 11, -1, -1])
    m = c.match(prompt)
    assert m.matched == 4 and m.pages == [10] and m.cow_src == -1
    m = c.match(prompt + [7, 8])
    assert m.matched == 6 and m.pages == [10] and m.cow_src == 11


def test_radix_insert_claims_each_page_once():
    c = PrefixCache(page_len=4)
    prompt = [1, 2, 3, 4, 5, 6]
    assert c.insert(prompt, [10, 11, -1, -1]) == [10, 11]
    assert c.held_pages == 2 and sorted(c.pages()) == [10, 11]
    assert c.insert(prompt, [20, 21, -1, -1]) == []
    assert c.insert([1, 2, 3, 4, 9], [20, 22, -1, -1]) == [22]
    assert c.held_pages == 3


def test_radix_evicts_lru_leaves_first_and_respects_pins():
    c = PrefixCache(page_len=2)
    c.insert([1, 2, 3], [10, 11, -1])
    c.insert([5, 6, 7], [20, 21, -1])
    c.match([1, 2, 3])  # touch the first chain: the second is now LRU
    assert c.evictable_pages(set()) == 4
    assert c.evictable_pages({21}) == 2
    # 21 pinned -> 20 not evictable -> the first chain goes, leaf first
    assert c.evict(2, {21}) == [11, 10]
    assert c.held_pages == 2 and c.evictions == 2
    assert c.insert([1, 2, 3], [30, 31, -1]) == [30, 31]


# ------------------------------------------- cached == cold, bitwise

PREFIX = [11, 12, 13, 14, 15, 16]  # full page (4) + partial tail (2)


def test_prefix_cached_decode_matches_dense_across_cow_boundary(params):
    reqs = [(PREFIX, 3), (PREFIX + [31, 32], 4), (PREFIX + [41, 42], 4)]
    eng = make_engine(params)
    eng.warm_prefill_starts((4, len(PREFIX), 0, 99))  # touches no engine state
    assert bool(eng.pool["free"].all()) and eng.admitted == 0 and eng._prefills == 0
    got = serve_tokens(eng, reqs)
    for (prompt, max_new), tokens in zip(reqs, got):
        assert tokens == dense_greedy(params, prompt, max_new), prompt
    s = eng.prefix.stats()
    assert s["hits"] == 2 and s["lookups"] == 3
    assert s["hit_tokens"] == 2 * len(PREFIX)
    # SAVED counts the skipped positions: the page-aligned floor (4 of 6)
    assert eng.prefill_tokens_saved == 2 * 4 and eng.prefill_flops_saved > 0
    assert eng.pool_ok_failures == 0
    assert_pool_invariants(eng)


def test_prefix_cache_survives_eviction_then_readmit(params):
    eng = make_engine(params, n_pages=6, max_slots=1)
    others = [([51, 52, 53, 54, 55, 56], 2), ([61, 62, 63, 64, 65, 66], 2)]
    reqs = [(PREFIX, 2)] + others + [(PREFIX, 2), (PREFIX, 2)]
    got = serve_tokens(eng, reqs)
    for (prompt, max_new), tokens in zip(reqs, got):
        assert tokens == dense_greedy(params, prompt, max_new), prompt
    s = eng.prefix.stats()
    assert s["evictions"] > 0 and s["hits"] >= 1
    assert eng.pool_ok_failures == 0
    assert_pool_invariants(eng)


def _interleave(eng, seed, check):
    """The seeded script: 40 steps of shared-prefix arrivals against a tight
    pool, ``check(step)`` after each; then drain, flush, and evict the whole
    cache.  Returns the per-request token streams."""
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


def test_refcount_pool_invariant_and_jax_pool_states_under_interleavings(params):
    """Random shared-prefix traffic against a TIGHT pool (evictions, copies,
    backpressure and mid-flight completions interleave): the invariant holds
    at every step, the port's pool and radix tree equal the JAX engine's
    after every step of the same script, and a teardown frees every page."""
    jparams = jax.tree.map(jnp.asarray, llama.export_params(params))
    kw = dict(ENGINE_KW, n_pages=8, max_slots=2, prefill_batch=2)
    for seed in (0, 1, 2):
        ref = jengine.ServeEngine(jparams, jdriver.serve_model("tiny"), **kw)
        states = []
        ref_streams = _interleave(
            ref, seed, lambda i: states.append((_np(ref.pool), sorted(ref.prefix.pages()))))
        eng = make_engine(params, **kw)

        def check(i):
            assert_pool_invariants(eng)
            want, want_pages = states.pop(0)
            got = _np(eng.pool)
            for k in POOL_KEYS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{seed} {i} {k}")
            assert sorted(eng.prefix.pages()) == want_pages, (seed, i)

        assert _interleave(eng, seed, check) == ref_streams
        assert eng.prefix.stats() == ref.prefix.stats()
        evicted = eng.prefix.evict(eng.n_pages, set())
        pages = np.full((eng.n_pages,), -1, np.int32)
        pages[: len(evicted)] = evicted
        eng.pool = kv_pages.unref_pages(eng.pool, torch.from_numpy(pages))
        assert eng.prefix.held_pages == 0
        assert int(eng.pool["refcount"].abs().sum()) == 0 and bool(eng.pool["free"].all())


def test_cached_engine_strictly_faster_on_the_virtual_clock(params):
    trace = synth_trace(TrafficSpec(seed=0, duration_s=2.0, rate_rps=6.0, profile="shared",
                                    vocab_size=CFG.vocab_size))
    assert len(trace) >= 4
    walls, streams = {}, {}
    for arm, on in (("cached", True), ("cold", False)):
        eng = make_engine(params, prefix_cache=on, prefill_batch=2)
        m = eng.run(trace, max_steps=5_000)
        walls[arm] = m["wall_s"]
        streams[arm] = {r.rid: list(r.tokens) for r in eng.done}
        if on:
            assert m["prefix_hit_rate"] > 0
            assert m["prefill_tokens_saved"] > 0 and m["prefill_flops_saved"] > 0
        else:
            assert m["prefix_hit_rate"] is None and m["prefill_tokens_saved"] == 0
    assert walls["cached"] < walls["cold"], walls
    common = set(streams["cached"]) & set(streams["cold"])
    assert common and all(streams["cached"][r] == streams["cold"][r] for r in common)


def test_driver_prefix_ab_gates_green(params):
    from tools import serve_report

    knobs = driver.engine_knobs(smoke=True)
    assert knobs["prefix_cache"] is True
    trace = synth_trace(TrafficSpec(seed=0, duration_s=2.0, rate_rps=6.0, profile="shared",
                                    vocab_size=CFG.vocab_size))
    pab = driver.prefix_ab_compare(params, CFG, trace, knobs)
    assert pab["advantage_tokens"] > 0 and pab["tokens_match"] is True
    assert pab["cached"]["prefill_tokens_saved"] > 0
    assert (pab["cached"]["tokens_per_sec_per_chip"]
            > pab["cold"]["tokens_per_sec_per_chip"])
    row = {"key": {"profile": "shared"}, "prefix_hit_rate": pab["cached"]["prefix_hit_rate"],
           "prefix_ab": driver._prefix_ab_cell(pab)}
    assert serve_report.check_prefix_ab([row]) == []
    doc = {"key": {"profile": "shared"},
           "ramp": {"prefix_hit_rate": pab["cached"]["prefix_hit_rate"]}, "prefix_ab": pab}
    assert serve_report.check_prefix_ab([doc]) == []


# -------------------------------------------------------- traffic


def test_shared_profile_shape_and_determinism():
    spec = TrafficSpec(seed=5, duration_s=3.0, rate_rps=8.0, profile="shared")
    trace = synth_trace(spec)
    assert len(trace) > 4
    plen = spec.shared_prefix_len + spec.shared_suffix_len
    assert all(len(r["prompt"]) == plen for r in trace)
    heads = {tuple(r["prompt"][: spec.shared_prefix_len]) for r in trace}
    assert 1 <= len(heads) <= spec.shared_prefixes
    assert synth_trace(spec) == trace
    assert synth_trace(TrafficSpec(seed=6, duration_s=3.0, rate_rps=8.0,
                                   profile="shared")) != trace


def test_traffic_profiles_replay_across_process_restarts():
    """Every profile replays the IDENTICAL trace for the same seed in a fresh
    process (which imports no torch to do it)."""
    specs = [{"seed": 3, "duration_s": 2.0, "rate_rps": 8.0, "profile": p} for p in PROFILES]
    local = [synth_trace(TrafficSpec(**s)) for s in specs]
    code = (
        "import json, sys\n"
        "from ddl25spring_tpu_torch.serve.traffic import TrafficSpec, synth_trace\n"
        "specs = json.loads(sys.argv[1])\n"
        "print(json.dumps([synth_trace(TrafficSpec(**s)) for s in specs]))\n"
        "assert 'torch' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code, json.dumps(specs)],
                       capture_output=True, text=True, check=True)
    assert json.loads(r.stdout) == local
