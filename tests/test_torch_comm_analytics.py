"""The training strategies' ``describe()`` registry and collective signatures
(:mod:`ddl25spring_tpu_torch.obs.comm_analytics`), twins of
``tests/test_xla_analytics.py``'s training-signature tests (:121-143,
:264-512).

All 16 training strategies run in ONE spawned world of 4 gloo ranks on the
CPU (the ``(1, 2)`` strategies on a 2-rank grid inside it), one step each,
recorded; meanwhile this process compiles the same strategies in JAX
(``compile_strategy``, the HLO inventory).  Each port strategy's per-kind
totals (executions, result bytes) equal JAX's for every strategy that
compiles on this jax, except the kinds and fields its describe lists in
``meta["differs_from_jax"]`` (each with its reason in the describe's
docstring).  ``dp-overlap`` and ``zero1-overlap`` do not compile here (JAX's
custom-VJP typing); JAX's own pin for them is "the sync strategy's traffic",
and the port is held to the JAX sync strategy's inventory instead."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.obs import comm_analytics as ca  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402

NAMES = list(ca.STRATEGIES)
# JAX compiles these on jax 0.9.0; the two overlap variants fail its
# custom-VJP typing (ROADMAP C, "Reference failures") and are held to the
# sync strategy's JAX inventory, which JAX's own tests pin them to
SYNC_TWIN = {"dp-overlap": "dp", "zero1-overlap": "zero1"}
VARIANTS = {"zero3-llama": ("zero3", {"workload": "llama"}),
            "zero3-llama-per-leaf": ("zero3", {"workload": "llama", "bucketed": False})}


@pytest.fixture(scope="module")
def world(devices8):
    """Every rank's reports, and JAX's compiled inventories, computed
    meanwhile (the compiles are the slow part: ~28 s of the file's ~32)."""
    from ddl25spring_tpu.obs import xla_analytics as xa

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(ca.run_in_world, None, "cpu", VARIANTS, 300)
        jax = {name: xa.compile_strategy(name, lint=False)
               for name in NAMES if name not in SYNC_TWIN}
        return ranks.result(), jax


def _rank0(ranks, name):
    return ranks[0][name]


def _count(r, kind):
    return r["collectives"]["totals"].get(kind, {}).get("count", 0)


def _payload(r, kind):
    return r["collectives"]["totals"].get(kind, {}).get("result_bytes", 0)


def test_all_sixteen_training_strategies_resolve_and_hold(world):
    """Every training strategy resolves through ``describe_strategy``, runs
    one step on its default mesh, and its signature holds on every rank of
    its grid; on the CPU the memory budget is named as not judged and
    donation as not applicable, nothing passes silently."""
    ranks, _ = world
    assert len(NAMES) == 16 and ca.WORLD == 4
    for name in NAMES:
        reps = [r[name] for r in ranks if r[name] is not None]
        want = 1
        for s in ca.STRATEGIES[name]["default_mesh"]:
            want *= s
        assert len(reps) == want, name
        for r in reps:
            assert r["signature_violations"] == [], (name, r["rank"], r["signature_violations"])
            assert r["memory"]["peak_bytes"] is None
            assert r["memory"]["budget_bytes"] == ca.budget_bytes(name)
            assert any(n.startswith("memory: not judged") for n in r["not_judged"])
            assert ca.NOT_APPLICABLE_DONATION in r["not_judged"]
            assert r["lowered"] == "train_step"


@pytest.mark.parametrize("name", NAMES)
def test_per_kind_totals_equal_the_jax_inventory(world, name):
    """The port's per-kind totals on rank 0 equal JAX's compiled inventory,
    kind by kind, field by field, but for the fields ``differs_from_jax``
    names ("absent": the kind is on one side only)."""
    ranks, jax = world
    r = _rank0(ranks, name)
    ref = jax[SYNC_TWIN.get(name, name)]
    assert "error" not in ref, ref.get("error")
    differs = r["meta"]["differs_from_jax"]
    if name in SYNC_TWIN:  # the port's overlap variant issues its sync twin's traffic
        differs = _rank0(ranks, SYNC_TWIN[name])["meta"]["differs_from_jax"]
    mine, theirs = r["collectives"]["totals"], ref["collectives"]["totals"]
    for kind in sorted(set(mine) | set(theirs)):
        fields = differs.get(kind, ())
        if "absent" in fields:
            assert (kind in mine) != (kind in theirs), (name, kind)
            continue
        assert kind in mine and kind in theirs, (name, kind, mine, theirs)
        if "count" not in fields:
            assert mine[kind]["count"] == theirs[kind]["count"], (name, kind)
        if "bytes" not in fields:
            assert mine[kind]["result_bytes"] == theirs[kind]["result_bytes"], (name, kind)
    # every listed kind really differs (a stale entry would hide a match)
    for kind, fields in differs.items():
        if "absent" in fields:
            continue
        assert any(mine[kind][f2] != theirs[kind][f1] for f1, f2 in
                   (("count", "count"), ("result_bytes", "result_bytes"))
                   if (f1 == "count" and "count" in fields)
                   or (f1 == "result_bytes" and "bytes" in fields)), (name, kind)


def test_dp_signature_one_allreduce_per_bucket_and_nothing_else(world):
    r = _rank0(world[0], "dp")
    grad = r["meta"]["grad_bytes"]
    assert grad <= _payload(r, "all-reduce") <= grad + 256
    big = [o for o in r["collectives"]["ops"] if o["kind"] == "all-reduce"
           and o["result_bytes"] > 64]
    assert sum(o["count"] for o in big) == r["meta"]["n_buckets"] == 3
    for kind in ("all-gather", "reduce-scatter", "collective-permute", "all-to-all"):
        assert _count(r, kind) == 0
    assert all(o["axes"] == ["data"] for o in r["collectives"]["ops"])


def test_dp_overlap_signature_matches_dp_with_backward_issue(world):
    r, sync = _rank0(world[0], "dp-overlap"), _rank0(world[0], "dp")
    assert r["meta"]["overlap"] is True and r["meta"]["bucket_bytes"] == sync["meta"]["bucket_bytes"]
    assert _payload(r, "all-reduce") == _payload(sync, "all-reduce")
    big = [o for o in r["collectives"]["ops"] if o["kind"] == "all-reduce"
           and o["result_bytes"] > 64]
    assert sum(o["count"] for o in big) == r["meta"]["n_buckets"]


def test_zero3_signature_bucketed_gathers_and_scatters(world):
    """The byte unit, pinned: an all-gather's result is the whole gathered
    tensor (the padded parameters), a reduce-scatter's one rank's shard."""
    r = _rank0(world[0], "zero3")
    n_buckets, padded, n = r["meta"]["n_buckets"], r["meta"]["padded_param_bytes"], r["mesh"]["data"]
    assert n_buckets < r["meta"]["n_param_leaves"]
    assert _count(r, "all-gather") == n_buckets and _payload(r, "all-gather") == padded
    assert _count(r, "reduce-scatter") == n_buckets
    assert _payload(r, "reduce-scatter") == padded // n
    assert _payload(r, "all-reduce") <= 64
    for o in r["collectives"]["ops"]:
        assert o["wire_bytes"] == ca.wire_bytes(o["kind"], o["result_bytes"], o["group_size"])


def test_zero3_overlap_signature_matches_zero3(world):
    r, sync = _rank0(world[0], "zero3-overlap"), _rank0(world[0], "zero3")
    assert r["meta"]["overlap"] is True
    for kind in ("all-gather", "reduce-scatter"):
        assert _count(r, kind) == _count(sync, kind)
        assert _payload(r, kind) == _payload(sync, kind)


def test_zero_stage1_vs_stage2_collective_distinction(world):
    r1, r2 = _rank0(world[0], "zero1"), _rank0(world[0], "zero2")
    padded = r1["meta"]["padded_param_bytes"]
    assert _payload(r1, "all-reduce") >= padded and _count(r1, "reduce-scatter") == 0
    assert _count(r2, "reduce-scatter") == r2["meta"]["n_buckets"]
    assert _payload(r2, "all-reduce") <= 64
    for r in (r1, r2):
        assert _payload(r, "all-gather") == padded
        assert _count(r, "all-gather") == r["meta"]["n_buckets"]


def test_zero3_bucketing_collapses_llama_launches(world):
    bucketed, per_leaf = _rank0(world[0], "zero3-llama"), _rank0(world[0], "zero3-llama-per-leaf")
    assert bucketed["signature_violations"] == per_leaf["signature_violations"] == []
    n_leaves, n_buckets = per_leaf["meta"]["n_param_leaves"], bucketed["meta"]["n_buckets"]
    assert n_buckets < n_leaves
    for kind in ("all-gather", "reduce-scatter"):
        assert _count(per_leaf, kind) == n_leaves and _count(bucketed, kind) == n_buckets
        assert _payload(bucketed, kind) == _payload(per_leaf, kind)


def test_zero3_prefetch_gathers_each_layer_once(world):
    r = _rank0(world[0], "zero3-prefetch")
    L, n_lb, n_ob = r["meta"]["n_layers"], r["meta"]["n_layer_buckets"], r["meta"]["n_outer_buckets"]
    assert _count(r, "all-gather") == n_lb * L + n_ob
    assert _count(r, "reduce-scatter") >= n_lb * (L - 1)
    assert _payload(r, "all-reduce") <= 64


@pytest.mark.parametrize("name", ["pipeline", "het_pipeline"])
def test_pipeline_signatures_real_hops_over_the_stage_axis(world, name):
    """Every permute carries one boundary; the stage ends count ``2 M - 1``
    (stage 0 pairs its last forward send with its first backward receive)
    and ``2 M``; nothing groups off the stage axis; no all-gather."""
    ranks, _ = world
    M = _rank0(ranks, name)["meta"]["num_microbatches"]
    counts = []
    for r in (ranks[0][name], ranks[1][name]):
        hops = _count(r, "collective-permute")
        counts.append(hops)
        assert _payload(r, "collective-permute") == hops * r["meta"]["boundary_bytes"]
        assert all(o["axes"] == ["stage"] for o in r["collectives"]["ops"])
        assert _count(r, "all-gather") == 0
    assert counts == [2 * M - 1, 2 * M]


def test_tp_signature_allreduce_over_model_only(world):
    r = _rank0(world[0], "tp")
    assert _count(r, "all-reduce") >= 4 * r["meta"]["n_layers"]
    assert _count(r, "collective-permute") == 0
    assert all(set(o["axes"]) <= {"model"} for o in r["collectives"]["ops"]
               if o["result_bytes"] > 64)


def _all_reduce_bytes(ops):
    """One entry per execution: the result bytes of each all-reduce, sorted."""
    return sorted(b for o in ops if o["kind"] == "all-reduce" for b in [o["result_bytes"]] * o["count"])


def test_tp_all_reduces_pinned_to_jax_op_by_op(world):
    """tp's all-reduce bytes differ from JAX's in total; op by op, JAX's
    compiled all-reduces are exactly the describe's breakdown of them and the
    port's are exactly its own, the forward sums are the same ops on both
    sides, and each JAX cotangent sum is the port's one summed once per use it
    fuses (3 on the attention side, 2 on the FFN side)."""
    ranks, jax = world
    r = _rank0(ranks, "tp")
    ops = r["meta"]["all_reduce_ops"]

    def listed(side):
        return sorted(b for _, b, n in ops[side] for b in [b] * n)

    assert _all_reduce_bytes(r["collectives"]["ops"]) == listed("port")
    assert _all_reduce_bytes(jax["tp"]["collectives"]["ops"]) == listed("jax")
    port, theirs = ops["port"], ops["jax"]
    assert port[0] == theirs[0]  # the row-parallel forward sums
    act = r["meta"]["block_psum_bytes"]
    assert port[1][1:] == port[2][1:] == (act, r["meta"]["n_layers"])
    assert theirs[1][1:] == (3 * act, r["meta"]["n_layers"])
    assert theirs[2][1:] == (2 * act, r["meta"]["n_layers"])
    pick = port[4][1]
    assert theirs[3][1] == port[3][1] + pick and theirs[4][1] == port[5][1] + pick


def test_sp_ring_signature_permutes_over_seq(world):
    r = _rank0(world[0], "sp")
    n = r["meta"]["seq_shards"]
    assert _count(r, "collective-permute") >= r["meta"]["n_layers"] * (n - 1)
    assert _count(r, "all-to-all") == 0
    assert all(o["axes"] == ["seq"] for o in r["collectives"]["ops"]
               if o["kind"] == "collective-permute")
    assert r["meta"]["param_bytes"] + 4 == _payload(r, "all-reduce")


def test_ep_signature_alltoall_dispatch_combine(world):
    r = _rank0(world[0], "ep")
    assert 2 <= _count(r, "all-to-all") <= 4
    assert _count(r, "collective-permute") == 0 and _count(r, "reduce-scatter") == 0
    assert all(o["axes"] == ["expert"] for o in r["collectives"]["ops"])


def test_check_signature_catches_drift():
    ops = [{"kind": "all-reduce", "result_bytes": 1000, "count": 2, "axes": ["data"],
            "group_size": 4, "wire_bytes": 1500},
           {"kind": "all-gather", "result_bytes": 500, "count": 1, "axes": ["stage"],
            "group_size": 2, "wire_bytes": 250}]
    report = {"collectives": {"ops": ops, "totals": ca.collective_totals(ops)}}
    assert ca.check_signature(report, {"all-reduce": {"count": 2, "min_bytes": 2000,
                                                      "axes": ["data"]}}) == []
    viols = ca.check_signature(report, {"forbidden": ["all-gather"],
                                        "all-reduce": {"count": 1, "max_bytes": 100,
                                                       "axes": ["model"]}})
    assert len(viols) == 4
    report["memory"] = {"peak_bytes": 5 * 1024 * 1024}
    assert ca.check_signature(report, {"memory": {"max_peak_hbm_bytes": 4 * 1024 * 1024}}) == [
        "memory: peak 5242880 B exceeds the 4194304 B budget"]


def test_wire_bytes_are_jax_ring_accounting():
    from ddl25spring_tpu.obs import xla_analytics as xa

    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for n in (None, 1, 2, 4, 8):
            assert ca.wire_bytes(kind, 4096, n) == xa._wire_bytes(kind, 4096, n), (kind, n)


def test_strategy_mesh_sizes_fold_as_jax_and_serving_names_wait():
    assert ca.mesh_sizes("zero3", (2, 4)) == {"data": 8}
    assert ca.mesh_sizes("pipeline", (2,)) == {"data": 1, "stage": 2}
    assert ca.mesh_sizes("tp") == {"data": 1, "model": 2}
    with pytest.raises(NotImplementedError, match="A12b"):
        ca.describe_strategy("serve-decode", None)
    with pytest.raises(KeyError):
        ca.describe_strategy("nope", None)
    assert ca.budget_bytes("zero3-prefetch") == 24 * 1024 * 1024
    assert ca.budget_bytes("serve-verify") is None


def test_recording_off_builds_no_record(monkeypatch):
    """Not recording, a collective never reaches the record builder; while
    recording, one record a collective with JAX's kind and byte unit."""
    import torch.distributed as dist

    comm = Comm("gloo", torch.device("cpu"))
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    calls = []
    real = Comm._note
    monkeypatch.setattr(Comm, "_note", lambda self, *a, **k: calls.append(a))
    t = torch.ones(8)
    comm.all_reduce_sum_([t])
    assert comm.records is None and calls == []
    monkeypatch.setattr(Comm, "_note", real)
    comm.start_recording()
    comm.all_reduce_mean_([t, torch.ones(3, dtype=torch.bfloat16)])
    recs = comm.stop_recording()
    assert [(r["kind"], r["result_bytes"], r["dtype"], r["group_size"]) for r in recs] == \
        [("all-reduce", 32, "f32", 4), ("all-reduce", 6, "bf16", 4)]
    assert comm.records is None
