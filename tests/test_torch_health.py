"""The port's runtime health layer against the JAX package's, on the CPU: the
in-step numerics sentinels of every train-step builder, the flight recorder,
the stall watchdog and the lock-order sanitizer (the twins of
``tests/test_health.py``).

One spawned gloo world of 4 ranks runs the multi-rank cases, ``Mesh.regrid``
giving each its grid; the JAX references compile and run on as many CPU
devices meanwhile.  The pins:

- **the same poisoned batch, the same record.**  The DP step on
  ``dp.TinyMlp`` (2 replicas, SGD with momentum 0.9, policy ``skip``): a
  clean step, a step whose batch holds a NaN, a clean step, in both
  packages.  The violation names the same metric, the same non-finite leaves
  (``grads['b1']``...) and the same step index; the clean steps' loss,
  gradient norm and update ratio agree within rtol 1e-5; the poisoned step
  leaves the parameters and the optimizer state bitwise unchanged in both.
  The same for a 2-layer, narrow fp32 LLaMA through the one-process step,
  poisoned by a NaN loss scale that rides the batch.
- a NaN only in Adam's first moment (clean gradients) trips the guard in
  the step that applies it, naming ``updates['w1']``, in both packages;
- ZeRO-3 on the 4-rank world: one violation record across the shards (rank
  0's), the same leaves as JAX's; its ``zero.*`` statics equal JAX's;
- the 2 x 2 DP x PP LLaMA pipeline, SP and TP on 2 x 2: a clean step's
  facts (summed over the grid, each leaf weighted by its copies) equal one
  process's on the whole model, rtol 1e-5; a NaN in one replica's embedding
  poisons every rank of the pipeline, which all skip bitwise; rank 0 alone
  records, with the JAX pytree's leaf names;
- **zero cost when off**: for every builder, the ATen op sequence of a
  step built with the options following the (off) flags equals that of one
  built with them off, recorded under a ``TorchDispatchMode``, and the
  options on change it; the overlapped DP step issues its buckets in the
  same order with the guard on;
- ``halt`` raises :class:`SentinelViolation` with the step's context after
  dumping ``flight.json``; a poisoned first step leaves the optimizer as if
  it had never stepped; fused steps record each step of the window;
- the flight ring, its atomic strict-JSON dump and its crash hooks; the
  watchdog fires with every thread's stack, re-arms and restarts;
  ``wrap_lock`` reports an inverted acquisition order.

Adam's ``eps`` is 1e-6 on both sides, as in ``test_torch_zero.py``.  The
ranks import this module, so it imports jax only inside the fixtures and
tests.
"""

import json
import os
import signal
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ddl25spring_tpu_torch import obs  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.obs import flight, sentinels  # noqa: E402
from ddl25spring_tpu_torch.obs.watchdog import StallWatchdog, thread_stacks  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel import dp, ep, sp, tp, zero  # noqa: E402
from ddl25spring_tpu_torch.parallel.het_pipeline import make_het_pipeline_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    fuse_train_steps,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

RTOL = 1e-5
EPS = 1e-6
_g = np.random.default_rng(7)
MLP_W = {"w1": 0.3 * _g.normal(size=(16, 32)), "b1": 0.3 * _g.normal(size=32),
         "w2": 0.3 * _g.normal(size=(32, 4))}
MLP_W = {k: v.astype(np.float32) for k, v in MLP_W.items()}
MLP_X = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
MLP_Y = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
BAD_X = MLP_X.copy()
BAD_X[0, 0] = np.nan
TINY = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=8, dtype="float32")
TOKENS = np.random.default_rng(3).integers(0, 64, (4, 8)).astype(np.int64)
MOE = dict(TINY, n_experts=4, capacity_factor=2.0)
EP_D, EP_E = 8, 4


def _off():
    sentinels.enable(False)
    sentinels.set_policy("log")
    sentinels.reset()
    obs.enable(False)
    obs.counters.reset()
    flight.reset()
    flight.configure(run_dir=None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process too, as in the spawned ranks: the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _health_clean():
    """Sentinels and telemetry off, flight ring and counters empty, before
    and after every test: the module flags must never leak."""
    _off()
    yield
    _off()


def _clean():
    sentinels.reset()
    flight.reset()
    obs.counters.reset()


def _mlp():
    model = dp.TinyMlp()
    with torch.no_grad():
        for k, p in model.param_tree().items():
            p.copy_(torch.from_numpy(MLP_W[k]))
    return model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bits(tensors) -> list[np.ndarray]:
    """Each tensor's bits (NaN-proof bitwise comparison)."""
    return [t.detach().contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)
            .numpy().copy() for t in tensors]


def _state(opt) -> list[torch.Tensor]:
    return [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _records():
    sentinels.flush()
    return [dict(r) for r in flight.last()]


def _tiny_llama(cfg=TINY, seed=0):
    return llama.Llama(LlamaConfig(**cfg), device="cpu",
                       generator=torch.Generator().manual_seed(seed))


class OpLog(TorchDispatchMode):
    """The ATen ops a block runs, in order."""

    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(make) -> dict:
    """One step's op log of the builds ``make(instrument, sentinel)``:
    following the (off) flags, explicitly off, and on."""
    out = {}
    for name, kw in (("default", (None, None)), ("off", (False, False)),
                     ("on", (True, True))):
        step, batch = make(*kw)
        log = OpLog()
        with log:
            step(batch)
        sentinels.flush()
        out[name] = log.ops
    return out


# ------------------------------------------------------------- the world


def _dp_case(mesh, opt_fn):
    _clean()
    model = _mlp()
    opt = opt_fn(model.parameters())
    step = dp.make_dp_train_step(model, dp.tiny_mlp_loss, opt, mesh, sentinel=True)
    return model, opt, step


def _llama_pipe(mesh, params, sentinel=True):
    cfg = LlamaConfig(**TINY)
    stage = shard_staged_params(params, cfg, mesh)
    opt = torch.optim.Adam(stage.parameters(), lr=1e-3, eps=EPS)
    step = make_pipeline_train_step(stage, cfg, opt, mesh, 2, sentinel=sentinel)
    return stage, opt, step


def _builders(mesh4, m22, params, sp_grid, tp_grid, ep_grid):
    """name -> make(instrument, sentinel) -> (step, batch), for every builder
    with the options."""
    mlp = (_t(MLP_X), _t(MLP_Y))
    toks = _t(TOKENS)
    cfg, moe_cfg = LlamaConfig(**TINY), LlamaConfig(**MOE)

    def adam(ps):
        return torch.optim.Adam(ps, lr=1e-3, eps=EPS)

    def dp_(overlap=False, bb=dp.bucketing.AUTO):
        def make(i, s):
            m = _mlp()
            return dp.make_dp_train_step(m, dp.tiny_mlp_loss, adam(m.parameters()), m22,
                                         bucket_bytes=bb, overlap=overlap, instrument=i,
                                         sentinel=s), mlp
        return make

    def wavg(i, s):
        m = _mlp()
        return dp.make_dp_weight_avg_step(m, dp.tiny_mlp_loss, adam(m.parameters()), m22,
                                          sentinel=s), mlp

    def zero3(i, s):
        m = _mlp()
        rows = zero.zero_shard_params(m, mesh4)
        return zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, adam(rows), mesh4, rows,
                                            instrument=i, sentinel=s), mlp

    def zero12(stage):
        def make(i, s):
            m = _mlp()
            rows = zero.zero_shard_params(m, mesh4)
            return zero.make_zero_partitioned_train_step(
                m, dp.tiny_mlp_loss, adam(rows), mesh4, rows, stage=stage, sentinel=s), mlp
        return make

    def zero3_llama(i, s):
        m = _tiny_llama()
        rows = zero.zero_shard_llama_params(m, mesh4)
        return zero.make_zero3_llama_train_step(m, adam(rows.parameters()), mesh4, rows,
                                                sentinel=s), toks

    def sp_(i, s):
        m = _tiny_llama()
        return sp.make_sp_train_step(m, cfg, adam(m.parameters()), sp_grid, data_axis="data",
                                     sentinel=s), toks

    def tp_(i, s):
        ax = tp_grid.axis("model")
        m = tp.load_tp_params(_tiny_llama(), tp.shard_tp_params(params, 2, ax.index))
        return tp.make_tp_train_step(m, cfg, adam(m.parameters()), tp_grid,
                                     data_axis="data", sentinel=s), toks

    def ep_(i, s):
        ax = ep_grid.axis("expert")
        p = ep.shard_moe_params(_moe_params(), ax.size, ax.index)
        x = np.random.default_rng(11).normal(size=(16, EP_D)).astype(np.float32)
        return ep.make_ep_train_step(p, adam(p.parameters()), ep_grid, sentinel=s), \
            (_t(x), _t(x))

    def pipe(i, s):
        stage = shard_staged_params(params, cfg, m22)
        return make_pipeline_train_step(stage, cfg, adam(stage.parameters()), m22, 2,
                                        instrument=i, sentinel=s), toks

    def moe_pipe(i, s):
        moe_params = llama.export_params(_tiny_llama(MOE))
        stage = shard_staged_params(moe_params, moe_cfg, m22)
        return make_pipeline_train_step(stage, moe_cfg, adam(stage.parameters()), m22, 2,
                                        instrument=i, sentinel=s), toks

    def het(i, s):
        stage = torch.nn.Linear(16, 16 if m22.coords[1] == 0 else 4)
        with torch.no_grad():
            stage.weight.copy_(torch.linspace(-0.5, 0.5, stage.weight.numel())
                               .reshape(stage.weight.shape))
        return make_het_pipeline_train_step(
            stage, lambda out, b: ((out - b["y"]) ** 2).mean(), [(16,), (4,)],
            adam(stage.parameters()), m22, 2, instrument=i, sentinel=s), \
            {"x": _t(MLP_X), "y": _t(MLP_Y)}

    return {"dp": dp_(), "dp-per-tensor": dp_(bb=None), "dp-overlap": dp_(True, 64),
            "dp-weight-avg": wavg, "zero3": zero3, "zero1": zero12(1), "zero2": zero12(2),
            "zero3-llama": zero3_llama, "sp": sp_, "tp": tp_, "ep": ep_, "pipeline": pipe,
            "pipeline-moe": moe_pipe, "het_pipeline": het}


def _moe_params():
    g = np.random.default_rng(12)
    shapes = {"router": (EP_D, EP_E), "w_gate": (EP_E, EP_D, 16), "w_up": (EP_E, EP_D, 16),
              "w_down": (EP_E, 16, EP_D)}
    return {k: (0.1 * g.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


def health_rank(rdv, params):
    """Every multi-rank case on this rank (see the module docstring)."""
    good, bad = (_t(MLP_X), _t(MLP_Y)), (_t(BAD_X), _t(MLP_Y))
    out = {}
    with init_mesh(rdv, 4, stages=1, device="cpu") as mesh4:
        m22 = mesh4.regrid(2, stages=2)  # two lines of 2: DP x PP, and DP of 2
        # the DP step, SGD momentum 0.9, skip: clean, poisoned, clean
        with sentinels.scoped(True, policy="skip"):
            model, opt, step = _dp_case(m22, lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                                         momentum=0.9))
            step(good)
            before = _bits(list(model.parameters()) + _state(opt))
            step(bad)
            after = _bits(list(model.parameters()) + _state(opt))
            step(good)
            records = _records()
            with tempfile.TemporaryDirectory() as tmp:
                doc = json.load(open(flight.dump(path=os.path.join(tmp, "flight.json"),
                                                 reason="test")))
            out["dp"] = {"records": records, "unchanged": _same(before, after), "dump": doc}
            # NaN only in Adam's first moment, clean gradients
            model, opt, step = _dp_case(m22, lambda ps: torch.optim.Adam(ps, lr=1e-3,
                                                                          eps=EPS))
            step(good)
            with torch.no_grad():
                opt.state[model.w1]["exp_avg"][0, 0] = float("nan")
            before = _bits(model.parameters())
            step(good)
            out["adam_nan"] = {"records": _records(),
                               "unchanged": _same(before, _bits(model.parameters()))}
        # ZeRO-3 over 4 ranks, log, instrumented
        _clean()
        model = _mlp()
        rows = zero.zero_shard_params(model, mesh4)
        opt = torch.optim.Adam(rows, lr=1e-3, eps=EPS)
        with sentinels.scoped(True, policy="log"):
            step = zero.make_zero_dp_train_step(model, dp.tiny_mlp_loss, opt, mesh4, rows,
                                                instrument=True, sentinel=True)
        step(bad)
        out["zero3"] = {"records": _records(), "static": obs.counters.snapshot()["static"],
                        "zero.loss": obs.counters.snapshot()["scalars"].get("zero.loss")}
        # the 2 x 2 DP x PP LLaMA pipeline, skip: a clean step, then a NaN in
        # replica 0's embedding
        _clean()
        with sentinels.scoped(True, policy="skip"):
            stage, opt, step = _llama_pipe(m22, params)
            step(_t(TOKENS))
            if mesh4.rank == 0:  # one process on the whole model, the same batch
                full = llama.load_jax_params(_tiny_llama(), params)
                serial = dp.make_train_step(
                    full, lambda m, t: causal_lm_loss(m(t), t),
                    torch.optim.Adam(full.parameters(), lr=1e-3, eps=EPS))
                serial(_t(TOKENS))
            clean = [r for r in _records() if r["strategy"] in ("pipeline", "serial")]
            if m22.coords == (0, 0):
                with torch.no_grad():
                    stage.embed[int(TOKENS[0, 0]), 0] = float("nan")
            before = _bits(list(stage.parameters()) + _state(opt))
            flight.reset()
            step(_t(TOKENS))
            out["pipeline"] = {"clean": clean, "records": _records(),
                               "unchanged": _same(before, _bits(list(stage.parameters())
                                                                + _state(opt)))}
        # the overlapped DP step issues its buckets in the same order guarded
        logs = []
        for s in (False, True):
            _clean()
            m = _mlp()
            step = dp.make_dp_train_step(m, dp.tiny_mlp_loss,
                                         torch.optim.SGD(m.parameters(), lr=0.1), m22,
                                         bucket_bytes=64, overlap=True, sentinel=s)
            step(good)
            logs.append(step.log)
        out["overlap_logs"] = logs
        # SP and TP (2 x 2, data axis given): the guard's sums over the grid
        # are the whole model's, as one process on the whole batch sees it
        grids = (m22.regrid(2, seq=2), m22.regrid(2, model=2), m22.regrid(1, expert=4))
        _clean()
        cfg = LlamaConfig(**TINY)
        with sentinels.scoped(True, policy="log"):
            m = _tiny_llama()
            sp.make_sp_train_step(m, cfg, torch.optim.Adam(m.parameters(), lr=1e-3, eps=EPS),
                                  grids[0], data_axis="data")(_t(TOKENS))
            ax = grids[1].axis("model")
            m = tp.load_tp_params(_tiny_llama(), tp.shard_tp_params(params, 2, ax.index))
            tp.make_tp_train_step(m, cfg, torch.optim.Adam(m.parameters(), lr=1e-3, eps=EPS),
                                  grids[1], data_axis="data")(_t(TOKENS))
            if mesh4.rank == 0:
                full = llama.load_jax_params(_tiny_llama(), params)
                dp.make_train_step(full, lambda m, t: causal_lm_loss(m(t), t),
                                   torch.optim.Adam(full.parameters(), lr=1e-3,
                                                    eps=EPS))(_t(TOKENS))
        out["sp_tp"] = _records()
        # zero cost when off: the op logs of every builder
        out["ops"] = {}
        for name, make in _builders(mesh4, m22, params, *grids).items():
            _clean()
            out["ops"][name] = _ops(make)
        out["pipeline_static"] = obs.counters.snapshot()["static"]
    return out


def _jax_records(flight_j, sentinels_j):
    import jax

    jax.effects_barrier()
    recs = [dict(r) for r in flight_j.last()]
    flight_j.reset()
    sentinels_j.reset()
    return recs


def _jax_refs(devices8):
    """The JAX package's records of the same cases."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu.obs import flight as jflight
    from ddl25spring_tpu.obs import sentinels as jsent
    from ddl25spring_tpu.parallel import dp as jdp
    from ddl25spring_tpu.parallel import zero as jzero
    from ddl25spring_tpu.utils.mesh import make_mesh

    def loss_fn(p, batch, key):
        x, y = batch
        return jnp.mean((jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)

    p = {k: jnp.asarray(v) for k, v in MLP_W.items()}
    good = (jnp.asarray(MLP_X), jnp.asarray(MLP_Y))
    bad = (jnp.asarray(BAD_X), jnp.asarray(MLP_Y))
    key = jax.random.PRNGKey(0)
    mesh2 = make_mesh(devices8[:2], data=2)
    jsent.reset()
    jflight.reset()
    out = {}
    tx = optax.sgd(0.1, momentum=0.9)
    with jsent.scoped(True, policy="skip"):
        step = jdp.make_dp_train_step(loss_fn, tx, mesh2, per_shard_rng=False)
    p1, o1, _ = step(p, tx.init(p), good, key)
    p2, o2, _ = step(p1, o1, bad, key)
    unchanged = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(jax.tree.leaves((p1, o1)), jax.tree.leaves((p2, o2))))
    step(p2, o2, good, key)
    out["dp"] = {"records": _jax_records(jflight, jsent), "unchanged": unchanged}
    tx = optax.adam(1e-3, eps=EPS)
    with jsent.scoped(True, policy="skip"):
        step = jdp.make_dp_train_step(loss_fn, tx, mesh2, per_shard_rng=False)
    p1, o1, _ = step(p, tx.init(p), good, key)
    adam = o1[0]
    o1 = (adam._replace(mu=dict(adam.mu, w1=adam.mu["w1"].at[0, 0].set(jnp.nan))),) + o1[1:]
    p2, _, _ = step(p1, o1, good, key)
    out["adam_nan"] = {"records": _jax_records(jflight, jsent),
                       "unchanged": all(np.array_equal(np.asarray(p1[k]), np.asarray(p2[k]))
                                        for k in p)}
    from ddl25spring_tpu import obs as jobs

    mesh4 = make_mesh(devices8[:4], data=4)
    jobs.counters.reset()
    with jsent.scoped(True, policy="log"):
        step = jzero.make_zero_dp_train_step(loss_fn, tx, mesh4, p, per_shard_rng=False,
                                             instrument=True)
    shards = jzero.zero_shard_params(p, mesh4)
    step(shards, tx.init(shards), bad, key)
    out["zero3"] = {"records": _jax_records(jflight, jsent),
                    "static": jobs.counters.snapshot()["static"]}
    jobs.counters.reset()
    return out


def _jax_staged_names(params):
    """The JAX pipeline guard's leaf names: grads then updates, each over
    the staged pytree's leaves in its flatten order."""
    import jax

    from ddl25spring_tpu.models.llama import split_blocks_for_stages

    staged = split_blocks_for_stages(params, 2)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(staged)[0]]
    return ["grads" + p for p in paths] + ["updates" + p for p in paths]


@pytest.fixture(scope="module")
def world(devices8, tmp_path_factory):
    params = llama.export_params(_tiny_llama())
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, health_rank, 4, params, timeout=240,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(devices8)
        refs["staged_names"] = _jax_staged_names(params)
        return ranks.result(), refs


def _violations(recs):
    return [r for r in recs if r["kind"] == "violation"]


def _same_record(mine, theirs, keys=("loss", "grad_norm", "update_ratio")):
    assert mine["kind"] == theirs["kind"] and mine["step"] == theirs["step"]
    for k in keys:
        if k in theirs and isinstance(theirs[k], float) and np.isfinite(theirs[k]):
            np.testing.assert_allclose(mine[k], theirs[k], rtol=RTOL, err_msg=k)
    for k in ("violating_metric", "nonfinite_leaves"):
        assert mine.get(k) == theirs.get(k), k


def test_dp_poisoned_batch_matches_jax(world):
    ranks, refs = world
    mine, theirs = ranks[0]["dp"], refs["dp"]
    assert [r["kind"] for r in mine["records"]] == ["step", "violation", "step"]
    for a, b in zip(mine["records"], theirs["records"], strict=True):
        _same_record(a, b)
    v = _violations(mine["records"])[0]
    assert v["strategy"] == "dp" and v["step"] == 1 and v["violating_metric"] == "grads['b1']"
    assert mine["unchanged"] and theirs["unchanged"]
    doc = mine["dump"]  # the dump names the strategy, step and metric, strict JSON
    assert doc["violations"] == 1 and doc["last_violation"]["step"] == 1
    assert doc["last_violation"]["violating_metric"] == "grads['b1']"
    assert doc["last_violation"]["loss"] == "nan" and json.dumps(doc)


def test_dp_records_on_the_first_replica_only(world):
    ranks, _ = world
    # ranks 0 and 1 are replica 0 of the two DP lines; 2 and 3 replica 1
    assert [len(r["dp"]["records"]) for r in ranks] == [3, 3, 0, 0]
    assert all(r["dp"]["unchanged"] for r in ranks)


def test_optimizer_nan_detected_in_same_step(world):
    ranks, refs = world
    mine, theirs = ranks[0]["adam_nan"], refs["adam_nan"]
    v, w = _violations(mine["records"]), _violations(theirs["records"])
    assert len(v) == len(w) == 1
    _same_record(v[0], w[0])
    assert v[0]["violating_metric"].startswith("updates")
    assert any("w1" in leaf for leaf in v[0]["nonfinite_leaves"])
    assert mine["unchanged"] and theirs["unchanged"]


def test_zero3_nan_detected_once_across_shards(world):
    ranks, refs = world
    per_rank = [r["zero3"]["records"] for r in ranks]
    assert [len(r) for r in per_rank] == [1, 0, 0, 0]
    (v,) = per_rank[0]
    (w,) = refs["zero3"]["records"]
    assert v["kind"] == "violation" and v["strategy"] == "zero3"
    _same_record(v, w)


def test_zero3_statics_equal_jax(world):
    ranks, refs = world
    keys = ("zero.allgather_bytes_per_step", "zero.reduce_scatter_bytes_per_step",
            "zero.params_bytes_gathered")
    want = {k: refs["zero3"]["static"][k] for k in keys}
    for r in ranks:
        assert {k: r["zero3"]["static"][k] for k in keys} == want
        assert r["zero3"]["zero.loss"] is None  # a NaN loss folds as nothing, as in JAX


def test_pipeline_guard_sums_to_the_whole_model(world):
    ranks, _ = world
    clean = {r["strategy"]: r for r in ranks[0]["pipeline"]["clean"]}
    pipe, serial = clean["pipeline"], clean["serial"]
    assert pipe["kind"] == serial["kind"] == "step"
    for k in ("loss", "grad_norm", "update_ratio"):
        np.testing.assert_allclose(pipe[k], serial[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("strategy", ["sp", "tp"])
def test_sp_and_tp_guards_sum_to_the_whole_model(world, strategy):
    ranks, _ = world
    recs = {r["strategy"]: r for r in ranks[0]["sp_tp"]}
    assert [len(r["sp_tp"]) for r in ranks] == [3, 0, 0, 0]
    for k in ("loss", "grad_norm", "update_ratio"):
        np.testing.assert_allclose(recs[strategy][k], recs["serial"][k], rtol=RTOL, err_msg=k)


def test_pipeline_poison_on_one_rank_skips_every_rank(world):
    ranks, refs = world
    assert all(r["pipeline"]["unchanged"] for r in ranks)
    per_rank = [r["pipeline"]["records"] for r in ranks]
    assert [len(r) for r in per_rank] == [1, 0, 0, 0]
    (v,) = per_rank[0]
    assert v["kind"] == "violation" and v["strategy"] == "pipeline" and v["step"] == 1
    # every leaf is poisoned: the names are the JAX pytree's, in its order
    assert v["nonfinite_leaves"] == refs["staged_names"]
    assert v["violating_metric"] == refs["staged_names"][0]


@pytest.mark.parametrize("name", ["dp", "dp-per-tensor", "dp-overlap", "dp-weight-avg",
                                  "zero3", "zero1", "zero2", "zero3-llama", "sp", "tp", "ep",
                                  "pipeline", "pipeline-moe", "het_pipeline"])
def test_every_builder_ops_identical_when_disabled(world, name):
    ranks, _ = world
    for r in ranks:
        ops = r["ops"][name]
        assert ops["default"] == ops["off"], f"{name}: the off build runs other ops"
        assert ops["on"] != ops["off"], f"{name}: enabling the options changed nothing"


def test_sentinels_do_not_reorder_overlapped_buckets(world):
    ranks, _ = world
    for r in ranks:
        off, on = r["overlap_logs"]
        assert off == on and any(kind == "issue" for kind, _ in off)


def test_pipeline_statics_equal_jax(world, devices8):
    from ddl25spring_tpu import obs as jobs
    from ddl25spring_tpu.parallel.pipeline import make_pipeline_loss
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    ranks, _ = world
    jobs.counters.reset()
    make_pipeline_loss(jconfig.LlamaConfig(**MOE), make_mesh(devices8[:4], data=2, stage=2),
                       2, data_axis="data", instrument=True)
    want = {k: v for k, v in jobs.counters.snapshot()["static"].items()
            if k.startswith("pipeline.")}
    jobs.counters.reset()
    assert want["pipeline.bubble_fraction_gpipe"] == obs.gpipe_bubble_fraction(2, 2)
    for r in ranks:
        got = {k: v for k, v in r["pipeline_static"].items() if k.startswith("pipeline.")}
        assert got == want


# ------------------------------------------------------ one process


def _llama_loss(model, batch):
    tokens, scale = batch
    return causal_lm_loss(model(tokens), tokens) * scale


def test_llama_poisoned_batch_matches_jax():
    """The one-process LLaMA step (2 layers, fp32, Adam, skip) in both
    packages: a clean step, one whose loss scale is NaN, a clean step."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu.models.llama import llama_forward
    from ddl25spring_tpu.obs import flight as jflight
    from ddl25spring_tpu.obs import sentinels as jsent
    from ddl25spring_tpu.ops.losses import causal_lm_loss as jce
    from ddl25spring_tpu.parallel.dp import make_train_step as jstep
    from ddl25spring_tpu.utils import config as jconfig

    model = _tiny_llama()
    params = llama.export_params(model)
    batches = [(TOKENS, 1.0), (TOKENS, float("nan")), (TOKENS[::-1].copy(), 1.0)]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=EPS)
    with sentinels.scoped(True, policy="skip"):
        step = dp.make_train_step(model, _llama_loss, opt)
    unchanged = None
    for i, (t, s) in enumerate(batches):
        before = _bits(list(model.parameters()) + _state(opt))
        step((_t(t), torch.tensor(s)))
        if i == 1:
            unchanged = _same(before, _bits(list(model.parameters()) + _state(opt)))
    mine = _records()

    jcfg = jconfig.LlamaConfig(**TINY)

    def loss_fn(p, batch, key):
        tokens, scale = batch
        return jce(llama_forward(p, tokens, jcfg), tokens) * scale

    tx = optax.adam(1e-3, eps=EPS)
    jsent.reset()
    jflight.reset()
    with jsent.scoped(True, policy="skip"):
        jst = jstep(loss_fn, tx)
    p = jax.tree.map(jnp.asarray, params)
    o = tx.init(p)
    junchanged = None
    for i, (t, s) in enumerate(batches):
        p2, o2, _ = jst(p, o, (jnp.asarray(t, jnp.int32), jnp.float32(s)), None)
        if i == 1:
            junchanged = all(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
                             for a, b in zip(jax.tree.leaves((p, o)), jax.tree.leaves((p2, o2))))
        p, o = p2, o2
    theirs = _jax_records(jflight, jsent)
    assert [r["kind"] for r in mine] == ["step", "violation", "step"]
    for a, b in zip(mine, theirs, strict=True):
        _same_record(a, b)
    assert mine[1]["violating_metric"] == "grads['blocks']['ln1']"
    assert unchanged and junchanged


def test_poisoned_first_step_leaves_the_optimizer_unstepped():
    x, y = _t(MLP_X), _t(MLP_Y)
    fresh = _mlp()
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    dp.make_train_step(fresh, dp.tiny_mlp_loss, fresh_opt)((x, y))
    model = _mlp()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    with sentinels.scoped(True, policy="skip"):
        step = dp.make_train_step(model, dp.tiny_mlp_loss, opt)
    step((_t(BAD_X), y))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), _mlp().parameters()))
    step((x, y))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    for p, q in zip(model.parameters(), fresh.parameters()):
        for k, v in fresh_opt.state[q].items():
            assert torch.equal(opt.state[p][k], v), k


def test_clean_steps_are_the_unguarded_steps_bitwise():
    x, y = _t(MLP_X), _t(MLP_Y)
    plain, guarded = _mlp(), _mlp()
    a = dp.make_train_step(plain, dp.tiny_mlp_loss, torch.optim.Adam(plain.parameters(), 1e-2))
    with sentinels.scoped(True, policy="skip"):
        b = dp.make_train_step(guarded, dp.tiny_mlp_loss,
                               torch.optim.Adam(guarded.parameters(), 1e-2))
    for _ in range(3):
        assert torch.equal(a((x, y)), b((x, y)))
    assert all(torch.equal(p, q) for p, q in zip(plain.parameters(), guarded.parameters()))


def test_halt_policy_raises_with_flight_context(tmp_path):
    flight.configure(run_dir=str(tmp_path))
    model = _mlp()
    with sentinels.scoped(True, policy="halt"):
        step = dp.make_train_step(model, dp.tiny_mlp_loss,
                                  torch.optim.SGD(model.parameters(), lr=0.1))
    step((_t(MLP_X), _t(MLP_Y)))
    with pytest.raises(sentinels.SentinelViolation, match="sentinel violation") as e:
        step((_t(BAD_X), _t(MLP_Y)))
    ctx = e.value.context
    assert (ctx["strategy"], ctx["step"]) == ("serial", 1)
    assert ctx["violating_metric"].startswith("grads")
    doc = json.load(open(tmp_path / "flight.json"))
    assert doc["reason"] == "sentinel_halt"
    assert doc["last_violation"]["step"] == 1
    assert doc["last_violation"]["violating_metric"] == ctx["violating_metric"]


def test_fused_steps_record_every_step_of_the_window():
    model = _mlp()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with sentinels.scoped(True, policy="skip"):
        step = dp.make_train_step(model, dp.tiny_mlp_loss, opt)
    multi = fuse_train_steps(step, 3, module=model, optimizer=opt, device="cpu")
    x = torch.stack([_t(MLP_X), _t(BAD_X), _t(MLP_X)])
    losses = multi((x, torch.stack([_t(MLP_Y)] * 3)))
    recs = _records()
    assert [r["kind"] for r in recs] == ["step", "violation", "step"]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert torch.isnan(losses[1]) and torch.isfinite(losses[[0, 2]]).all()


def test_guard_disabled_returns_results_unchanged():
    results = [torch.ones(2)]
    assert sentinels.guard("x", results, loss=torch.tensor(1.0), enabled=False) is results


def test_guard_select_is_bitwise_both_ways():
    new = [torch.tensor([1.5, float("nan"), -0.0]), torch.tensor([7], dtype=torch.int64)]
    old = [torch.tensor([2.0, 3.0, 4.0]), torch.tensor([3], dtype=torch.int64)]
    keep = [t.clone() for t in new]
    sentinels.select_views_(sentinels.int_views(new, [t.clone() for t in old]),
                            torch.tensor(True))
    assert _same(_bits(new), _bits(keep))
    sentinels.select_views_(sentinels.int_views(new, old), torch.tensor(False))
    assert torch.equal(new[0], torch.tensor([2.0, 3.0, 4.0])) and new[1].item() == 3


def test_policy_resolution_and_env_choice(monkeypatch):
    with sentinels.scoped(True, policy="skip"):
        assert sentinels.resolve(None) == (True, "skip")
        assert sentinels.resolve(False) == (False, "skip")
        assert sentinels.resolve(None, "halt") == (True, "halt")
    assert sentinels.resolve(None) == (False, "log")
    with pytest.raises(ValueError, match="not one of"):
        sentinels.set_policy("explode")
    from ddl25spring_tpu_torch.utils.config import env_choice

    monkeypatch.setenv("DDL25_TEST_CHOICE", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        env_choice("DDL25_TEST_CHOICE", ("a", "b"), "a")
    monkeypatch.setenv("DDL25_TEST_CHOICE", "b")
    assert env_choice("DDL25_TEST_CHOICE", ("a", "b"), "a") == "b"


def test_keystr_is_jaxs():
    import jax

    tree = {"blocks": {"wq": 1, "moe": {"router": 2}}, "embed": 3, "stages": (4, {"w": 5})}
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    paths = [("blocks", "moe", "router"), ("blocks", "wq"), ("embed",), ("stages", 0),
             ("stages", 1, "w")]
    assert [sentinels.keystr(p) for p in paths] == want


# ------------------------------------------------------- flight recorder


def test_flight_ring_truncates_and_snapshot_counts(tmp_path):
    flight.configure(capacity=8)
    try:
        flight.record(kind="violation", strategy="dp", step=0,
                      violating_metric="loss", violation=True)
        for i in range(20):
            flight.record(kind="step", step=i)
        snap = flight.snapshot()
        assert snap["recorded"] == 21
        assert [r["step"] for r in snap["records"]] == list(range(12, 20))
        assert snap["violations"] == 1
        doc = json.load(open(flight.dump(path=str(tmp_path / "f.json"))))
        assert doc["violations"] == 1
        assert doc["last_violation"]["violating_metric"] == "loss"
    finally:
        flight.configure(capacity=256)


def test_flight_dump_is_atomic_and_json_safe(tmp_path):
    flight.annotate(layout="dp", rng_seed=20, h2d=np.float32(3.5), loss_t=torch.tensor(2.0),
                    weird=object())
    flight.record(kind="step", loss=float("nan"), grad_norm=float("inf"),
                  npnan=np.float32("nan"), step=0)
    path = flight.dump(path=str(tmp_path / "flight.json"), reason="manual")
    doc = json.loads(open(path).read())  # strict: would reject bare NaN tokens
    assert doc["meta"]["layout"] == "dp" and doc["meta"]["h2d"] == 3.5
    assert doc["meta"]["loss_t"] == 2.0 and isinstance(doc["meta"]["weird"], str)
    assert doc["records"][0]["loss"] == "nan" and doc["records"][0]["grad_norm"] == "inf"
    assert doc["records"][0]["npnan"] == "nan"
    assert doc["time_origin_unix_s"] > 0 and doc["host_rss_bytes"] > 0
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_configure_none_clears_run_dir(tmp_path, monkeypatch):
    flight.configure(run_dir=str(tmp_path / "a"))
    flight.record(kind="step", step=0)
    monkeypatch.setenv("DDL25_FLIGHT_DIR", str(tmp_path / "dflt"))
    flight.configure(run_dir=None)
    p = flight.dump(reason="manual")
    assert p == os.path.join(str(tmp_path / "dflt"), "flight.json")
    flight.configure()
    assert flight.dump(reason="manual") == p


def test_sigterm_handler_preserves_sig_ign(tmp_path, monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        flight.configure(run_dir=str(tmp_path))
        flight.install()
        flight.record(kind="step", step=0)
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert exits == []
        assert json.load(open(tmp_path / "flight.json"))["reason"] == "sigterm"
    finally:
        flight.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_flight_excepthook_dumps_and_chains(tmp_path):
    seen = []
    prev_hook = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a)
    try:
        flight.configure(run_dir=str(tmp_path))
        flight.install()
        flight.record(kind="step", step=0)
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        doc = json.load(open(tmp_path / "flight.json"))
        assert doc["reason"] == "unhandled_exception" and "boom" in doc["exception"]
        assert seen
    finally:
        flight.uninstall()
        sys.excepthook = prev_hook
    assert sys.excepthook is prev_hook


def test_snapshot_folds_what_the_steps_staged():
    """The guard's facts reach the ring by the flusher at snapshot time too
    (on the card they wait there for their copy; on the CPU at once)."""
    meta = {"strategy": "probe", "leaf_names": ("grads['w']", "updates['w']"), "mode": "log",
            "has_loss": True, "record": True}
    facts = torch.tensor([1.0, 4.0, 1.0, 4.0, 1.0, 0.0, 0.0])
    with sentinels._lock:
        sentinels._pending.append((facts, _DoneEvent(), meta, None))
    (rec,) = flight.snapshot()["records"]
    assert rec["strategy"] == "probe" and rec["grad_norm"] == 2.0
    assert rec["update_ratio"] == pytest.approx(0.5)
    assert not sentinels._pending


class _DoneEvent:
    def query(self):
        return True

    def synchronize(self):
        pass


# --------------------------------------------------------------- watchdog


def test_watchdog_dump_carries_thread_stacks(tmp_path):
    release = threading.Event()
    t = threading.Thread(target=lambda: release.wait(10.0), name="wedged-worker", daemon=True)
    t.start()
    wd = StallWatchdog(deadline_s=0.25, run_dir=str(tmp_path), name="unit", source="self")
    with wd:
        deadline = time.monotonic() + 5.0
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.05)
    release.set()
    assert wd.fired and wd.dump_path
    doc = json.load(open(wd.dump_path))
    assert doc["reason"] == "stall" and doc["stall"]["watchdog"] == "unit"
    wedged = [v for k, v in doc["thread_stacks"].items() if "wedged-worker" in k]
    assert wedged and any("wait" in frame for frame in wedged[0])
    doc2 = json.load(open(flight.dump(reason="end_of_run")))
    assert doc2["stalls"] == 1 and doc2["stall"]["watchdog"] == "unit"


def test_watchdog_beat_rearms_and_flight_source():
    wd = StallWatchdog(deadline_s=0.2, name="beaten", poll_s=0.05)
    with wd:
        for _ in range(8):
            flight.beat()
            time.sleep(0.05)
        assert not wd.fired
        time.sleep(0.6)
        assert wd.fired
        flight.beat()
        wd.beat()
        assert not wd.fired


def test_watchdog_restartable_after_stop(tmp_path):
    wd = StallWatchdog(deadline_s=0.2, run_dir=str(tmp_path), name="restart", source="self",
                       poll_s=0.05)
    with wd:
        time.sleep(0.05)
    assert not wd.fired and wd._thread is None
    with wd:
        deadline = time.monotonic() + 5.0
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.05)
    assert wd.fired and wd._thread is None


def test_thread_stacks_sees_this_thread():
    mine = [v for k, v in thread_stacks().items() if "MainThread" in k]
    assert mine and any("test_thread_stacks" in f for f in mine[0])


# ---------------------------------------------------------------- sanitizer


def test_wrap_lock_reports_an_inverted_order(monkeypatch):
    from ddl25spring_tpu_torch.analysis import host_sanitizer as hs

    assert isinstance(hs.wrap_lock("plain", threading.Lock()), type(threading.Lock()))
    monkeypatch.setenv("DDL25_SANITIZE", "1")
    hs.reset()
    a, b = hs.wrap_lock("a", threading.Lock()), hs.wrap_lock("b", threading.Lock())
    with a, b:
        pass
    with b, pytest.raises(hs.SanitizerError, match="lock-order inversion"):
        with a:
            pass
    with a, pytest.raises(hs.SanitizerError, match="self-deadlock"):
        with a:
            pass
    kinds = [v["kind"] for v in hs.violations()]
    assert kinds == ["lock_order_inversion", "self_deadlock"]
    hs.reset()
    assert hs.violations() == []


def test_no_thread_or_hook_left_behind():
    assert not flight._installed
    assert not [t for t in threading.enumerate() if t.name.startswith("stall-watchdog")]
