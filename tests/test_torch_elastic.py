"""The port's elastic reshape and cross-mesh restore (``ft/elastic.py``,
``ft/reshard.py``, ``parallel/zero.py``'s state helpers) against the JAX
package, on the CPU: the twins of the training half of
``tests/test_elastic.py`` and of the cross-mesh and ZeRO cases of
``tests/test_ft.py`` and ``tests/test_checkpoint_tracing.py``.

One spawned gloo world of 4 ranks runs every multi-rank case;
``Mesh.regrid(2, stages=2)`` gives the ``n = 2`` layout (two DP lines of 2,
each the same run), and the JAX references compile meanwhile:

- ZeRO-3 over the tiny MLP (``w1 [12, 20]``, ``b1 [20]``, ``w2 [20, 4]``,
  JAX's test weights drawn from a numpy seed) and over a 2-layer narrow fp32
  LLaMA (``make_zero3_llama_train_step``), Adam 1e-2: 2 steps on one layout,
  a LIVE reshape (4 -> 2, and the grow-back 2 -> 4), 2 steps on the other,
  against the JAX package's 4 uninterrupted steps at n = 2 from the same
  weights (its ``make_zero_dp_train_step`` for the MLP, its plain DP for
  the LLaMA), atol 2e-5 + rtol 2e-5 (``test_elastic.py``'s tolerance);
- the checkpoint route: an ``AutoSaver`` checkpoint of n = 4 restored by
  ``restore_or_init`` on n = 2 equals the live reshape's state BITWISE
  (``test_live_fast_path_equals_copy_path``'s claim across the two
  sources), trains on within 2e-5 of JAX, and its manifest's
  ``leaf_shapes`` are the JAX package's for the same state;
- a ZeRO-sharded checkpoint restored on the same mesh resumes bitwise;
- ``relower`` of the ``zero3`` rule table onto the n = 2 mesh.

Adam's ``eps`` is 1e-6 on both sides, as in ``test_torch_zero.py``: at the
default 1e-8 Adam turns a gradient at rounding-noise size into a move of up
to its learning rate either way.  The ranks import this module, so it
imports jax only inside the fixtures and tests.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.ft import (  # noqa: E402
    AutoSaver,
    ChaosInjector,
    Fault,
    elastic,
    parse_chaos,
    read_manifest,
    reshard,
    resume_bundle,
)
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import dp, zero  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.rules import TABLES, RulePartitioner  # noqa: E402
from ddl25spring_tpu_torch.utils import pytree  # noqa: E402
from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid, init_mesh  # noqa: E402

EPS = 1e-6
LR = 1e-2
_g = np.random.default_rng(0)
MLP_W = {"w1": (0.1 * _g.normal(size=(12, 20))).astype(np.float32),
         "b1": np.zeros(20, np.float32),
         "w2": (0.1 * _g.normal(size=(20, 4))).astype(np.float32)}
MLP_BATCHES = [(_g.normal(size=(16, 12)).astype(np.float32),
                _g.normal(size=(16, 4)).astype(np.float32)) for _ in range(4)]
LLAMA = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=2, ctx_size=16, dtype="float32")
LLAMA_BATCHES = [np.random.default_rng(10 + i).integers(0, 64, (8, 16)).astype(np.int64)
                 for i in range(4)]
KINDS = ("mlp", "llama")


def _model(kind):
    if kind == "llama":
        return llama.Llama(LlamaConfig(**LLAMA), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    m = dp.TinyMlp(12, 20, 4)
    with torch.no_grad():
        for k, p in m.param_tree().items():
            p.copy_(torch.from_numpy(MLP_W[k]))
    return m


def _batch(kind, i):
    if kind == "llama":
        return torch.from_numpy(LLAMA_BATCHES[i])
    x, y = MLP_BATCHES[i]
    return torch.from_numpy(x), torch.from_numpy(y)


def _params(rows):
    return rows.parameters() if isinstance(rows, zero.LlamaRows) else rows


def _step(kind, model, mesh, rows, opt):
    if kind == "llama":
        return zero.make_zero3_llama_train_step(model, opt, mesh, rows)
    return zero.make_zero_dp_train_step(model, dp.tiny_mlp_loss, opt, mesh, rows)


def _fresh(kind, mesh):
    model = _model(kind)
    rows = (zero.zero_shard_llama_params(model, mesh) if kind == "llama"
            else zero.zero_shard_params(model, mesh))
    opt = torch.optim.Adam(_params(rows), lr=LR, eps=EPS)
    return model, rows, opt, _step(kind, model, mesh, rows, opt)


def _adopt(kind, model, mesh, state):
    """New rows, optimizer and step on ``mesh`` from a state of its layout."""
    rows = zero.zero_rows_from_state(state, model, kind == "llama")
    opt = torch.optim.Adam(_params(rows), lr=LR, eps=EPS)
    zero.zero_load_optimizer(opt, rows, state, model)
    return rows, opt, _step(kind, model, mesh, rows, opt)


def _np_rows(rows):
    if isinstance(rows, zero.LlamaRows):
        return zero.LlamaRows([r.detach().numpy().copy() for r in rows.outer],
                              [[r.detach().numpy().copy() for r in layer]
                               for layer in rows.blocks])
    return [r.detach().numpy().copy() for r in rows]


def _np_state(state):
    return {pytree.keystr(p): (leaf.local if isinstance(leaf, reshard.Rows) else
                               torch.as_tensor(leaf)).detach().numpy().copy()
            for p, leaf in pytree.flatten_with_path(state)}


def elastic_rank(rdv, ckdir):
    """Every multi-rank case; returns numpy only."""
    out = {}
    with init_mesh(rdv, 4, stages=1, device="cpu") as mesh4:
        mesh2 = mesh4.regrid(2, stages=2)
        meshes = {4: mesh4, 2: mesh2}
        for kind in KINDS:
            is_llama = kind == "llama"
            for first, second in ((4, 2), (2, 4)):
                model, rows, opt, step = _fresh(kind, meshes[first])
                for i in range(2):
                    step(_batch(kind, i))
                t0 = time.perf_counter()
                state = elastic.reshape_state(
                    zero.zero_state(rows, opt, meshes[first], model),
                    zero.zero_resume_template(model, opt, meshes[second], llama=is_llama,
                                              abstract=True))
                rows2, opt2, step2 = _adopt(kind, model, meshes[second], state)
                ev = elastic.record_reshape(old=meshes[first].axis("data"),
                                            new=meshes[second].axis("data"),
                                            wall_s=time.perf_counter() - t0, steps_lost=0,
                                            reason="device_loss")
                if first == 4:
                    out[kind, "live"] = _np_state(state)
                    out[kind, "event"] = ev
                for i in (2, 3):
                    step2(_batch(kind, i))
                out[kind, first, second] = _np_rows(rows2)
            # the checkpoint route: saved at n = 4 after 2 steps, restored on n = 2
            model, rows, opt, step = _fresh(kind, mesh4)
            saver = AutoSaver(f"{ckdir}/{kind}", save_every=1, async_save=False)
            for i in range(2):
                step(_batch(kind, i))
                st = zero.zero_state(rows, opt, mesh4, model)
                saver.maybe_save(i, resume_bundle(st["params"], st["opt_state"],
                                                  data_cursor=i + 1, rng_seed=0))
            saver.close()
            fresh = _model(kind)
            saver2 = AutoSaver(f"{ckdir}/{kind}", save_every=1)
            tmpl = zero.zero_resume_template(fresh, opt, mesh2, llama=is_llama)
            state, nxt = saver2.restore_or_init(
                resume_bundle(tmpl["params"], tmpl["opt_state"], data_cursor=0, rng_seed=0))
            out[kind, "restored"] = (_np_state({"params": state["params"],
                                                "opt_state": state["opt_state"]}),
                                     nxt, int(state["data_cursor"]))
            rows2, opt2, step2 = _adopt(kind, fresh, mesh2, state)
            for i in (2, 3):
                step2(_batch(kind, i))
            saver2.close()
            out[kind, "ckpt"] = _np_rows(rows2)
            if mesh4.rank == 0:
                out[kind, "manifest"] = read_manifest(f"{ckdir}/{kind}")
        # the same mesh: a ZeRO-sharded checkpoint resumes bitwise
        model, rows, opt, step = _fresh("mlp", mesh4)
        for i in range(4):
            step(_batch("mlp", i))
        out["same", "ref"] = _np_rows(rows)
        model, rows, opt, step = _fresh("mlp", mesh4)
        ck = Checkpointer(f"{ckdir}/same")
        for i in range(2):
            step(_batch("mlp", i))
        ck.save(1, zero.zero_state(rows, opt, mesh4, model))
        ck.close()
        fresh = _model("mlp")
        tmpl = zero.zero_resume_template(fresh, opt, mesh4)
        state, nxt = Checkpointer(f"{ckdir}/same").restore_or_init(tmpl)
        rows = zero.zero_shard_params(fresh, mesh4)
        opt = torch.optim.Adam(rows, lr=LR, eps=EPS)
        zero.zero_load_state(state, rows, opt, fresh)
        step = _step("mlp", fresh, mesh4, rows, opt)
        for i in (2, 3):
            step(_batch("mlp", i))
        out["same", "resumed"] = (nxt, _np_rows(rows))
        # the rule engine's re-lower onto the n = 2 layout
        m = _model("mlp")
        part = RulePartitioner(mesh4, TABLES["zero3"]).with_mesh(mesh2)
        rows = part.shard_params(m)
        opt = torch.optim.Adam(rows, lr=LR, eps=EPS)
        step = elastic.relower(part, mesh2, model=m, loss_fn=dp.tiny_mlp_loss, optimizer=opt,
                               rows=rows)
        out["relower"] = float(step(_batch("mlp", 0)))
    return out


# ------------------------------------------------------------ references


def _jax_refs(devices8):
    """JAX's 4 uninterrupted steps at n = 2 (the MLP's ZeRO-3, the LLaMA's
    plain DP), and the leaf shapes of its resume bundle at n = 4."""
    import jax
    import optax

    from ddl25spring_tpu.ft import resume_bundle as j_bundle
    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss as j_lm
    from ddl25spring_tpu.parallel import zero as jzero
    from ddl25spring_tpu.parallel.dp import make_dp_train_step
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    tx = optax.adam(LR, eps=EPS)
    key = jax.random.PRNGKey(1)
    mesh2, mesh4 = make_mesh(devices8[:2], data=2), make_mesh(devices8[:4], data=4)

    def mlp_loss(p, batch, key):
        x, y = batch
        return jnp.mean((jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)

    import jax.numpy as jnp

    kw = dict(per_shard_rng=False, donate=False, sentinel=False)
    step = jzero.make_zero_dp_train_step(mlp_loss, tx, mesh2, MLP_W, instrument=False, **kw)
    s = jzero.zero_shard_params(MLP_W, mesh2)
    o = tx.init(s)
    for b in MLP_BATCHES:
        s, o, _ = step(s, o, b, key)
    refs = {"mlp": jax.tree.map(np.asarray, jzero.zero_unshard_params(jax.device_get(s), MLP_W))}

    cfg = jconfig.LlamaConfig(**LLAMA)
    lparams = llama.export_params(_model("llama"))

    def lm_loss(p, t, key):
        return j_lm(jllama.llama_forward(p, t, cfg), t)

    step = make_dp_train_step(lm_loss, tx, mesh2, instrument=False, **kw)
    p, o = lparams, tx.init(lparams)
    for t in LLAMA_BATCHES:
        p, o, _ = step(p, o, t.astype(np.int32), key)
    refs["llama"] = jax.tree.map(np.asarray, p)

    for kind, params, is_llama in (("mlp", MLP_W, False), ("llama", lparams, True)):
        t = jzero.zero_resume_template(params, tx, mesh4, llama=is_llama, abstract=True)
        bundle = j_bundle(t["params"], t["opt_state"], data_cursor=0, rng_seed=0)
        refs[kind, "shapes"] = [list(np.shape(x)) for x in jax.tree.leaves(bundle)]
    return refs


@pytest.fixture(scope="module")
def world(devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    ckdir = str(tmp_path_factory.mktemp("ck"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, elastic_rank, 4, ckdir, timeout=240,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(devices8)
        return ranks.result(), refs


def _unshard(kind, per_rank):
    """The rows of one DP line (each rank's, in index order) -> the JAX
    parameter tree."""
    template = _model(kind)
    if kind == "llama":
        return zero.zero_unshard_llama_params(zero.llama_rows_to_jax(per_rank, template),
                                              template)
    leaves = zero.zero_unshard_params(
        [np.concatenate([rows[j] for rows in per_rank]) for j in range(len(per_rank[0]))],
        dp.param_leaves(template))
    return dict(zip(sorted(MLP_W), leaves, strict=True))   # param_leaves: b1, w1, w2


def _close(got, want, atol=2e-5, rtol=2e-5):
    got, want = pytree.flatten_with_path(got), pytree.flatten_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol,
                                   err_msg=pytree.keystr(path))


LINES = {2: (0, 2), 4: (0, 1, 2, 3)}   # rank 0's DP line on each layout


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("kind", KINDS)
def test_reshape_4_to_2_matches_uninterrupted(world, kind):
    """2 steps at n = 4, a live reshape to n = 2, 2 steps: JAX's 4 steps at
    n = 2 from the same weights, within its test's 2e-5; the flight event
    names the layouts."""
    ranks, refs = world
    _close(_unshard(kind, [ranks[r][kind, 4, 2] for r in LINES[2]]), refs[kind])
    ev = ranks[0][kind, "event"]
    assert ev["old"] == {"data": 4} and ev["new"] == {"data": 2}
    assert ev["steps_lost"] == 0 and ev["reason"] == "device_loss"


@pytest.mark.parametrize("kind", KINDS)
def test_grow_back_2_to_4_matches_uninterrupted(world, kind):
    ranks, refs = world
    _close(_unshard(kind, [ranks[r][kind, 2, 4] for r in LINES[4]]), refs[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_restore_4_to_2_equals_the_live_reshape(world, kind):
    """An AutoSaver checkpoint of n = 4 restored on n = 2 is bitwise the live
    reshape's state, resumes at step 2 with the cursor 2, trains on within
    2e-5 of JAX, and its manifest records JAX's leaf shapes ([4, k] rows,
    [L, 4, k] LLaMA blocks)."""
    ranks, refs = world
    for r in range(4):
        restored, nxt, cursor = ranks[r][kind, "restored"]
        live = ranks[r][kind, "live"]
        assert (nxt, cursor) == (2, 2)
        assert sorted(restored) == sorted(live)
        for k in live:
            assert restored[k].dtype == live[k].dtype
            assert np.array_equal(restored[k].view(np.int32), live[k].view(np.int32)), k
    _close(_unshard(kind, [ranks[r][kind, "ckpt"] for r in LINES[2]]), refs[kind])
    man = ranks[0][kind, "manifest"]
    assert [s for s, _ in man["leaf_shapes"]] == refs[kind, "shapes"]
    assert man["saves"] == 2 and man["last_durable_step"] == 1
    assert any(len(s) == 3 and s[1] == 4 for s, _ in man["leaf_shapes"]) == (kind == "llama")


def test_zero_sharded_kill_and_resume(world):
    """``test_checkpoint_tracing.py::test_zero_sharded_kill_and_resume``'s
    twin: ZeRO-3 rows saved after 2 steps, restored on the same mesh into a
    fresh run, 2 more steps: bitwise the 4 uninterrupted steps."""
    ranks, _ = world
    for r in range(4):
        nxt, rows = ranks[r]["same", "resumed"]
        assert nxt == 2
        for a, b in zip(rows, ranks[r]["same", "ref"], strict=True):
            assert np.array_equal(a, b)


def test_rules_relower_with_mesh(world):
    """``relower`` carries the zero3 table onto the n = 2 layout and builds a
    step that trains; a strategy name waits for the describe() registry."""
    ranks, _ = world
    assert np.isfinite(ranks[0]["relower"])
    mesh = Mesh(RankGrid(4, 1), 0, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {"data": None, "stage": None})
    part = RulePartitioner(mesh, TABLES["zero3"])
    assert part.with_mesh(mesh).table is part.table
    with pytest.raises(NotImplementedError, match="A12"):
        elastic.relower("zero3-rules", mesh, model=None, loss_fn=None, optimizer=None)


def _abstract_mesh(n):
    """A rank-0 view of an ``n``-rank data axis (no world: only the axis's
    size and index are read)."""
    return Mesh(RankGrid(n, 1), 0, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {"data": None, "stage": None})


@pytest.mark.parametrize("kind", KINDS)
def test_zero_resume_template_abstract_matches_concrete(kind):
    """The allocation-free template carries exactly the concrete one's
    shapes and dtypes, flat and layer-stacked, its rows landing on the
    mesh's device."""
    mesh = _abstract_mesh(4)
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=LR)
    t_abs = zero.zero_resume_template(_model(kind), opt, mesh, llama=kind == "llama",
                                      abstract=True)
    t_con = zero.zero_resume_template(_model(kind), opt, mesh, llama=kind == "llama")
    fa, fc = pytree.flatten_with_path(t_abs), pytree.flatten_with_path(t_con)
    assert [p for p, _ in fa] == [p for p, _ in fc]
    for (path, a), (_, c) in zip(fa, fc):
        assert tuple(a.shape) == tuple(c.shape) and a.dtype == c.dtype, path
        if isinstance(a, reshard.Rows):
            assert a.local.device.type == "meta" and a.device == c.device, path


# --------------------------------------------------------- no world needed


def test_signal_kind_grammar_matrix():
    """The port's parser accepts and refuses what JAX's does, over
    ``test_elastic.py``'s matrix and ``test_ft.py``'s specs, and returns
    the same faults."""
    from ddl25spring_tpu.ft import chaos as jchaos

    good = ["traffic_spike@8", "traffic_spike@8:16", "capacity_change@5:4",
            "device_loss@3,capacity_change@5:2", "sigterm@12", "kill@7, nan_grad@5",
            "traffic_spike@8:16,capacity_change@5:4", "", None, "kill@0,,sigterm@3"]
    bad = ["sigterm@5:2", "capacity_change@5:", "capacity_change@5:x", "capacity_change@5:0",
           "traffic_spike", "traffic_spike@:4", "boom@3", "sigterm", "sigterm@", "sigterm@x",
           "sigterm@-1", "kill@1:1", "nan_grad@2:3", "capacity_change@-1:2"]
    for spec in good:
        got = [(f.kind, f.step, f.arg, f.key) for f in parse_chaos(spec)]
        want = [(f.kind, f.step, f.arg, f.key) for f in jchaos.parse_chaos(spec)]
        assert got == want, spec
    for spec in bad:
        with pytest.raises(ValueError):
            jchaos.parse_chaos(spec)
        with pytest.raises(ValueError):
            parse_chaos(spec)
    assert Fault("capacity_change", 5, 4).key == "capacity_change@5:4"
    assert Fault("traffic_spike", 8).key == "traffic_spike@8"


def test_take_journals_one_shot_and_on_step_skips_signals(tmp_path):
    spec = "traffic_spike@2:8,capacity_change@2:4,device_loss@2"
    ci = ChaosInjector(parse_chaos(spec), state_dir=tmp_path)
    ci.on_step(2, skip=("device_loss",))  # signals skipped, the loss claimed
    assert len(ci.pending()) == 3
    taken = ci.take(2)
    assert sorted(f.kind for f in taken) == ["capacity_change", "traffic_spike"]
    assert taken[0].arg in (8, 4)
    (loss,) = ci.take(2, kinds=("device_loss",))
    assert loss.kind == "device_loss"
    assert not ci.pending()
    ci2 = ChaosInjector(parse_chaos(spec), state_dir=tmp_path)
    assert not ci2.pending()
    assert ci2.take(2) == ()


def _refit_cases():
    true = np.arange(1, 38, dtype=np.float32)
    saved = np.zeros(40, np.float32)
    saved[:37] = true
    saved = saved.reshape(8, 5)
    stacked = np.stack([saved, 2 * saved])
    return saved, stacked, [
        (saved, (4, 10)),      # shrink 8 -> 4
        (saved, (16, 3)),      # grow 8 -> 16
        (stacked, (2, 4, 10)),  # [L, n, k]
        (saved, (8, 5)),       # same shape
    ]


def test_live_fast_path_equals_copy_path():
    """``reshard_leaf`` on tensors (the device path) is bitwise the numpy
    path and JAX's, shrink, grow, the [L, n, k] stack and a pass-through,
    and refuses a nonzero truncation with JAX's words."""
    import jax.numpy as jnp

    from ddl25spring_tpu.ft import reshard as jreshard

    saved, stacked, cases = _refit_cases()
    for src, shape in cases:
        want = np.asarray(jreshard.reshard_leaf(src, jnp.zeros(shape, jnp.float32), "w"))
        via_np = reshard.reshard_leaf(src, np.zeros(shape, np.float32), "w")
        via_dev = reshard.reshard_leaf(torch.from_numpy(src), torch.zeros(shape), "w")
        assert isinstance(via_np, np.ndarray) and torch.is_tensor(via_dev)
        assert np.array_equal(via_np, want) and np.array_equal(via_dev.numpy(), want)
    for src, shape, name in ((saved, (2, 10), "w"), (stacked, (2, 2, 10), "b")):
        # each path words its refusal as JAX's twin path does (its live path
        # counts the whole stack's casualties per layer)
        for port_src, jax_src in ((src, src), (torch.from_numpy(src), jnp.asarray(src))):
            with pytest.raises(ValueError, match="nonzero") as jerr:
                jreshard.reshard_leaf(jax_src, jnp.zeros(shape), name)
            with pytest.raises(ValueError, match="nonzero") as err:
                reshard.reshard_leaf(port_src, np.zeros(shape, np.float32), name)
            assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="cannot reshard"):
        reshard.reshard_leaf(torch.from_numpy(saved), torch.zeros(40), "w")
    assert reshard.SAVED_SHARD_DIMS == jreshard.SAVED_SHARD_DIMS == {2: 0, 3: 1}


def test_rows_template_takes_its_own_row():
    """A template :class:`Rows` of index ``i`` of ``m`` gets row ``i`` of the
    refit ``[m, k']``, on its device, from a saved ``[n, k]``."""
    saved, _, _ = _refit_cases()
    want = reshard.reshard_leaf(saved, np.zeros((4, 10), np.float32))
    for i in range(4):
        tmpl = reshard.Rows(torch.empty((1, 10), device="meta"), 4, i, device=torch.device("cpu"))
        got = reshard.reshard_leaf(torch.from_numpy(saved), tmpl)
        assert isinstance(got, reshard.Rows) and got.shape == (4, 10)
        assert np.array_equal(got.local.numpy(), want[i:i + 1])


def test_autosaver_note_reshape_refreshes_leaf_shapes(tmp_path):
    saver = AutoSaver(tmp_path / "ck", save_every=1, async_save=False)
    saver.save(0, resume_bundle({"w": torch.ones((8, 4))}, {}))
    man = read_manifest(tmp_path / "ck")
    assert (8, 4) in [tuple(s) for s, _ in man["leaf_shapes"]]
    saver.note_reshape(old={"data": 8}, new={"data": 4}, step=1)
    saver.save(1, resume_bundle({"w": torch.ones((4, 8))}, {}))
    saver.close()
    man = read_manifest(tmp_path / "ck")
    shapes = [tuple(s) for s, _ in man["leaf_shapes"]]
    assert (4, 8) in shapes and (8, 4) not in shapes
    assert man["meta"]["reshape"]["new"] == {"data": 4}


def test_surviving_devices_bounds():
    devices = list(range(8))
    assert len(elastic.surviving_devices(devices, lose=4)) == 4
    assert len(elastic.surviving_devices(devices, size=2)) == 2
    with pytest.raises(ValueError):
        elastic.surviving_devices(devices, lose=8)
    with pytest.raises(ValueError):
        elastic.surviving_devices(devices, size=9)
