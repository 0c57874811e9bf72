"""The port's ZeRO stages 1, 2 and 3 against the JAX package's, on the CPU.

One spawned gloo world of 4 ranks runs every case, ``Mesh.regrid`` giving
the ``n = 2`` runs (a 2 x 2 grid: two DP lines of 2 ranks, each the same
run); the JAX references compile and run on as many CPU devices meanwhile.
The cases follow ``tests/test_zero.py`` and the ZeRO cases of
``tests/test_bucketing.py``:

- ZeRO-3 over ``MnistCnn`` (``train=False``, ``nll_loss``, 64 rows) at
  ``n`` = 2 and 4, SGD with momentum 0.9 at 0.1 and Adam at 1e-3, 3 steps,
  against JAX's plain DP: losses rtol 1e-5, parameters atol 2e-5 + rtol
  2e-5 (the rows unsharded and moved to flax's layout);
- grad accumulation, ``M`` = 2 and 4, against the full batch (n = 2, the
  JAX test's tolerances);
- ``zero_clip_by_global_norm`` at 0.05 (it clips) and 1e4 (it passes),
  Adam 1e-2, 3 steps, on the tiny MLP at n = 4, against JAX's replicated DP
  with ``optax.chain(clip_by_global_norm, adam)``: atol 2e-5 + rtol 2e-5
  (``test_zero.py:150`` runs MnistCnn; across the two frameworks, 3 Adam
  steps at 1e-2 on its relus put single elements 1e-4 apart, clip or none,
  where the tanh MLP has no branch to take);
- ZeRO-1 and ZeRO-2 on the tiny MLP (n = 4, Adam 1e-2, 3 steps) against
  JAX's plain DP, atol 2e-6 + rtol 2e-6, each Adam moment one ``[1, k]`` row;
- bucketed against per-leaf, bitwise, for stages 1, 2 and 3;
- overlap against sync for stages 1, 2 and 3 (several buckets): the port's
  overlap held to its own sync step, and its sync step to JAX's sync
  ``make_zero_partitioned_train_step`` / ``make_zero_dp_train_step``,
  atol 2e-6 + rtol 2e-6 (JAX's overlapped stage 1 is not the reference:
  ``test_bucketing.py::test_zero_overlap_equals_sync[1]`` fails there);
- the LLaMA ZeRO-3 step, ``prefetch`` True and False, on JAX's
  ``_llama_workload`` config against JAX's plain DP (loss rtol 1e-5,
  parameters atol 2e-5 + rtol 2e-5), one row per layer and leaf;
- the switch-MoE LLaMA under ZeRO-3 with 2 microbatches: the loss halves in
  15 steps (``test_zero.py:213``);
- the bytes staged per step on the staged transport (forced on the CPU)
  equal the count from the row shapes;
- and, with no world: the rows bitwise equal to JAX's ``zero_shard_params``
  and ``zero_shard_llama_params`` both ways, each rank's bytes at most
  ``total / n + 1024``, padding that stays zero, the refusals.

Adam's ``eps`` is ``EPS`` = 1e-6 on both sides, as in ``test_torch_sp.py``
and ``test_torch_tp.py``: at the default 1e-8, Adam turns a gradient at
rounding-noise size into a move of up to its learning rate either way, and
one ``Conv_0`` kernel element moved 3e-5 apart at n = 2.  Inputs come from
``numpy.random.default_rng`` seeds and the port models' seeded draws.  The ranks import this module, so it imports jax only inside
the fixtures and tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models import llama, mnist_cnn  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss, nll_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel import dp, zero  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid, init_mesh  # noqa: E402

ROWS = 64
_rng = np.random.default_rng(0)
CNN_X = _rng.normal(size=(ROWS, 28, 28, 1)).astype(np.float32)
CNN_Y = _rng.integers(0, 10, ROWS).astype(np.int64)
EPS = 1e-6                # Adam's eps on both sides (see the module's docstring)
OPTS = {"sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=EPS)}
CLIPS = (0.05, 1e4)
MLP_X = np.random.default_rng(8).normal(size=(32, 16)).astype(np.float32)
MLP_Y = np.random.default_rng(9).normal(size=(32, 4)).astype(np.float32)
SMALL_BUCKETS = 256       # splits the tiny MLP into 3 buckets (one a leaf, w1 alone)
# JAX's _llama_workload(4) config, and test_zero.py:213's MoE one
LLAMA = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=4, ctx_size=16, dtype="float32")
MOE = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16, dtype="float32",
           n_experts=4, capacity_factor=2.0)
LLAMA_TOKENS = np.random.default_rng(1).integers(0, 64, (8, 16)).astype(np.int64)


def _cnn():
    return mnist_cnn.MnistCnn(generator=torch.Generator().manual_seed(0))


def _cnn_loss(model, batch):
    x, y = batch
    return nll_loss(model(x), y)


def _mlp():
    model = dp.TinyMlp()
    g = np.random.default_rng(7)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.1 * g.normal(size=tuple(p.shape)).astype(np.float32)))
    return model


def _llama(cfg=LLAMA, seed=0):
    return llama.Llama(LlamaConfig(**cfg), device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _moe_loss(model, tokens):
    logits, aux = llama.llama_forward_with_aux(model, tokens, model.cfg)
    return causal_lm_loss(logits, tokens) + model.cfg.moe_aux_weight * aux


class HostStaged(Comm):
    """The staged transport forced on the CPU (unpinned buffers, nothing to
    settle), so the bytes it stages can be counted without a card."""

    def __init__(self):
        super().__init__("gloo", torch.device("cpu"))
        self.staged = True

    def _buffer(self, shape, dtype, slot=None):
        key = (tuple(shape), dtype, slot)
        if key not in self._host:
            self._host[key] = torch.empty(key[0], dtype=dtype)
        return self._host[key]

    def _settle(self):
        pass


def _rows(rows):
    return [r.detach().numpy().copy() for r in rows]


def _run(step, batch, steps=3):
    return [float(step(batch)) for _ in range(steps)]


def zero_rank(rdv):
    """Every case of the world: losses and this rank's rows (numpy)."""
    cnn = (torch.from_numpy(CNN_X), torch.from_numpy(CNN_Y))
    mlp = (torch.from_numpy(MLP_X), torch.from_numpy(MLP_Y))
    tokens = torch.from_numpy(LLAMA_TOKENS)
    out = {}
    with init_mesh(rdv, 4, stages=1, device="cpu") as mesh:
        meshes = {4: mesh, 2: mesh.regrid(2, stages=2)}
        for n, opt in [(n, o) for n in (2, 4) for o in OPTS]:
            m = _cnn()
            rows = zero.zero_shard_params(m, meshes[n])
            step = zero.make_zero_dp_train_step(m, _cnn_loss, OPTS[opt](rows), meshes[n], rows)
            out["cnn", n, opt] = (_run(step, cnn), _rows(rows))
        for M in (1, 2, 4):
            m = _cnn()
            rows = zero.zero_shard_params(m, meshes[2])
            step = zero.make_zero_dp_train_step(m, _cnn_loss, OPTS["sgd"](rows), meshes[2], rows,
                                                num_microbatches=M)
            out["accum", M] = (_run(step, cnn, 1), _rows(rows))
        for clip in CLIPS:
            m = _mlp()
            rows = zero.zero_shard_params(m, mesh)
            step = zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss,
                                                torch.optim.Adam(rows, lr=1e-2, eps=EPS), mesh,
                                                rows, max_grad_norm=clip)
            out["clip", clip] = (_run(step, mlp), _rows(rows))
        for stage in (1, 2, 3):
            for kw in ({"bucket_bytes": None}, {}, {"bucket_bytes": SMALL_BUCKETS},
                       {"bucket_bytes": SMALL_BUCKETS, "overlap": True}):
                m = _mlp()
                rows = zero.zero_shard_params(m, mesh)
                opt = torch.optim.Adam(rows, lr=1e-2, eps=EPS)
                if stage == 3:
                    step = zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, opt, mesh, rows, **kw)
                else:
                    step = zero.make_zero_partitioned_train_step(m, dp.tiny_mlp_loss, opt, mesh,
                                                                 rows, stage=stage, **kw)
                losses = _run(step, mlp)
                params = (_rows(rows) if stage == 3 else
                          [p.detach().numpy().copy() for p in dp.param_leaves(m)])
                state = [tuple(opt.state[r]["exp_avg"].shape) for r in rows]
                out["mlp", stage, tuple(sorted(kw.items()))] = (losses, params, state)
        for prefetch in (True, False):
            m = _llama()
            rows = zero.zero_shard_llama_params(m, mesh)
            opt = torch.optim.Adam(rows.parameters(), lr=1e-2, eps=EPS)
            step = zero.make_zero3_llama_train_step(m, opt, mesh, rows, prefetch=prefetch)
            losses = _run(step, tokens)
            state = [[tuple(opt.state[r]["exp_avg"].shape) for r in layer] for layer in rows.blocks]
            out["llama", prefetch] = (losses, _llama_rows_np(rows), state)
        m = _llama(MOE)
        rows = zero.zero_shard_params(m, mesh)
        step = zero.make_zero_dp_train_step(m, _moe_loss, torch.optim.Adam(rows, lr=1e-2),
                                            mesh, rows, num_microbatches=2)
        out["moe"] = _run(step, tokens, 15)
        staged = HostStaged()
        mesh.comm = staged
        for name, make in _STAGED.items():
            make_step, batch = make(mesh)
            make_step(batch)
            staged.take_stats()
            make_step(batch)
            out["staged", name] = staged.take_stats()["bytes_staged"]
    return out


def _llama_rows_np(rows):
    return zero.LlamaRows(_rows(rows.outer), [_rows(layer) for layer in rows.blocks])


def _staged_cnn(mesh):
    m = _cnn()
    rows = zero.zero_shard_params(m, mesh)
    return (zero.make_zero_dp_train_step(m, _cnn_loss, OPTS["sgd"](rows), mesh, rows,
                                         num_microbatches=2),
            (torch.from_numpy(CNN_X), torch.from_numpy(CNN_Y)))


def _staged_llama(prefetch):
    def make(mesh):
        m = _llama()
        rows = zero.zero_shard_llama_params(m, mesh)
        return (zero.make_zero3_llama_train_step(m, torch.optim.Adam(rows.parameters()), mesh,
                                                 rows, prefetch=prefetch, max_grad_norm=1.0),
                torch.from_numpy(LLAMA_TOKENS))
    return make


_STAGED = {"cnn": _staged_cnn, "llama prefetch": _staged_llama(True),
           "llama remat": _staged_llama(False)}


# ------------------------------------------------------------ references


def _cnn_params():
    return mnist_cnn.export_params(_cnn())


def _jax_cnn(devices8):
    """JAX's plain DP over the same MnistCnn weights and rows: SGD and Adam at
    n = 2 and 4, 3 steps."""
    import jax
    import optax

    from ddl25spring_tpu.models.mnist_cnn import MnistCnn
    from ddl25spring_tpu.ops.losses import nll_loss as j_nll
    from ddl25spring_tpu.parallel.dp import make_dp_train_step
    from ddl25spring_tpu.utils.mesh import make_mesh

    model = MnistCnn()

    def loss_fn(p, batch, key):
        x, y = batch
        return j_nll(model.apply({"params": p}, x, train=False), y)

    txs = {("cnn", n, "sgd"): (n, optax.sgd(0.1, momentum=0.9)) for n in (2, 4)}
    txs.update({("cnn", n, "adam"): (n, optax.adam(1e-3, eps=EPS)) for n in (2, 4)})
    refs = {}
    for key, (n, tx) in txs.items():
        step = make_dp_train_step(loss_fn, tx, make_mesh(devices8[:n], data=n),
                                  per_shard_rng=False, instrument=False, donate=False,
                                  sentinel=False)
        p = _cnn_params()
        state, losses = tx.init(p), []
        for _ in range(3):
            p, state, loss = step(p, state, (CNN_X, CNN_Y.astype(np.int32)),
                                  jax.random.PRNGKey(0))
            losses.append(float(loss))
        refs[key] = (losses, jax.tree.map(np.asarray, p))
    return refs


def _mlp_tree():
    m = _mlp()
    return {k: v.detach().numpy().copy() for k, v in m.param_tree().items()}


def _jax_mlp(devices8):
    """JAX's plain DP, its sync ZeRO stages 1, 2 and 3 (the port's small
    buckets) and its plain DP with ``optax.chain(clip_by_global_norm(c),
    adam)`` on the tiny MLP at n = 4, Adam 1e-2, 3 steps."""
    import jax
    import optax

    from ddl25spring_tpu.parallel.dp import _tiny_mlp_workload, make_dp_train_step
    from ddl25spring_tpu.parallel.zero import (
        make_zero_dp_train_step,
        make_zero_partitioned_train_step,
        zero_shard_params,
        zero_unshard_params,
    )
    from ddl25spring_tpu.utils.mesh import make_mesh

    mesh = make_mesh(devices8[:4], data=4)
    _, loss_fn, _, _ = _tiny_mlp_workload(4)
    tx, key, batch = optax.adam(1e-2, eps=EPS), jax.random.PRNGKey(0), (MLP_X, MLP_Y)
    params = _mlp_tree()
    kw = dict(per_shard_rng=False, donate=False, sentinel=False)
    refs = {}
    for name in ("dp", 1, 2, 3, *(("clip", c) for c in CLIPS)):
        if name == "dp" or isinstance(name, tuple):
            if name != "dp":
                tx = optax.chain(optax.clip_by_global_norm(name[1]), optax.adam(1e-2, eps=EPS))
            step = make_dp_train_step(loss_fn, tx, mesh, instrument=False, **kw)
            p, state = params, tx.init(params)
        elif name == 3:
            step = make_zero_dp_train_step(loss_fn, tx, mesh, params, instrument=False,
                                           bucket_bytes=SMALL_BUCKETS, **kw)
            p = zero_shard_params(params, mesh)
            state = tx.init(p)
        else:
            step = make_zero_partitioned_train_step(loss_fn, tx, mesh, params, stage=name,
                                                    bucket_bytes=SMALL_BUCKETS, **kw)
            p, state = params, tx.init(zero_shard_params(params, mesh))
        losses = []
        for _ in range(3):
            p, state, loss = step(p, state, batch, key)
            losses.append(float(loss))
        if name == 3:
            p = zero_unshard_params(jax.device_get(p), params)
        refs[name] = (losses, jax.tree.map(np.asarray, p))
    return refs


def _jax_llama(devices8):
    """JAX's plain DP on the LLaMA workload: 3 Adam steps at 1e-2."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss as j_lm
    from ddl25spring_tpu.parallel.dp import make_dp_train_step
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    cfg = jconfig.LlamaConfig(**LLAMA)

    def loss_fn(p, t, key):
        return j_lm(jllama.llama_forward(p, t, cfg), t)

    tx = optax.adam(1e-2, eps=EPS)
    step = make_dp_train_step(loss_fn, tx, make_mesh(devices8[:4], data=4), per_shard_rng=False,
                              instrument=False, donate=False, sentinel=False)
    p = llama.export_params(_llama())
    state, losses = tx.init(p), []
    for _ in range(3):
        p, state, loss = step(p, state, LLAMA_TOKENS.astype(np.int32), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, zero_rank, 4, timeout=240,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = {"cnn": _jax_cnn(devices8), "mlp": _jax_mlp(devices8),
                "llama": _jax_llama(devices8)}
        return ranks.result(), refs


def _gathered(ranks, key, n):
    """Leaf ``j``'s ``[n, k]`` rows of the DP line of rank 0: ranks ``0..n-1``
    on the 1 x 4 grid, ranks 0 and 2 on the 2 x 2 one."""
    line = [0, 1, 2, 3] if n == 4 else [0, 2]
    per_rank = [ranks[r][key][1] for r in line]
    return [np.concatenate([rows[j] for rows in per_rank]) for j in range(len(per_rank[0]))]


def _cnn_tree(rows):
    """Gathered rows of a ZeRO MnistCnn -> its flax params tree."""
    m = _cnn()
    with torch.no_grad():
        for p, a in zip(m.parameters(), zero.zero_unshard_params(rows, m), strict=True):
            p.copy_(torch.from_numpy(a))
    return mnist_cnn.export_params(m)


def _close(got: dict, want: dict, atol, rtol):
    got, want = flatten(got), flatten(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol,
                                   err_msg=path)


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("opt", list(OPTS))
def test_zero3_equals_jax_plain_dp(runs, n, opt):
    ranks, refs = runs
    losses, _ = ranks[0]["cnn", n, opt]
    want_losses, want = refs["cnn"]["cnn", n, opt]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(_cnn_tree(_gathered(ranks, ("cnn", n, opt), n)), want, 2e-5, 2e-5)
    if n == 4:
        # Dense_1's bias, 10 elements in rows of 3: the last rank's row ends
        # in 2 padded slots, which stay exactly zero
        assert np.array_equal(ranks[3]["cnn", n, opt][1][-1][0, 1:], np.zeros(2, np.float32))


@pytest.mark.parametrize("M", [2, 4])
def test_zero3_grad_accum_equals_full_batch(runs, M):
    ranks, _ = runs
    (l1,), _ = ranks[0]["accum", 1]
    (lm,), _ = ranks[0]["accum", M]
    np.testing.assert_allclose(lm, l1, rtol=1e-5)
    for a, b in zip(_gathered(ranks, ("accum", M), 2), _gathered(ranks, ("accum", 1), 2)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("clip", CLIPS)
def test_zero_global_norm_clip_equals_replicated(runs, clip):
    ranks, refs = runs
    losses, _ = ranks[0]["clip", clip]
    want_losses, want = refs["mlp"]["clip", clip]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    leaves = dp.param_leaves(_mlp())
    got = zero.zero_unshard_params(_gathered(ranks, ("clip", clip), 4), leaves)
    _close(dict(zip(("b1", "w1", "w2"), got, strict=True)), want, 2e-5, 2e-5)
    # 0.05 clips (the updates differ from the unclipped run's), 1e4 does not
    assert ranks[0]["clip", 0.05][0][1:] != ranks[0]["clip", 1e4][0][1:]


def _mlp_case(ranks, stage, **kw):
    return [r["mlp", stage, tuple(sorted(kw.items()))] for r in ranks]


def _mlp_params(ranks, stage, **kw):
    """The tiny MLP's ``param_tree`` after a case, numpy, by key."""
    results = _mlp_case(ranks, stage, **kw)
    leaves = dp.param_leaves(_mlp())
    if stage == 3:
        rows = [np.concatenate([r[1][j] for r in results]) for j in range(len(leaves))]
        values = zero.zero_unshard_params(rows, leaves)
    else:
        values = results[0][1]
    return dict(zip(("b1", "w1", "w2"), values, strict=True))     # flatten order


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_stage12_equals_jax_plain_dp(runs, stage):
    ranks, refs = runs
    losses = _mlp_case(ranks, stage)[0][0]
    want_losses, want = refs["mlp"]["dp"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(_mlp_params(ranks, stage), want, 2e-6, 2e-6)
    for r in ranks:
        # Adam's moments: one [1, k] row per leaf (b1, w1, w2) on every rank
        assert r["mlp", stage, ()][2] == [(1, 32 // 4), (1, 16 * 32 // 4), (1, 32 * 4 // 4)]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_bucketed_equals_per_leaf_bitwise(runs, stage):
    ranks, _ = runs
    for r in ranks:
        for kw in ({}, {"bucket_bytes": SMALL_BUCKETS}):
            (la, pa, _), (lb, pb, _) = r["mlp", stage, tuple(kw.items())], \
                r["mlp", stage, (("bucket_bytes", None),)]
            assert la == lb
            for x, y in zip(pa, pb, strict=True):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_overlap_equals_sync(runs, stage):
    ranks, refs = runs
    sync = _mlp_params(ranks, stage, bucket_bytes=SMALL_BUCKETS)
    over = _mlp_params(ranks, stage, bucket_bytes=SMALL_BUCKETS, overlap=True)
    ls = _mlp_case(ranks, stage, bucket_bytes=SMALL_BUCKETS)[0][0]
    lo = _mlp_case(ranks, stage, bucket_bytes=SMALL_BUCKETS, overlap=True)[0][0]
    np.testing.assert_allclose(lo, ls, rtol=1e-6)
    _close(over, sync, 2e-6, 2e-6)
    want_losses, want = refs["mlp"][stage]
    np.testing.assert_allclose(ls, want_losses, rtol=1e-5)
    _close(sync, want, 2e-6, 2e-6)


@pytest.mark.parametrize("prefetch", [True, False])
def test_zero3_llama_equals_jax_plain_dp(runs, prefetch):
    ranks, refs = runs
    losses, _, state = ranks[0]["llama", prefetch]
    want_losses, want = refs["llama"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    shards = zero.llama_rows_to_jax([r["llama", prefetch][1] for r in ranks], _llama())
    _close(zero.zero_unshard_llama_params(shards, _llama()), want, 2e-5, 2e-5)
    # one row per layer and leaf, and its Adam moment of the same shape
    rows = ranks[0]["llama", prefetch][1]
    assert len(rows.blocks) == LLAMA["n_layers"]
    assert state == [[r.shape for r in layer] for layer in rows.blocks]
    assert all(r.shape[0] == 1 for layer in rows.blocks for r in layer)


def test_zero3_moe_llama_loss_halves(runs):
    ranks, _ = runs
    losses = ranks[0]["moe"]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses[::5]
    assert all(r["moe"] == losses for r in ranks)


def _row_bytes(leaves, n):
    return sum(zero.row_elems(l, n) * 4 for l in leaves)


def test_staged_bytes_equal_the_row_shapes(runs):
    """Per staged gather or reduce-scatter a rank moves its row to the host
    and the ``[n, K]`` result back, or the reverse: ``(n + 1) * K`` elements.
    ZeRO-3 over MnistCnn with 2 microbatches gathers and scatters twice; the
    LLaMA step gathers the outer leaves and each layer (twice under remat),
    scatters each once, and its clip all-reduces one float32; the loss's
    mean is one more."""
    ranks, _ = runs
    n = 4
    cnn = _row_bytes(dp.param_leaves(_cnn()), n)
    outer, layers = zero._llama_leaves(_llama())
    top = _row_bytes([v for _, v in outer], n)
    layer = _row_bytes([v for _, v in layers[0]], n)
    L = len(layers)
    want = {"cnn": 2 * 2 * (n + 1) * cnn + 8,
            "llama prefetch": 2 * (n + 1) * (top + L * layer) + 8 + 8,
            "llama remat": 2 * (n + 1) * top + 3 * (n + 1) * L * layer + 8 + 8}
    for r in ranks:
        assert {k: r["staged", k] for k in want} == want


# ------------------------------------------------------ with no world


def _mesh(n, index=0):
    """One rank's view of a ``data = n`` grid, for code that only reads the
    axis (no world is joined)."""
    grid = RankGrid(n, 1)
    return Mesh(grid, index, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {name: None for name in grid.names})


def test_rows_equal_jax_zero_shard_params_both_ways(devices8):
    """MnistCnn's rows, unsharded and moved to flax's layout, shard in JAX to
    the rows JAX shards from the same weights, and back; a LLaMA's rows are
    JAX's own, stacked leaf and all."""
    import jax

    from ddl25spring_tpu.parallel.zero import zero_shard_params, zero_unshard_params
    from ddl25spring_tpu.utils.mesh import make_mesh

    n = 4
    jmesh = make_mesh(devices8[:n], data=n)
    model = _cnn()
    rows = [zero.zero_shard_params(model, _mesh(n, i)) for i in range(n)]
    gathered = [np.concatenate([_rows(r)[j] for r in rows]) for j in range(len(rows[0]))]
    want = jax.device_get(zero_shard_params(_cnn_params(), jmesh))
    got = jax.device_get(zero_shard_params(_cnn_tree(gathered), jmesh))
    for (path, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
        assert np.array_equal(a, b), path
    # JAX's rows -> the flax tree -> the port's model -> its rows
    back = _cnn()
    mnist_cnn.load_flax_params(back, jax.tree.map(np.asarray,
                                                  zero_unshard_params(want, _cnn_params())))
    for i in range(n):
        for a, b in zip(zero.zero_shard_params(back, _mesh(n, i)), rows[i], strict=True):
            assert torch.equal(a, b)
    # LLaMA: the generic rows are JAX's directly
    m = _llama()
    rows = [_rows(zero.zero_shard_params(m, _mesh(n, i))) for i in range(n)]
    want = jax.device_get(zero_shard_params(llama.export_params(m), jmesh))
    for j, (path, b) in enumerate(flatten(want)):
        assert np.array_equal(np.concatenate([r[j] for r in rows]), b), path


def test_llama_rows_equal_jax_zero_shard_llama_params_both_ways(devices8):
    import jax

    from ddl25spring_tpu.parallel.zero import zero_shard_llama_params
    from ddl25spring_tpu.utils.mesh import make_mesh

    n = 4
    for cfg in (LLAMA, MOE):
        m = _llama(cfg)
        rows = [zero.zero_shard_llama_params(m, _mesh(n, i)) for i in range(n)]
        want = jax.device_get(zero_shard_llama_params(llama.export_params(m),
                                                      make_mesh(devices8[:n], data=n)))
        got = zero.llama_rows_to_jax(rows, m)
        for (path, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
            assert np.array_equal(a, np.asarray(b)), path
        for i in range(n):
            back = zero.llama_rows_from_jax(jax.tree.map(np.asarray, want), m, i, "cpu")
            for a, b in zip(back.parameters(), rows[i].parameters(), strict=True):
                assert torch.equal(a, b)
        for (path, a), (_, b) in zip(flatten(zero.zero_unshard_llama_params(got, m)),
                                     flatten(llama.export_params(m)), strict=True):
            assert np.array_equal(a, b), path


def test_per_rank_bytes_at_most_total_over_n():
    n = 8
    model = _cnn()
    total = sum(p.numel() * 4 for p in model.parameters())
    for i in range(n):
        mine = sum(r.numel() * 4 for r in zero.zero_shard_params(model, _mesh(n, i)))
        assert mine <= total / n + 1024


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_padding_stays_zero(opt):
    """A leaf whose size does not divide by n: its padded tail gets zero
    gradients and stays exactly zero through SGD with momentum, Adam and
    AdamW (decoupled weight decay keeps a zero at zero).  One process on a
    data = 1 line of a 3-slot layout: the last row holds the padding."""
    n = 3
    model = dp.TinyMlp(d_in=5, d_h=7, d_out=2)          # 35 + 7 + 14: none divides by 3
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
    rows = zero.zero_shard_params(model, _mesh(n, n - 1))
    k = [zero.row_elems(l, n) for l in dp.param_leaves(model)]
    pads = [n * kk - l.numel() for kk, l in zip(k, dp.param_leaves(model))]
    assert all(p > 0 for p in pads)
    make = {"sgd": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
            "adam": lambda ps: torch.optim.Adam(ps, lr=0.1),
            "adamw": lambda ps: torch.optim.AdamW(ps, lr=0.1, weight_decay=0.1)}[opt]
    optimizer = make(rows)
    for _ in range(3):
        for r, pad in zip(rows, pads):
            g = torch.ones_like(r)
            g[0, r.shape[1] - pad:] = 0.0       # the padding's gradient, as the gather's backward
            r.grad = g
        optimizer.step()
    for r, pad in zip(rows, pads):
        assert torch.equal(r.detach()[0, r.shape[1] - pad:], torch.zeros(pad))
        for v in optimizer.state[r].values():
            if v.dim():
                assert torch.equal(v[0, r.shape[1] - pad:], torch.zeros(pad))


def test_refusals():
    mesh = _mesh(2)
    m = dp.TinyMlp()
    rows = zero.zero_shard_params(m, mesh)
    with pytest.raises(ValueError, match="neither row-shaped nor a scalar"):
        zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, torch.optim.Adafactor(rows), mesh,
                                     rows)
    for stage in (1, 2):
        with pytest.raises(ValueError, match="neither row-shaped nor a scalar"):
            zero.make_zero_partitioned_train_step(m, dp.tiny_mlp_loss,
                                                  torch.optim.Adafactor(rows), mesh, rows,
                                                  stage=stage)
    opt = torch.optim.SGD(rows, lr=0.1)
    with pytest.raises(ValueError, match="stage must be 1 or 2"):
        zero.make_zero_partitioned_train_step(m, dp.tiny_mlp_loss, opt, mesh, rows, stage=3)
    for make in (zero.make_zero_dp_train_step, zero.make_zero_partitioned_train_step):
        with pytest.raises(ValueError, match="overlap=True needs the bucketed path"):
            make(m, dp.tiny_mlp_loss, opt, mesh, rows, bucket_bytes=None, overlap=True)
    with pytest.raises(ValueError, match="not the \\[1, k\\] rows"):
        zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, opt, _mesh(4), rows)
    from ddl25spring_tpu_torch.obs import sentinels

    with pytest.raises(ValueError, match="not one of"):  # a policy JAX refuses too
        with sentinels.scoped(True):
            sentinels._policy = "explode"
            zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, opt, mesh, rows, sentinel=True)
    lm = _llama()
    lrows = zero.zero_shard_llama_params(lm, mesh)
    with pytest.raises(ValueError, match="positive threshold"):
        zero.make_zero3_llama_train_step(lm, torch.optim.Adam(lrows.parameters()), mesh, lrows,
                                         bucket_bytes=None)


def test_the_zero3_step_frees_the_model_and_checks_microbatches():
    mesh = _mesh(1)
    m = dp.TinyMlp()
    rows = zero.zero_shard_params(m, mesh)
    step = zero.make_zero_dp_train_step(m, dp.tiny_mlp_loss, torch.optim.SGD(rows, lr=0.1),
                                        mesh, rows, num_microbatches=3)
    assert all(p.device.type == "meta" for p in m.parameters())
    with pytest.raises(ValueError, match="not divisible by num_microbatches=3"):
        step((torch.zeros(4, 16), torch.zeros(4, 4)))
