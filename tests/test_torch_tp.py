"""The port's Megatron tensor parallelism against the JAX package's, on the CPU.

One spawned gloo world of 4 ranks runs every case from the JAX package's
tiny config (``tests/test_tp.py``: vocab 64, dmodel 32, 4 heads, 2 layers,
ctx 16, fp32), from one set of numpy weights and seeded tokens:

- loss and gradients at n = 2 and 4, with ``shard_vocab`` both ways, against
  JAX's ``make_tp_loss`` on a ``model`` mesh of as many CPU devices and
  against the serial ``llama_forward`` + ``causal_lm_loss``.  Each rank's
  gradients are its slices; the test joins the slices of one replica
  (``merge_tp_params``) and compares leaf by leaf.  The n = 2 cases run on a
  2 x 2 grid without a data axis, each replica on the whole batch;
- two Adam steps of ``make_tp_train_step`` on a 2 x 2 (data, model) grid
  against JAX's step on ``mesh(data=2, model=2)``;
- each rank's ``embed``/``unembed`` holds ``V/n`` rows/columns;
- switch-MoE (the JAX tests' ``MOE_CFG``: E 4, capacity factor 1.0, so the
  global routing drops tokens): the loss at n = 2 and 4 against the serial
  composite ``causal_lm_loss + w aux`` (and n = 2 against JAX's
  ``make_tp_loss``), the
  gradients at n = 2 against the serial ones (the replicated router's
  included: its aux path and its combine path), each rank's expert slice,
  and one Adam step of the TP x DP MoE step (capacity factor 4.0) against
  JAX's.

Tolerances are the JAX tests': loss rtol 1e-5, gradients atol 2e-5,
parameters after two steps atol 1e-5, with Adam's ``eps`` = ``EPS`` on both
sides, well above the gradients' rounding noise (see ``test_torch_sp.py``).
The JAX references compile while the ranks run.  The ranks import this
module, so it imports jax only inside the fixtures and tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import tp  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Axis  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=4, n_layers=2, ctx_size=16, dtype="float32")
CFG = LlamaConfig(**TINY)
MOE = dict(TINY, n_experts=4, capacity_factor=1.0)
MOE_CFG = LlamaConfig(**MOE)
MOE_STEP_CF = 4.0               # test_tp_dp_moe_train_step's capacity factor, as JAX's
BATCHES = [np.random.default_rng(s).integers(0, 64, (4, 16)).astype(np.int32) for s in (1, 2)]
LR = 1e-3
EPS = 1e-6                      # Adam's eps on both sides
# case -> (n, shard_vocab)
CASES = {f"tp{n}{'' if sv else '-replicated-vocab'}": (n, sv)
         for n in (2, 4) for sv in (True, False)}


def _model(params, n, index, shard_vocab, cfg=CFG):
    model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return tp.load_tp_params(model, tp.shard_tp_params(params, n, index, shard_vocab))


def tp_rank(rdv, params, moe_params):
    """Every case: this rank's index, loss and gradient slices of one step
    (SGD at lr 0), its slice shapes, then the two-step Adam run; the same
    for the MoE cases, and one MoE TP x DP Adam step."""
    out = {}
    with init_mesh(rdv, 1, model=4, device="cpu") as mesh:
        grids = {4: mesh, 2: mesh.regrid(2, model=2)}
        for name, (n, sv) in CASES.items():
            axis = grids[n].axis("model")
            model = _model(params, n, axis.index, sv)
            step = tp.make_tp_train_step(model, CFG, torch.optim.SGD(model.parameters(), lr=0.0),
                                         grids[n], shard_vocab=sv)
            loss = float(step(torch.from_numpy(BATCHES[0]).long()))
            out[name] = (axis.index, loss, llama.export_grads(model),
                         (tuple(model.embed.shape), tuple(model.unembed.shape)))
        axis = grids[2].axis("model")
        model = _model(params, 2, axis.index, True)
        opt = torch.optim.Adam(model.parameters(), lr=LR, eps=EPS)
        step = tp.make_tp_train_step(model, CFG, opt, grids[2], data_axis="data")
        losses = [float(step(torch.from_numpy(b).long())) for b in BATCHES]
        out["step"] = (axis.index, losses, llama.export_params(model))
        for n in (2, 4):
            axis = grids[n].axis("model")
            model = _model(moe_params, n, axis.index, True, MOE_CFG)
            step = tp.make_tp_train_step(model, MOE_CFG,
                                         torch.optim.SGD(model.parameters(), lr=0.0), grids[n])
            loss = float(step(torch.from_numpy(BATCHES[0]).long()))
            out["moe", n] = (axis.index, loss, llama.export_grads(model))
        axis = grids[2].axis("model")
        cfg = replace(MOE_CFG, capacity_factor=MOE_STEP_CF)
        model = _model(moe_params, 2, axis.index, True, cfg)
        step = tp.make_tp_train_step(model, cfg,
                                     torch.optim.Adam(model.parameters(), lr=LR, eps=EPS),
                                     grids[2], data_axis="data")
        out["moe step"] = (axis.index, float(step(torch.from_numpy(BATCHES[0]).long())),
                           llama.export_params(model))
    return out


@pytest.fixture(scope="module")
def params():
    return llama.export_params(
        llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(3)))


@pytest.fixture(scope="module")
def moe_params():
    return llama.export_params(
        llama.Llama(MOE_CFG, device="cpu", generator=torch.Generator().manual_seed(2)))


def _jax_moe_refs(params, devices8):
    """JAX's MoE references: the serial composite loss and gradients,
    ``make_tp_loss`` at n = 2, and one step of its TP x DP MoE step."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.parallel.tp import make_tp_loss, make_tp_train_step, shard_tp_params
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    jcfg = jconfig.LlamaConfig(**MOE)

    def serial(p, t):
        logits, aux = jllama.llama_forward_with_aux(p, t, jcfg)
        return causal_lm_loss(logits, t) + jcfg.moe_aux_weight * aux

    loss, grads = jax.jit(jax.value_and_grad(serial))(params, BATCHES[0])
    refs = {"serial": (float(loss), jax.tree.map(np.asarray, grads))}
    mesh = make_mesh(devices8[:2], model=2)
    refs[2] = float(jax.jit(make_tp_loss(jcfg, mesh))(shard_tp_params(params, mesh), BATCHES[0]))
    jcfg = jconfig.LlamaConfig(**{**MOE, "capacity_factor": MOE_STEP_CF})
    tx = optax.adam(LR, eps=EPS)
    mesh = make_mesh(devices8[:4], data=2, model=2)
    p = shard_tp_params(params, mesh)
    p, _, loss = make_tp_train_step(jcfg, tx, mesh, data_axis="data")(p, tx.init(p), BATCHES[0])
    refs["step"] = (float(loss), jax.tree.map(np.asarray, p))
    return refs


def _jax_refs(params, devices8):
    """JAX's loss and gradients, serial and ``make_tp_loss`` per case, and
    two steps of its TP x DP step."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.parallel.tp import make_tp_loss, make_tp_train_step, shard_tp_params
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    jcfg = jconfig.LlamaConfig(**TINY)

    def serial(p, t):
        return causal_lm_loss(jllama.llama_forward(p, t, jcfg), t)

    refs = {"serial": jax.jit(jax.value_and_grad(serial))(params, BATCHES[0])}
    for name, (n, sv) in CASES.items():
        mesh = make_mesh(devices8[:n], model=n)
        loss = make_tp_loss(jcfg, mesh, shard_vocab=sv)
        refs[name] = jax.jit(jax.value_and_grad(loss))(
            shard_tp_params(params, mesh, shard_vocab=sv), BATCHES[0])
    refs = {k: (float(v[0]), jax.tree.map(np.asarray, v[1])) for k, v in refs.items()}
    tx = optax.adam(LR, eps=EPS)
    mesh = make_mesh(devices8[:4], data=2, model=2)
    step = make_tp_train_step(jcfg, tx, mesh, data_axis="data")
    p = shard_tp_params(params, mesh)
    state, losses = tx.init(p), []
    for b in BATCHES:
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
    refs["step"] = (losses, jax.tree.map(np.asarray, p))
    return refs


@pytest.fixture(scope="module")
def runs(params, moe_params, devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, tp_rank, 4, params, moe_params, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(params, devices8)
        refs["moe"] = _jax_moe_refs(moe_params, devices8)
        return ranks.result(), refs


@pytest.mark.parametrize("case", list(CASES))
def test_tp_loss_and_grads_match_jax(runs, case):
    ranks, refs = runs
    n, sv = CASES[case]
    for replica in ([ranks[:n]] if n == 4 else [ranks[:2], ranks[2:]]):
        results = [r[case] for r in replica]
        assert [i for i, _, _, _ in results] == list(range(n))
        grads = tp.merge_tp_params([g for _, _, g, _ in results], sv)
        for want in (refs[case], refs["serial"]):
            for _, loss, _, _ in results:
                np.testing.assert_allclose(loss, want[0], rtol=1e-5)
            for (path, a), (_, b) in zip(flatten(grads), flatten(want[1])):
                np.testing.assert_allclose(a, b, atol=2e-5, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_vocab_leaves_hold_their_share(runs, case):
    ranks, _ = runs
    n, sv = CASES[case]
    V, D = CFG.vocab_size, CFG.dmodel
    Vl = V // n if sv else V
    assert all(r[case][3] == ((Vl, D), (D, Vl)) for r in ranks)


def test_tp_dp_train_step_matches_jax(runs):
    ranks, refs = runs
    losses, want = refs["step"]
    for replica in (ranks[:2], ranks[2:]):
        assert [r["step"][0] for r in replica] == [0, 1]
        for r in replica:
            np.testing.assert_allclose(r["step"][1], losses, rtol=1e-5)
        got = tp.merge_tp_params([r["step"][2] for r in replica])
        for (path, a), (_, b) in zip(flatten(got), flatten(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_moe_loss_equals_serial(runs, tp):
    """Expert-sharded TP MoE equals the serial composite: the global routing
    and capacity-1.0 drops are computed the same on every rank."""
    ranks, refs = runs
    for r in ranks:
        _, loss, _ = r["moe", tp]
        if tp == 2:
            np.testing.assert_allclose(loss, refs["moe"][tp], rtol=1e-5)
        np.testing.assert_allclose(loss, refs["moe"]["serial"][0], rtol=1e-5)


def test_tp_moe_grads_equal_serial(runs):
    """n = 2: every gradient, the replicated router's included (its aux path
    counted once, its combine path summed over the ranks), equals the
    serial one; both replicas agree."""
    ranks, refs = runs
    want = refs["moe"]["serial"][1]
    for replica in (ranks[:2], ranks[2:]):
        results = [r["moe", 2] for r in replica]
        assert [i for i, _, _ in results] == [0, 1]
        grads = tp.merge_tp_params([g for _, _, g in results])
        assert [p for p, _ in flatten(grads)] == [p for p, _ in flatten(want)]
        for (path, a), (_, b) in zip(flatten(grads), flatten(want)):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=path)
        assert np.abs(grads["blocks"]["moe"]["router"]).max() > 0


def test_tp_moe_expert_stacks_actually_sharded(moe_params, devices8):
    """Each rank holds ``E/n`` experts of every stack and the whole router:
    the JAX ``shard_tp_params``' per-device slices, bit for bit."""
    from ddl25spring_tpu.parallel.tp import shard_tp_params
    from ddl25spring_tpu.utils.mesh import make_mesh

    for n in (2, 4):
        sharded = flatten(shard_tp_params(moe_params, make_mesh(devices8[:n], model=n)))
        for i, dev in enumerate(devices8[:n]):
            mine = tp.shard_tp_params(moe_params, n, i)
            assert mine["blocks"]["moe"]["w_gate"].shape[1] == MOE_CFG.n_experts // n
            assert mine["blocks"]["moe"]["router"].shape == moe_params["blocks"]["moe"]["router"].shape
            for (path, a), (_, b) in zip(flatten(mine), sharded):
                shard, = [s for s in b.addressable_shards if s.device == dev]
                np.testing.assert_array_equal(a, np.asarray(shard.data), err_msg=path)


def test_tp_dp_moe_train_step(runs):
    """2 x 2 (data x model) with MoE blocks: one Adam step equals JAX's (each
    data row routes its own half-batch)."""
    ranks, refs = runs
    loss, want = refs["moe"]["step"]
    for replica in (ranks[:2], ranks[2:]):
        assert [r["moe step"][0] for r in replica] == [0, 1]
        for r in replica:
            np.testing.assert_allclose(r["moe step"][1], loss, rtol=1e-5)
        got = tp.merge_tp_params([r["moe step"][2] for r in replica])
        for (path, a), (_, b) in zip(flatten(got), flatten(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("shard_vocab", [True, False])
def test_sharding_then_merging_gives_the_tree_back_bitwise(params, moe_params, shard_vocab):
    for tree in (params, moe_params):
        _shard_and_merge(tree, shard_vocab)


def _shard_and_merge(params, shard_vocab):
    for n in (1, 2, 4):
        shards = [tp.shard_tp_params(params, n, i, shard_vocab) for i in range(n)]
        merged = tp.merge_tp_params(shards, shard_vocab)
        assert [p for p, _ in flatten(merged)] == [p for p, _ in flatten(params)]
        for (path, a), (_, b) in zip(flatten(merged), flatten(params)):
            assert a.dtype == b.dtype and np.array_equal(a, b), path


class _Grid:
    """A stand-in mesh that names a model axis of ``n`` ranks, for the
    checks made before any exchange."""

    def __init__(self, n):
        self.n = n

    def axis(self, name):
        return Axis(name, None, None, tuple(range(self.n)), 0)


def test_tp_refusals():
    # the experts must split over the model axis
    with pytest.raises(ValueError, match="not divisible"):
        tp.make_tp_loss(replace(MOE_CFG, n_experts=3), _Grid(2))
    tp.make_tp_loss(MOE_CFG, _Grid(2))
    # a MoE block under TP needs make_tp_moe_fn's partial output
    model = llama.Llama(MOE_CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="make_tp_moe_fn"):
        llama.block_forward(model.blocks[0], torch.zeros(1, 4, 32), MOE_CFG,
                            tp_axis=_Grid(2).axis("model"))
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_tp_params(llama.export_params(llama.Llama(
            CFG, device="cpu", generator=torch.Generator().manual_seed(0))), 3, 0)
    model = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    from ddl25spring_tpu_torch.obs import sentinels

    with pytest.raises(ValueError, match="not one of"):  # a policy JAX refuses too
        with sentinels.scoped(True):
            sentinels._policy = "explode"
            tp.make_tp_train_step(model, CFG, torch.optim.SGD(model.parameters(), lr=0.1),
                                  None, sentinel=True)
