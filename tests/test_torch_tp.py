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
- each rank's ``embed``/``unembed`` holds ``V/n`` rows/columns.

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

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import tp  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=4, n_layers=2, ctx_size=16, dtype="float32")
CFG = LlamaConfig(**TINY)
BATCHES = [np.random.default_rng(s).integers(0, 64, (4, 16)).astype(np.int32) for s in (1, 2)]
LR = 1e-3
EPS = 1e-6                      # Adam's eps on both sides
# case -> (n, shard_vocab)
CASES = {f"tp{n}{'' if sv else '-replicated-vocab'}": (n, sv)
         for n in (2, 4) for sv in (True, False)}


def _model(params, n, index, shard_vocab):
    model = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return tp.load_tp_params(model, tp.shard_tp_params(params, n, index, shard_vocab))


def tp_rank(rdv, params):
    """Every case: this rank's index, loss and gradient slices of one step
    (SGD at lr 0), its slice shapes, then the two-step Adam run."""
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
    return out


@pytest.fixture(scope="module")
def params():
    return llama.export_params(
        llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(3)))


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
def runs(params, devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, tp_rank, 4, params, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(params, devices8)
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


@pytest.mark.parametrize("shard_vocab", [True, False])
def test_sharding_then_merging_gives_the_tree_back_bitwise(params, shard_vocab):
    for n in (1, 2, 4):
        shards = [tp.shard_tp_params(params, n, i, shard_vocab) for i in range(n)]
        merged = tp.merge_tp_params(shards, shard_vocab)
        assert [p for p, _ in flatten(merged)] == [p for p, _ in flatten(params)]
        for (path, a), (_, b) in zip(flatten(merged), flatten(params)):
            assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_tp_refusals():
    with pytest.raises(NotImplementedError, match="EP slice"):
        tp.make_tp_loss(replace(CFG, n_experts=4), None)
    with pytest.raises(NotImplementedError, match="EP slice"):
        tp.make_tp_moe_fn()
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_tp_params(llama.export_params(llama.Llama(
            CFG, device="cpu", generator=torch.Generator().manual_seed(0))), 3, 0)
    model = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tp.make_tp_train_step(model, CFG, torch.optim.SGD(model.parameters(), lr=0.1), None,
                              sentinel=True)
