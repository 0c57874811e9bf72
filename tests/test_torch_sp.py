"""The port's sequence parallelism against the JAX package's, on the CPU.

One spawned gloo world of 4 ranks runs every case from the JAX package's
tiny config (``tests/test_sp.py``: vocab 64, dmodel 32, 2 heads, 2 layers,
ctx 32, fp32) with the JAX initial weights and seeded tokens:

- loss and gradients of the dense ring at n = 2 and 4, the flash ring at n =
  2 and 4 (the kernels' plain versions, which the CPU runs), and Ulysses at n
  = 2, against JAX's ``make_sp_loss`` on a ``seq`` mesh of as many CPU
  devices and against the serial ``llama_forward`` + ``causal_lm_loss``.
  The n = 2 cases run on a 2 x 2 grid without a data axis: each replica
  takes the whole batch, and both must agree;
- two Adam steps of ``make_sp_train_step`` on a 2 x 2 (data, seq) grid, flash
  ring and Ulysses, against JAX's flash-ring step on ``mesh(data=2, seq=2)``
  (JAX's own tests hold every SP mode to the same serial step);
- switch-MoE (E 4, capacity factor 2.0, JAX's ``test_sp_moe_*`` config):
  the loss and gradients of the dense ring at n = 1 (one shard: the serial
  composite exactly) and n = 2, the flash ring and Ulysses at n = 2,
  against JAX's ``make_sp_loss`` (dense ring, Ulysses) at rtol 1e-5 (each
  shard dispatches its own tokens and the aux is the shards' mean, in both
  packages), and Ulysses within JAX's rtol 0.05 of the serial composite.

The weights are a torch ``Llama``'s seeded ``normal(0, 0.02)`` draw, exported
as the JAX pytree (numpy): JAX's eager init costs seconds.  The JAX
references compile while the ranks run.

Tolerances are the JAX tests': loss rtol 1e-5, gradients atol 2e-5,
parameters after two steps atol 1e-5.  Both sides' Adam take ``eps`` =
``EPS``, well above the gradients' rounding noise: at Adam's default 1e-8 the
first update, ``lr g / (|g| + eps)``, turns a gradient that is rounding noise
(below 1e-7 at 234 of the 37,024 elements here) into a move of up to ``lr``,
whose sign is the noise's.

The ranks import this module, so it imports jax only inside the fixtures and
tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import sp  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Axis  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=32, dtype="float32")
CFG = LlamaConfig(**TINY)
TOKENS = np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32)
BATCHES = [TOKENS, np.random.default_rng(2).integers(0, 64, (4, 32)).astype(np.int32)]
LR = 1e-3
EPS = 1e-6                      # Adam's eps on both sides (see above)
# case -> (use_flash, mode, n)
CASES = {"ring2": (False, "ring", 2), "ring4": (False, "ring", 4),
         "flash2": (True, "ring", 2), "flash4": (True, "ring", 4),
         "ulysses2": (False, "ulysses", 2)}
STEPS = {"flash": (True, "ring"), "ulysses": (False, "ulysses")}
MOE = dict(TINY, n_experts=4, capacity_factor=2.0)
MOE_CFG = LlamaConfig(**MOE)
MOE_CASES = {"moe ring1": (False, "ring", 1), "moe ring2": (False, "ring", 2),
             "moe flash2": (True, "ring", 2), "moe ulysses2": (False, "ulysses", 2)}


def _model(cfg, params):
    return llama.load_jax_params(
        llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0)), params)


def sp_rank(rdv, params, moe_params):
    """Every case: the loss and the synced gradients of one step (SGD at lr
    0, which leaves the weights), then the two-step Adam runs; the MoE
    cases' one step."""
    out = {}
    with init_mesh(rdv, 1, seq=4, device="cpu") as mesh:
        grids = {4: mesh, 2: mesh.regrid(2, seq=2)}
        for name, (flash, mode, n) in MOE_CASES.items():
            cfg = replace(MOE_CFG, use_flash=flash)
            model = _model(cfg, moe_params)
            grid = grids[n] if n > 1 else mesh.regrid(4, seq=1)
            step = sp.make_sp_train_step(model, cfg, torch.optim.SGD(model.parameters(), lr=0.0),
                                         grid, mode=mode)
            out[name] = (float(step(torch.from_numpy(TOKENS).long())),
                         llama.export_grads(model))
        for name, (flash, mode, n) in CASES.items():
            cfg = replace(CFG, use_flash=flash)
            model = _model(cfg, params)
            step = sp.make_sp_train_step(model, cfg, torch.optim.SGD(model.parameters(), lr=0.0),
                                         grids[n], mode=mode)
            loss = float(step(torch.from_numpy(TOKENS).long()))
            out[name] = (loss, llama.export_grads(model))
        for name, (flash, mode) in STEPS.items():
            cfg = replace(CFG, use_flash=flash)
            model = _model(cfg, params)
            opt = torch.optim.Adam(model.parameters(), lr=LR, eps=EPS)
            step = sp.make_sp_train_step(model, cfg, opt, grids[2], data_axis="data", mode=mode)
            losses = [float(step(torch.from_numpy(b).long())) for b in BATCHES]
            out["step", name] = (losses, llama.export_params(model))
    return out


@pytest.fixture(scope="module")
def params():
    return llama.export_params(
        llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(3)))


@pytest.fixture(scope="module")
def moe_params():
    return llama.export_params(
        llama.Llama(MOE_CFG, device="cpu", generator=torch.Generator().manual_seed(3)))


def _jax_moe_refs(params, devices8):
    """JAX's serial composite ``causal_lm_loss + w aux`` and ``make_sp_loss``
    per MoE case, each loss with its gradients."""
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.parallel.sp import make_sp_loss
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    def jcfg(flash):
        return jconfig.LlamaConfig(**MOE, use_flash=flash)

    def serial(p, t):
        logits, aux = jllama.llama_forward_with_aux(p, t, jcfg(False))
        return causal_lm_loss(logits, t) + jcfg(False).moe_aux_weight * aux

    refs = {"serial": jax.jit(jax.value_and_grad(serial))(params, TOKENS)}
    # one shard is the serial composite, and the flash ring's math is the
    # dense ring's: JAX's dense 2-shard ring and Ulysses are the references
    for name in ("moe ring2", "moe ulysses2"):
        _, mode, n = MOE_CASES[name]
        loss = make_sp_loss(jcfg(False), make_mesh(devices8[:n], seq=n), mode=mode)
        refs[name] = jax.jit(jax.value_and_grad(loss))(params, TOKENS)
    return {k: (float(v[0]), jax.tree.map(np.asarray, v[1])) for k, v in refs.items()}


def _jcfg(flash):
    from ddl25spring_tpu.utils import config as jconfig

    return jconfig.LlamaConfig(**TINY, use_flash=flash)


def _jax_refs(params, devices8):
    """JAX's loss and gradients, serial and ``make_sp_loss`` per case, and
    the parameters and losses of two steps of its flash-ring SP x DP step."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.parallel.sp import make_sp_loss, make_sp_train_step
    from ddl25spring_tpu.utils.mesh import make_mesh

    def serial(p, t):
        return causal_lm_loss(jllama.llama_forward(p, t, _jcfg(False)), t)

    refs = {"serial": jax.jit(jax.value_and_grad(serial))(params, TOKENS)}
    for name, (flash, mode, n) in CASES.items():
        loss = make_sp_loss(_jcfg(flash), make_mesh(devices8[:n], seq=n), mode=mode)
        refs[name] = jax.jit(jax.value_and_grad(loss))(params, TOKENS)
    refs = {k: (float(v[0]), jax.tree.map(np.asarray, v[1])) for k, v in refs.items()}
    tx = optax.adam(LR, eps=EPS)
    step = make_sp_train_step(_jcfg(True), tx, make_mesh(devices8[:4], data=2, seq=2),
                              data_axis="data")
    p, state, losses = params, tx.init(params), []
    for b in BATCHES:
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
    refs["step"] = (losses, jax.tree.map(np.asarray, p))
    return refs


@pytest.fixture(scope="module")
def runs(params, moe_params, devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, sp_rank, 4, params, moe_params, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(params, devices8)
        refs["moe"] = _jax_moe_refs(moe_params, devices8)
        return ranks.result(), refs


def _assert_loss_and_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for (path, a), (_, b) in zip(flatten(got[1]), flatten(want[1])):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_loss_and_grads_match_jax(runs, case):
    ranks, refs = runs
    for r in ranks:
        _assert_loss_and_grads(r[case], refs[case])
        _assert_loss_and_grads(r[case], refs["serial"])


@pytest.mark.parametrize("name", list(STEPS))
def test_sp_dp_train_steps_match_jax(runs, name):
    ranks, refs = runs
    losses, want = refs["step"]
    for r in ranks:
        got_losses, got = r["step", name]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        for (path, a), (_, b) in zip(flatten(got), flatten(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


def _moe_loss_and_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for (path, a), (_, b) in zip(flatten(got[1]), flatten(want[1])):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=path)


def test_sp_moe_aux_reaches_loss(runs):
    """MoE under SP: the aux joins the loss.  One shard dispatches the whole
    batch, so the loss and gradients are the serial composite's; the 2-shard
    rings (dense and flash) equal JAX's per-shard estimator."""
    ranks, refs = runs
    moe = refs["moe"]
    for r in ranks:
        _moe_loss_and_grads(r["moe ring1"], moe["serial"])
        for name in ("moe ring2", "moe flash2"):
            assert np.isfinite(r[name][0])
            _moe_loss_and_grads(r[name], moe["moe ring2"])
    # the aux term is there: the loss is above the dense-FFN part's
    assert moe["serial"][0] > 0 and np.abs(
        ranks[0]["moe ring2"][1]["blocks"]["moe"]["router"]).max() > 0


def test_ulysses_moe_equals_serial_composite(runs):
    """Ulysses x switch-MoE at 2 shards: JAX's ``make_sp_loss`` at rtol 1e-5
    (loss and gradients), and the serial composite within JAX's 0.05."""
    ranks, refs = runs
    moe = refs["moe"]
    for r in ranks:
        _moe_loss_and_grads(r["moe ulysses2"], moe["moe ulysses2"])
        np.testing.assert_allclose(r["moe ulysses2"][0], moe["serial"][0], rtol=0.05)


class _Grid:
    """A stand-in mesh that names a seq axis of ``n`` ranks, for the checks
    made before any exchange."""

    def __init__(self, n):
        self.n = n

    def axis(self, name):
        return Axis(name, None, None, tuple(range(self.n)), 0)


def test_sp_rejects_what_jax_rejects(monkeypatch):
    from ddl25spring_tpu_torch.obs import sentinels

    with pytest.raises(ValueError, match="unknown SP mode"):
        sp.make_sp_loss(CFG, _Grid(2), mode="tree")
    with pytest.raises(ValueError, match="divisible"):
        sp.make_sp_loss(CFG, _Grid(4), mode="ulysses")  # 2 heads over 4 shards
    model = llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(sentinels, "_policy", "explode")  # a policy JAX refuses too
    with pytest.raises(ValueError, match="not one of"):
        sp.make_sp_train_step(model, CFG, torch.optim.SGD(model.parameters(), lr=0.1),
                              _Grid(2), sentinel=True)
