"""The port's data-parallel steps against the JAX package's, on the CPU: one
spawned gloo world of 2 ranks trains the tiny LLaMA for 3 Adam steps with the
bucketed gradient all-reduce, the per-tensor one and weight averaging; the
JAX steps run on a 2-device mesh from the same weights and batches.

Tolerances: losses rtol 1e-5, parameters atol 5e-5 (as
``test_torch_train.py``: optax's ``adam`` and torch's ``Adam`` differ only in
rounding).  Bucketed and per-tensor DP must agree bitwise: at D = 2 every
element of the mean is one commutative ``(a + b) / 2``, whatever the packing.

The ranks import this module, so it imports jax only inside the tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel import bucketing  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import (  # noqa: E402
    make_dp_train_step,
    make_dp_weight_avg_step,
)
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=6, ctx_size=16, dtype="float32")
LR = 8e-4
D = 2
BATCHES = [np.random.default_rng(s).integers(0, 64, (2 * D, 16)).astype(np.int32)
           for s in range(3)]
# 64 KiB splits the tiny model's tree into 6 buckets (test_torch_bucketing)
STEPS = {"bucketed": (make_dp_train_step, 65536),
         "per_tensor": (make_dp_train_step, None),
         "weight_avg": (make_dp_weight_avg_step, 65536)}


def _loss(model, tokens):
    return causal_lm_loss(model(tokens), tokens)


def dp_rank(rdv, params):
    """Every step of STEPS from ``params``, 3 Adam steps each: losses and the
    final parameters."""
    out = {}
    with init_mesh(rdv, data=D, stages=1, device="cpu") as mesh:
        for name, (make, bb) in STEPS.items():
            model = llama.load_jax_params(
                llama.Llama(config.LlamaConfig(**TINY), device="cpu",
                            generator=torch.Generator().manual_seed(0)), params)
            step = make(model, _loss, torch.optim.Adam(model.parameters(), lr=LR), mesh,
                        bucket_bytes=bb)
            losses = [step(torch.from_numpy(b).long()).item() for b in BATCHES]
            out[name] = (losses, llama.export_params(model))
        out["allreduce_s"] = mesh.comm.take_stats()["allreduce_s"]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX initial parameters and the 2 ranks' results."""
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.utils import config as jconfig

    params = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jconfig.LlamaConfig(**TINY)))
    ranks = spawn(dp_rank, D, params, timeout=120, tmpdir=str(tmp_path_factory.mktemp("rdv")))
    return params, ranks


@pytest.fixture(scope="module")
def jax_runs(world):
    """The JAX steps' losses and final parameters: gradient aggregation and
    weight averaging."""
    params, _ = world
    return {"grad": _jax_run(params, weight_avg=False),
            "weight_avg": _jax_run(params, weight_avg=True)}


def _jax_run(params, weight_avg: bool):
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss as j_causal_lm_loss
    from ddl25spring_tpu.parallel import dp as jdp
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    jcfg = jconfig.LlamaConfig(**TINY)

    def loss_fn(p, tokens, key):
        return j_causal_lm_loss(jllama.llama_forward(p, tokens, jcfg), tokens)

    tx, mesh = optax.adam(LR), make_mesh(jax.devices()[:D], data=D)
    if weight_avg:
        step = jdp.make_dp_weight_avg_step(loss_fn, tx, mesh, per_shard_rng=False,
                                           donate=False, sentinel=False)
        opt_state = jdp.stack_opt_state(tx.init(params), D)
    else:
        step = jdp.make_dp_train_step(loss_fn, tx, mesh, per_shard_rng=False, instrument=False,
                                      donate=False, sentinel=False)
        opt_state = tx.init(params)
    losses = []
    for b in BATCHES:
        params, opt_state, loss = step(params, opt_state, b, jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _assert_matches_jax(got, want):
    import jax

    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1])):
        np.testing.assert_allclose(a, b, atol=5e-5)


@pytest.mark.parametrize("name", ["bucketed", "per_tensor"])
def test_dp_step_matches_jax(world, jax_runs, name):
    _assert_matches_jax(world[1][0][name], jax_runs["grad"])


def test_weight_avg_step_matches_jax(world, jax_runs):
    _assert_matches_jax(world[1][0]["weight_avg"], jax_runs["weight_avg"])


def test_bucketed_equals_per_tensor_bitwise(world):
    _, ranks = world
    for r in ranks:
        (la, pa), (lb, pb) = r["bucketed"], r["per_tensor"]
        assert la == lb
        for x, y in zip(bucketing.flatten(pa), bucketing.flatten(pb)):
            assert x[0] == y[0] and np.array_equal(x[1], y[1])


def test_replicas_agree(world):
    _, ranks = world
    for name in STEPS:
        (l0, p0), (l1, p1) = ranks[0][name], ranks[1][name]
        assert l0 == l1
        for x, y in zip(bucketing.flatten(p0), bucketing.flatten(p1)):
            assert np.array_equal(x[1], y[1])
    assert all(r["allreduce_s"] > 0 for r in ranks)


def test_refused_options_raise(monkeypatch):
    from ddl25spring_tpu_torch.obs import sentinels

    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    # overlap is ported, but only over buckets, as in the JAX step
    with pytest.raises(ValueError, match="overlap=True needs the bucketed path"):
        make_dp_train_step(model, _loss, opt, None, bucket_bytes=None, overlap=True)
    # what JAX refuses of the sentinel: a policy outside log/halt/skip, when
    # the builder resolves it (sentinels.resolve)
    with pytest.raises(ValueError, match="not one of"):
        sentinels.resolve(True, "explode")
    monkeypatch.setattr(sentinels, "_policy", "explode")
    with pytest.raises(ValueError, match="not one of"):
        make_dp_train_step(model, _loss, opt, None, sentinel=True)
    with pytest.raises(ValueError, match="not one of"):
        make_dp_weight_avg_step(model, _loss, opt, None, sentinel=True)
