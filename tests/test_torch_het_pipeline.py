"""The port's heterogeneous GPipe (ResNet-18 stages) on spawned gloo worlds on
the CPU, against the JAX package's serial loss and gradients (the oracle of
``tests/test_het_pipeline.py``): narrow (width 8), float32, the stages
loaded from one flax ``ResNet18(norm="group")`` tree cut per stage (the
port's seeded initial weights, exported to flax's layout).

Two worlds: ``D = 2 x S = 2`` with M = 2 (8 rows: 2 per replica and
microbatch), and ``S = 3`` (cuts ``[3, 6]``) with M = 2.  In each, every rank
runs the forward-only loss, then one train step, from the same weights.

Tolerances: loss rtol 1e-5; gradients atol 1e-5, rtol 1e-4 (the pipeline
sums per-microbatch gradients where the serial program takes the whole
batch at once).  The ranks import this module, so it imports jax only
inside the tests.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models import resnet  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.het_pipeline import (  # noqa: E402
    make_het_pipeline_loss,
    make_het_pipeline_train_step,
)
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

W, M = 8, 2
X = np.random.default_rng(4).normal(size=(8, 32, 32, 3)).astype(np.float32)
Y = np.random.default_rng(5).integers(0, 10, 8).astype(np.int32)


def het_rank(rdv, data, stages, trees):
    """The forward-only loss, then one SGD step, on this rank's stage: both
    losses (last stage), the stage's gradients and its comm counts."""
    with init_mesh(rdv, data, stages, device="cpu") as mesh:
        s = mesh.coords[1]
        stage = resnet.make_resnet_stages(stages, width=W, seed=7)[s]
        resnet.load_flax_params(stage, trees[s])
        shapes = resnet.boundary_shapes(stages, width=W)
        batch = {"x": torch.from_numpy(X).permute(0, 3, 1, 2).contiguous(),
                 "y": torch.from_numpy(Y)}
        ce = lambda logits, b: cross_entropy_logits(logits, b["y"])  # noqa: E731
        fwd = make_het_pipeline_loss(stage, ce, shapes, mesh, M)(batch)
        step = make_het_pipeline_train_step(
            stage, ce, shapes, torch.optim.SGD(stage.parameters(), lr=0.1), mesh, M)
        mesh.comm.take_stats()
        loss = step(batch)
        return {"coords": mesh.coords, "shapes": shapes,
                "fwd": None if fwd is None else fwd.item(),
                "loss": None if loss is None else loss.item(),
                "grads": resnet.export_grads(stage), "comm": mesh.comm.take_stats()}


@pytest.fixture(scope="module")
def flax_oracle():
    """The flax tree, and the serial loss and gradients on the 8 rows."""
    import jax

    from ddl25spring_tpu.models.resnet import ResNet18
    from ddl25spring_tpu.ops.losses import cross_entropy_logits as jce

    params = resnet.export_params(resnet.ResNet18(norm="group", width=W,
                                                  generator=torch.Generator().manual_seed(2)))
    model = ResNet18(norm="group", width=W)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jce(model.apply({"params": p}, X), Y)))(params)
    return params, float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module", params=[(2, 2), (1, 3)], ids=["2x2", "1x3"])
def world(request, flax_oracle, tmp_path_factory):
    data, stages = request.param
    trees = resnet.split_params_for_stages(flax_oracle[0], stages)
    ranks = spawn(het_rank, data * stages, data, stages, trees, timeout=120,
                  tmpdir=str(tmp_path_factory.mktemp("rdv")))
    return data, stages, ranks


def test_loss_and_grads_equal_the_jax_serial_step(world, flax_oracle):
    data, stages, ranks = world
    _, loss, grads = flax_oracle
    want = resnet.split_params_for_stages(grads, stages)
    for r in ranks:
        d, s = r["coords"]
        if s == stages - 1:
            np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
            np.testing.assert_allclose(r["fwd"], loss, rtol=1e-5)
        else:
            assert r["loss"] is None and r["fwd"] is None
        got = flatten(r["grads"])
        assert [p for p, _ in got] == [p for p, _ in flatten(want[s])]
        for (path, a), (_, b) in zip(got, flatten(want[s])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=f"stage {s} {path}")


def test_replicas_agree_and_hops_carry_the_probed_shapes(world):
    data, stages, ranks = world
    for r in ranks:
        d, s = r["coords"]
        twin = ranks[s]  # the same stage of pipeline 0
        assert r["loss"] == twin["loss"]
        for (_, a), (_, b) in zip(flatten(r["grads"]), flatten(twin["grads"])):
            assert np.array_equal(a, b)
        # per-sample boundaries: [2W, 16, 16] after block 3, etc.; logits last
        assert r["shapes"][-1] == (10,) and len(r["shapes"]) == stages
        assert all(len(sh) == 3 for sh in r["shapes"][:-1])


def test_comm_counts(world):
    data, stages, ranks = world
    for r in ranks:
        d, s = r["coords"]
        c = r["comm"]
        assert c["bytes_staged"] == 0  # CPU tensors go to gloo as they are
        assert (c["allreduce_s"] > 0) == (data > 1)
        assert (c["recv_wait_s"] > 0) and (c["send_s"] > 0)
        assert math.isfinite(c["send_s"])
