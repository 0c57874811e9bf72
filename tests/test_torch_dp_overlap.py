"""The port's backward-overlapped DP (``make_dp_train_step(overlap=True)``)
on the CPU: a spawned gloo world of 2 ranks trains the tiny LLaMA for 2 Adam
steps with the overlapped bucketed all-reduce and with the synchronous
per-tensor one, from the same weights.  Held against sync DP, bitwise (at
D = 2 every element of the mean is one commutative ``(a + b) / 2``, whatever
the packing or the time of issue), not against the JAX package's overlapped
step, whose own bitwise test fails on the reference.  The hook log shows
bucket 0 (the last layers) issued before the first layer's gradient exists.
The planner's backward order is held to the JAX planner's.

The ranks import this module, so it imports jax only inside the tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch import benchmarks  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel import bucketing  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step, param_leaves  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=6, ctx_size=16, dtype="float32")
D = 2
BATCHES = [np.random.default_rng(30 + s).integers(0, 64, (2 * D, 16)).astype(np.int32)
           for s in range(2)]
BUCKET = 8192  # the tiny unembed [32, 64] fp32 alone fills bucket 0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's CPU kernels would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss(model, tokens):
    return causal_lm_loss(model(tokens), tokens)


def _model():
    return llama.Llama(config.LlamaConfig(**TINY), device="cpu",
                       generator=torch.Generator().manual_seed(4))


def overlap_rank(rdv):
    """2 Adam steps with the sync per-tensor step and with the overlapped one,
    from the same weights: losses, final parameters, the overlapped step's
    hook log and its bucket plan."""
    out = {}
    with init_mesh(rdv, data=D, stages=1, device="cpu") as mesh:
        for name, kw in (("sync", {"bucket_bytes": None}),
                         ("overlap", {"bucket_bytes": BUCKET, "overlap": True})):
            model = _model()
            step = make_dp_train_step(model, _loss, torch.optim.Adam(model.parameters(),
                                                                     lr=8e-4), mesh, **kw)
            losses = [step(torch.from_numpy(b).long()).item() for b in BATCHES]
            out[name] = {"losses": losses, "params": llama.export_params(model),
                         "log": list(step.log)}
        out["allreduce_s"] = mesh.comm.take_stats()["allreduce_s"]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn(overlap_rank, D, timeout=120, tmpdir=str(tmp_path_factory.mktemp("rdv")))


def test_overlap_equals_sync_per_tensor(world):
    for r in world:
        a, b = r["overlap"], r["sync"]
        assert a["losses"] == b["losses"]
        for (pa, x), (pb, y) in zip(bucketing.flatten(a["params"]),
                                    bucketing.flatten(b["params"])):
            assert pa == pb
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-7, err_msg=pa)
            assert np.array_equal(x, y), pa
    for (_, x), (_, y) in zip(bucketing.flatten(world[0]["overlap"]["params"]),
                              bucketing.flatten(world[1]["overlap"]["params"])):
        assert np.array_equal(x, y)
    assert all(r["allreduce_s"] > 0 for r in world)


def test_bucket_0_goes_out_before_the_first_layer_has_its_gradient(world):
    paths = [p for p, _ in bucketing.flatten(_model().param_tree())]
    plan = bucketing.plan_buckets(param_leaves(_model()), BUCKET, order="backward")
    assert [paths[i] for i in plan.buckets[0]] == ["unembed"]
    for r in world:
        log = r["overlap"]["log"]
        issues = [b for kind, b in log if kind == "issue"]
        assert issues == list(range(plan.n_buckets))  # in index order, each once
        first = log.index(("issue", 0))
        # the embedding and layer 0 (in every stacked blocks leaf) come last
        for leaf in ("embed", "blocks.wq", "blocks.ln1"):
            assert first < log.index(("grad", paths.index(leaf))), leaf
        assert log[0] == ("grad", paths.index("unembed")) and log[1] == ("issue", 0)
        assert sorted(i for kind, i in log if kind == "grad") == list(range(len(paths)))


@pytest.mark.parametrize("bucket_bytes", [BUCKET, 65536, 1 << 30])
def test_backward_plan_matches_jax(bucket_bytes):
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.parallel import bucketing as jbucketing
    from ddl25spring_tpu.utils import config as jconfig

    tree = jax.eval_shape(lambda: jllama.init_llama_params(jax.random.PRNGKey(0),
                                                           jconfig.LlamaConfig(**TINY)))
    want = jbucketing.plan_buckets(tree, bucket_bytes, order="backward")
    got = bucketing.plan_buckets(param_leaves(_model()), bucket_bytes, order="backward")
    assert got.buckets == want.buckets and got.sizes == want.sizes
    with pytest.raises(ValueError, match="order must be"):
        bucketing.plan_buckets(param_leaves(_model()), bucket_bytes, order="sideways")


def test_overlap_needs_buckets_and_pure_dp():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for bb in (None, 0):
        with pytest.raises(ValueError, match="overlap=True needs the bucketed path"):
            make_dp_train_step(model, _loss, opt, None, bucket_bytes=bb, overlap=True)

    class Grid:
        data, size = 1, 2

    class PipelineMesh:
        grid, device, coords = Grid, torch.device("cpu"), (0, 0)

    with pytest.raises(ValueError, match="pure-DP layout"):
        benchmarks.build_resnet_step(PipelineMesh, 2, 8, overlap=True)


def test_resnet_step_names_the_overlapped_layout():
    _, _, _, meta = benchmarks.build_resnet_step(None, 1, 4, device="cpu", overlap=True)
    assert meta["layout"] == "dp-overlap"
    _, _, _, meta = benchmarks.build_resnet_step(None, 1, 4, device="cpu")
    assert meta["layout"] == "dp"
