"""The port's GPipe pipeline and DP x PP step on the CPU: the stage split and
the weight bridge against the JAX package's, a spawned world of 3 (S = 3,
M = 3) against the port's single-device step, and a spawned world of 6
(D = 2, S = 3, M = 3) against the JAX ``make_pipeline_train_step`` on a
``(data=2, stage=3)`` mesh.  The rank grid, the backend rule and the launcher's
failure path are checked here too.

Tolerances: one step's loss rtol 1e-5 and gradients atol 2e-4, rtol 2e-3 (as
``tests/test_pipeline.py::test_dp_pp_2d_mesh_equals_serial``); after 2 Adam
steps, losses rtol 1e-5 and parameters atol 1e-4.  Every spawned world puts
its ``FileStore`` under the test's temporary directory and is killed past a
120 s join.  The ranks import this module, so it imports jax only inside the
tests.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.lab import dp_pp, microbatches  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    SCHEDULES,
    check_schedule,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import (  # noqa: E402
    RankGrid,
    init_mesh,
    rank_device,
    select_backend,
)

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=6, ctx_size=16, dtype="float32")
S, M = 3, 3
LR = 8e-4
TOKENS = [np.random.default_rng(10 + s).integers(0, 64, (6, 16)).astype(np.int32)
          for s in range(2)]


def _cfg(**kw):
    return config.LlamaConfig(**{**TINY, **kw})


@pytest.fixture(scope="module")
def params():
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.utils import config as jconfig

    return jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jconfig.LlamaConfig(**TINY)))


def _model(params, **kw):
    return llama.load_jax_params(
        llama.Llama(_cfg(**kw), device="cpu", generator=torch.Generator().manual_seed(1)),
        params)


def _single_device(params, batches, **kw):
    """The port's single-device Adam step over ``batches``: the losses, the
    first step's gradients and the last parameters."""
    model = _model(params, **kw)
    step = make_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                           torch.optim.Adam(model.parameters(), lr=LR))
    losses, grads = [], []
    for b in batches:
        losses.append(step(torch.from_numpy(b).long()).item())
        grads.append(llama.export_grads(model))
    return losses, grads[0], llama.export_params(model)


def _run(tmp_path, params, data, batches, **kw):
    job = dp_pp.Job(_cfg(**kw), data, S, M, batch=6, iters=len(batches), lr=LR,
                    device="cpu", params=params, batches=batches, export=True, log=False)
    return spawn(dp_pp.run_rank, data * S, job, timeout=120, tmpdir=str(tmp_path))


def _close(got: dict, want: dict, **tol):
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        np.testing.assert_allclose(a, b, err_msg=path, **tol)


# ------------------------------------------------------------ in one process


def test_stage_split_merge_matches_jax(params):
    from ddl25spring_tpu.models import llama as jllama

    staged = llama.split_blocks_for_stages(params, S)
    want = jllama.split_blocks_for_stages(params, S)
    for (pa, a), (pb, b) in zip(flatten(staged), flatten(want)):
        assert pa == pb and a.shape == b.shape and np.array_equal(a, np.asarray(b))
    back = llama.merge_blocks_from_stages(staged)
    for (_, a), (_, b) in zip(flatten(back), flatten(params)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        llama.split_blocks_for_stages(params, 4)
    # each stage loads its slice and exports it back; the merge is the full tree
    stages = [llama.load_stage_params(
        llama.LlamaStage(_cfg(), s, S, device="cpu", generator=torch.Generator().manual_seed(2)),
        staged) for s in range(S)]
    assert [sorted(llama.export_params(st)) for st in stages] == [
        ["blocks", "embed"], ["blocks"], ["blocks", "ln_f", "unembed"]]
    merged = llama.merge_stage_exports([llama.export_params(st) for st in stages])
    for (pa, a), (pb, b) in zip(flatten(merged), flatten(params)):
        assert pa == pb and np.array_equal(a, b)


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_stage_chain_equals_llama_forward(params, use_flash):
    cfg = _cfg(use_flash=use_flash)
    staged = llama.split_blocks_for_stages(params, S)
    stages = [llama.load_stage_params(
        llama.LlamaStage(cfg, s, S, device="cpu", generator=torch.Generator().manual_seed(2)),
        staged) for s in range(S)]
    tokens = torch.from_numpy(TOKENS[0]).long()
    with torch.no_grad():
        x = tokens
        for st in stages:
            x = llama.stage_forward(st, x, cfg)
        want = _model(params, use_flash=use_flash)(tokens)
    assert x.dtype == torch.float32 and x.shape == (6, 16, 64)
    torch.testing.assert_close(x, want, rtol=0, atol=1e-6)


def test_rank_grid_and_backend_rule():
    grid = RankGrid(data=2, size=3)
    assert [grid.coords(r) for r in range(6)] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [grid.dp_ranks(s) for s in range(3)] == [[0, 3], [1, 4], [2, 5]]
    assert [grid.prev_rank(r) for r in range(6)] == [None, 0, 1, None, 3, 4]
    assert [grid.next_rank(r) for r in range(6)] == [1, 2, None, 4, 5, None]
    with pytest.raises(ValueError):
        grid.coords(6)
    # nccl iff every rank of the host has a card of its own
    assert select_backend("cuda", 6, 1) == "gloo"
    assert select_backend("cuda", 2, 2) == "nccl"
    assert select_backend("cuda", 4, 8) == "nccl"
    assert select_backend("cpu", 1, 0) == "gloo"
    assert rank_device(5, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(0, "cuda")


def test_unported_schedules_and_workloads_raise():
    # every schedule of the JAX package is ported; what is not still raises
    for schedule in SCHEDULES:
        check_schedule(schedule)
    with pytest.raises(ValueError, match="unknown schedule"):
        check_schedule("zigzag")
    # K train steps per dispatch (the JAX fuse_train_steps) are one CUDA
    # graph on the card, which B1's three ranks sharing a card over gloo
    # cannot be (the check alone, no card needed): an explicit K > 1 raises
    # and the default falls to 1, saying why; on the CPU K steps are a loop
    with pytest.raises(ValueError, match="host copy"):
        dp_pp.llama_scan_steps(4, torch.device("cuda"), S)
    K, why = dp_pp.llama_scan_steps(0, torch.device("cuda"), S)
    assert K == 1 and "host copy" in why
    assert dp_pp.llama_scan_steps(4, torch.device("cpu"), S) == (4, "")
    assert dp_pp.llama_scan_steps(0, torch.device("cpu"), S) == (1, "")
    # switch-MoE LLaMA: a MoE stage builds (its blocks hold the moe subtree),
    # and the forwards that would drop the aux loss refuse it
    moe = _cfg(n_experts=4)
    stage = llama.LlamaStage(moe, 0, S, device="cpu", generator=torch.Generator())
    assert all(hasattr(b, "moe") for b in stage.blocks)
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="n_experts > 0"):
        llama.llama_forward(llama.Llama(moe, device="cpu", generator=torch.Generator()),
                            tokens, moe)
    with pytest.raises(NotImplementedError, match="n_experts > 0"):
        llama.stage_forward(stage, tokens, moe)
    # homework B1 is LLaMA only; the ResNet step runs through lab.dp_pp
    with pytest.raises(ValueError, match="LLaMA workload only"):
        microbatches.main(["--device", "cpu", "--workload", "resnet"])


def fail_on_rank_1(rdv):
    """Rank 1 raises at once; rank 0 waits for a message that never comes."""
    with init_mesh(rdv, data=1, stages=2, device="cpu") as mesh:
        if rdv.rank == 1:
            raise ValueError("rank 1 gives up")
        return mesh.comm.recv((2,), torch.float32, 1, tag=0)


def test_spawn_reports_a_failing_rank_and_stops_the_others(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        spawn(fail_on_rank_1, 2, timeout=60, tmpdir=str(tmp_path))
    assert "ValueError: rank 1 gives up" in str(err.value)


# ------------------------------------------------------- spawned worlds


def gpipe_rank(rdv, params, tokens):
    """One GPipe step (S = 3, M = 3) with dense attention, then one with the
    flash plain versions, from ``params`` each time: the loss (last stage)
    and the stage's gradients, and the rank's comm counts."""
    out = {}
    with init_mesh(rdv, data=1, stages=S, device="cpu") as mesh:
        for use_flash in (False, True):
            cfg = _cfg(use_flash=use_flash)
            stage = shard_staged_params(params, cfg, mesh)
            step = make_pipeline_train_step(
                stage, cfg, torch.optim.Adam(stage.parameters(), lr=LR), mesh, M)
            loss = step(torch.from_numpy(tokens).long())
            out[use_flash] = (None if loss is None else loss.item(), llama.export_grads(stage),
                              mesh.comm.take_stats())
    return out


@pytest.fixture(scope="module")
def gpipe_world(tmp_path_factory, params):
    return spawn(gpipe_rank, S, params, TOKENS[0], timeout=120,
                 tmpdir=str(tmp_path_factory.mktemp("rdv")))


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_gpipe_world_of_3_equals_single_device(gpipe_world, params, use_flash):
    ranks = [r[use_flash] for r in gpipe_world]
    losses, grads, _ = _single_device(params, TOKENS[:1], use_flash=use_flash)
    assert [r[0] for r in ranks[:2]] == [None, None]
    np.testing.assert_allclose(ranks[2][0], losses[0], rtol=1e-5)
    _close(llama.merge_stage_exports([r[1] for r in ranks]), grads, atol=2e-4, rtol=2e-3)
    for _, _, comm in ranks:  # D = 1: no all-reduce; CPU tensors: nothing staged
        assert comm["bytes_staged"] == 0 and comm["allreduce_s"] == 0


@pytest.fixture(scope="module")
def dp_pp_world(tmp_path_factory, params):
    return _run(tmp_path_factory.mktemp("rdv"), params, 2, TOKENS)


@pytest.fixture(scope="module")
def jax_dp_pp(params):
    """2 Adam steps of the JAX DP x PP step on a (data=2, stage=3) mesh:
    losses and final parameters (merged from the stages)."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.parallel.pipeline import make_pipeline_train_step, shard_staged_params
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:6], data=2, stage=S)
    staged = shard_staged_params(jllama.split_blocks_for_stages(params, S), mesh)
    tx = optax.adam(LR)
    opt_state = tx.init(staged)
    step = make_pipeline_train_step(jconfig.LlamaConfig(**TINY), tx, mesh, M,
                                    data_axis="data", donate=False, sentinel=False)
    losses = []
    for b in TOKENS:
        staged, opt_state, loss = step(staged, opt_state, b)
        losses.append(float(loss))
    return losses, jllama.merge_blocks_from_stages(jax.tree.map(np.asarray, staged))


def test_dp_pp_matches_jax(dp_pp_world, jax_dp_pp):
    losses, final = jax_dp_pp
    for r in (dp_pp_world[2], dp_pp_world[5]):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    _close(llama.merge_stage_exports([r["params"] for r in dp_pp_world[:3]]), final, atol=1e-4)


def test_dp_pp_first_step_equals_single_device(dp_pp_world, params):
    losses, grads, _ = _single_device(params, TOKENS[:1])
    np.testing.assert_allclose(dp_pp_world[2]["losses"][0], losses[0], rtol=1e-5)
    _close(llama.merge_stage_exports([r["grads"] for r in dp_pp_world[:3]]), grads,
           atol=2e-4, rtol=2e-3)


def test_dp_pp_replicas_agree(dp_pp_world):
    for s in range(S):
        a, b = dp_pp_world[s], dp_pp_world[S + s]
        assert a["losses"] == b["losses"]
        for key in ("grads", "params"):
            for (pa, x), (pb, y) in zip(flatten(a[key]), flatten(b[key])):
                assert pa == pb and np.array_equal(x, y)


def test_dp_pp_layout_and_counts(dp_pp_world):
    assert [r["coords"] for r in dp_pp_world] == [(d, s) for d in range(2) for s in range(S)]
    for r in dp_pp_world:
        d, s = r["coords"]
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert len(r["step_s"]) == len(r["comm"]) == 2
        assert all(math.isfinite(x) for x in r["losses"])
        for c in r["comm"]:
            assert c["bytes_staged"] == 0  # CPU tensors go to gloo as they are
            assert c["allreduce_s"] > 0
            # every stage sends (on, or back) and receives (from before, or after)
            assert c["send_s"] > 0 and c["recv_wait_s"] > 0
        # the plain versions stand in on the CPU: no kernel launched
        assert r["launches"] == {"fwd": 0, "dq": 0, "dkv": 0}
