"""The port's five pipeline schedules on the CPU, in spawned gloo worlds of
1 x 3 and 2 x 3 ranks (S = 3, M = 3, V = 2 chunks per rank under the
interleaved schedules), each world running every schedule from the same
weights: against the JAX package's ``make_pipeline_train_step(schedule=...)``
on a CPU mesh, against the port's own GPipe (which
``tests/test_torch_pipeline.py`` holds to JAX), and against each other.

Both sides take 2 SGD steps (lr 0.5) on the same two batches of 6 rows, so
each updated parameter moves by half its gradient and the comparison of
parameters is a comparison of gradients.  Tolerances: losses rtol 1e-5,
parameters atol 1e-5 against JAX; the port's schedules against its GPipe
atol 1e-6, ``1f1b-stash`` against ``1f1b`` bitwise.  The 2 x 3 grid holds
the same global batch, and so the same mean loss and gradients, as the
1 x 3 grid.  Dense attention on both sides, as the JAX tests run on the
CPU, plus ``1f1b`` and ``interleaved-1f1b`` with the port's flash plain
versions.  The ranks import this module, so it imports jax only inside
fixtures.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.lab import dp_pp  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    INTERLEAVED,
    SCHEDULES,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=6, ctx_size=16, dtype="float32")
S, M, V = 3, 3, 2
LR = 0.5
TOKENS = [np.random.default_rng(20 + i).integers(0, 64, (6, 16)).astype(np.int32)
          for i in range(2)]
CASES = [(name, False) for name in SCHEDULES] + [("1f1b", True), ("interleaved-1f1b", True)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's CPU kernels would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunks(name):
    return V if name in INTERLEAVED else 1


def schedules_rank(rdv, data, params, batches):
    """Every case of :data:`CASES` on one rank of a ``data x S`` grid, each
    from ``params``: the losses (last stage), the stage's parameters after
    the steps, the largest stash of each step and the comm counts."""
    out = {}
    with init_mesh(rdv, data=data, stages=S, device="cpu") as mesh:
        for name, use_flash in CASES:
            cfg = config.LlamaConfig(**TINY, use_flash=use_flash)
            stage = shard_staged_params(params, cfg, mesh, _chunks(name))
            step = make_pipeline_train_step(
                stage, cfg, torch.optim.SGD(stage.parameters(), lr=LR), mesh, M,
                schedule=name, num_chunks=_chunks(name))
            mesh.comm.take_stats()
            losses, stash = [], []
            for b in batches:
                loss = step(torch.from_numpy(b).long())
                losses.append(None if loss is None else loss.item())
                stash.append(step.stats["stash_max"])
            out[(name, use_flash)] = {"losses": losses, "params": llama.export_params(stage),
                                      "stash": stash, "comm": mesh.comm.take_stats()}
    return out


@pytest.fixture(scope="module")
def params():
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.utils import config as jconfig

    return jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(3), jconfig.LlamaConfig(**TINY)))


@pytest.fixture(scope="module", params=[1, 2], ids=["1x3", "2x3"])
def world(request, tmp_path_factory, params):
    data = request.param
    ranks = spawn(schedules_rank, data * S, data, params, TOKENS, timeout=120,
                  tmpdir=str(tmp_path_factory.mktemp("rdv")))
    return data, ranks


@pytest.fixture(scope="module")
def jax_steps(params):
    """2 SGD steps of the JAX step on a ``stage=3`` mesh under 1f1b,
    interleaved and interleaved-1f1b (built once each): losses and the final
    full parameter tree."""
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.parallel.pipeline import make_pipeline_train_step as jstep
    from ddl25spring_tpu.parallel.pipeline import shard_staged_params as jshard
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:S], stage=S)
    out = {}
    for name in ("1f1b", "interleaved", "interleaved-1f1b"):
        v = _chunks(name)
        split = (jllama.split_blocks_interleaved(params, S, v) if v > 1
                 else jllama.split_blocks_for_stages(params, S))
        staged = jshard(split, mesh)
        tx = optax.sgd(LR)
        opt_state = tx.init(staged)
        step = jstep(jconfig.LlamaConfig(**TINY), tx, mesh, M, schedule=name, num_chunks=v,
                     donate=False, sentinel=False)
        losses = []
        for b in TOKENS:
            staged, opt_state, loss = step(staged, opt_state, b)
            losses.append(float(loss))
        final = jax.tree.map(np.asarray, staged)
        out[name] = (losses, jllama.merge_blocks_interleaved(final) if v > 1
                     else jllama.merge_blocks_from_stages(final))
    return out


def _merged(ranks, case):
    """The full parameter tree of pipeline 0 after ``case``'s steps."""
    exports = [r[case]["params"] for r in ranks if r is not None][:S]
    return llama.merge_stage_exports(exports, _chunks(case[0]))


def _losses(ranks, case):
    return ranks[S - 1][case]["losses"]


def _close(got: dict, want: dict, **tol):
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=path, **tol)


@pytest.mark.parametrize("case", [("1f1b", False), ("interleaved", False),
                                  ("interleaved-1f1b", False), ("1f1b", True),
                                  ("interleaved-1f1b", True)],
                         ids=["1f1b", "interleaved", "interleaved-1f1b", "1f1b-flash",
                              "interleaved-1f1b-flash"])
def test_schedule_matches_jax(world, jax_steps, case):
    _, ranks = world
    losses, final = jax_steps[case[0]]
    np.testing.assert_allclose(_losses(ranks, case), losses, rtol=1e-5)
    _close(_merged(ranks, case), final, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_equals_gpipe(world, name):
    _, ranks = world
    case, ref = (name, False), ("gpipe", False)
    np.testing.assert_allclose(_losses(ranks, case), _losses(ranks, ref), rtol=1e-6)
    _close(_merged(ranks, case), _merged(ranks, ref), atol=1e-6, rtol=0)


def test_1f1b_stash_equals_1f1b_bitwise(world):
    _, ranks = world
    for r in ranks:
        a, b = r[("1f1b-stash", False)], r[("1f1b", False)]
        assert a["losses"] == b["losses"]
        for (pa, x), (pb, y) in zip(flatten(a["params"]), flatten(b["params"])):
            assert pa == pb and np.array_equal(x, y)


def test_stash_bound_and_replicas(world):
    data, ranks = world
    for rank, r in enumerate(ranks):
        s = rank % S
        for name in SCHEDULES:
            got = r[(name, False)]["stash"]
            want = {"gpipe": M, "interleaved": M * V, "1f1b": min(M, S - s),
                    "1f1b-stash": min(M, S - s),
                    "interleaved-1f1b": min(2 * (S - 1 - s) + (V - 1) * S + 1, M * V)}[name]
            assert got == [want, want], (name, s)
            assert all(math.isfinite(x) for x in r[(name, False)]["losses"] if x is not None)
            comm = r[(name, False)]["comm"]
            assert comm["bytes_staged"] == 0  # CPU tensors go to gloo as they are
            assert (comm["allreduce_s"] > 0) == (data > 1)
    if data > 1:
        for s in range(S):
            for name in SCHEDULES:
                a, b = ranks[s][(name, False)], ranks[S + s][(name, False)]
                assert a["losses"] == b["losses"]
                for (_, x), (_, y) in zip(flatten(a["params"]), flatten(b["params"])):
                    assert np.array_equal(x, y)


def test_interleaved_split_merge_matches_jax(params):
    from ddl25spring_tpu.models import llama as jllama

    split = llama.split_blocks_interleaved(params, S, V)
    want = jllama.split_blocks_interleaved(params, S, V)
    for (pa, a), (pb, b) in zip(flatten(split), flatten(want)):
        assert pa == pb and a.shape == b.shape and np.array_equal(a, np.asarray(b))
    assert split["blocks"]["wq"].shape[:3] == (S, V, 1)
    # blocks[s][v] is global chunk v*S + s
    np.testing.assert_array_equal(split["blocks"]["wq"][1, 0, 0], params["blocks"]["wq"][1])
    np.testing.assert_array_equal(split["blocks"]["wq"][0, 1, 0], params["blocks"]["wq"][3])
    back = llama.merge_blocks_interleaved(split)
    for (_, a), (_, b) in zip(flatten(back), flatten(params)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible by S\\*V = 2\\*2"):
        llama.split_blocks_interleaved(params, 2, 2)
    # each rank's chunked stage loads its chunks and exports them back
    cfg = config.LlamaConfig(**TINY)
    stages = [llama.load_stage_params(
        llama.LlamaChunkedStage(cfg, s, S, V, device="cpu",
                                generator=torch.Generator().manual_seed(2)), split)
        for s in range(S)]
    assert [sorted(llama.export_params(st)) for st in stages] == [
        ["blocks", "embed"], ["blocks"], ["blocks", "ln_f", "unembed"]]
    merged = llama.merge_stage_exports([llama.export_params(st) for st in stages], V)
    for (pa, a), (pb, b) in zip(flatten(merged), flatten(params)):
        assert pa == pb and np.array_equal(a, b)
    with pytest.raises(ValueError, match="interleaved pytree"):
        llama.load_stage_params(llama.LlamaStage(cfg, 0, S, device="cpu",
                                                 generator=torch.Generator()), split)
    with pytest.raises(ValueError, match="not divisible by S\\*V = 4\\*2"):
        llama.LlamaChunkedStage(cfg, 0, 4, 2, device="cpu", generator=torch.Generator())


def test_chunked_stage_chain_equals_llama_forward(params):
    cfg = config.LlamaConfig(**TINY)
    split = llama.split_blocks_interleaved(params, S, V)
    stages = [llama.load_stage_params(
        llama.LlamaChunkedStage(cfg, s, S, V, device="cpu",
                                generator=torch.Generator().manual_seed(2)), split)
        for s in range(S)]
    tokens = torch.from_numpy(TOKENS[0]).long()
    with torch.no_grad():
        x = tokens
        for g in range(S * V):  # global chunk g lives on rank g % S as chunk g // S
            x = llama.stage_forward(stages[g % S].chunks[g // S], x, cfg)
        want = llama.load_jax_params(
            llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(1)),
            params)(tokens)
    torch.testing.assert_close(x, want, rtol=0, atol=1e-6)


def test_guards_raise_as_in_jax(params):
    class Grid:
        size, data = S, 1

    class FakeMesh:
        grid, coords, device = Grid, (0, 0), torch.device("cpu")

    cfg = config.LlamaConfig(**TINY)
    stage = llama.LlamaStage(cfg, 0, S, device="cpu", generator=torch.Generator())
    chunked = llama.LlamaChunkedStage(cfg, 0, S, V, device="cpu", generator=torch.Generator())
    opt = torch.optim.SGD(stage.parameters(), lr=LR)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_pipeline_train_step(stage, cfg, opt, FakeMesh, M, schedule="zigzag")
    with pytest.raises(ValueError, match="needs schedule='interleaved'"):
        make_pipeline_train_step(chunked, cfg, opt, FakeMesh, M, schedule="1f1b",
                                 num_chunks=V)
    with pytest.raises(ValueError, match="num_chunks >= 2"):
        make_pipeline_train_step(stage, cfg, opt, FakeMesh, M, schedule="interleaved-1f1b")
    # the JAX test_interleaved_rejects_indivisible_microbatches: M % S != 0
    with pytest.raises(ValueError, match="divisible"):
        make_pipeline_train_step(chunked, cfg, opt, FakeMesh, 4, schedule="interleaved",
                                 num_chunks=V)
    with pytest.raises(ValueError, match="holds 1 chunks"):
        make_pipeline_train_step(stage, cfg, opt, FakeMesh, M, schedule="interleaved",
                                 num_chunks=V)
    with pytest.raises(ValueError, match="divisible"):
        dp_pp.main(["--workload", "llama", "--device", "cpu", "--schedule", "interleaved",
                    "--chunks", "4"])


def test_lab_runs_interleaved_1f1b_on_dp_pp():
    run = dp_pp.main(["--workload", "llama", "--device", "cpu", "--iters", "2", "--seq-len",
                      "16", "--schedule", "interleaved-1f1b", "--chunks", "2", "--timeout", "120"])
    assert len(run["losses"]) == 2 and all(math.isfinite(x) for x in run["losses"])
    assert [r["stash_max"] for r in run["ranks"]] == [[6, 6], [6, 6], [4, 4]] * 2
