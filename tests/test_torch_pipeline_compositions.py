"""The pipeline compositions of the port against the JAX package's oracles, on
the CPU: EP x DP x PP, TP inside the stages (DP x PP x TP), SP inside the
stages (DP x PP x SP) and PP x SP x TP, through
``make_pipeline_train_step(ep_axis=, tp_axis=, seq_axis=, sp_mode=)``.

The JAX pipeline tests' configs (``tests/test_pipeline.py``): ``CFG`` (vocab
64, dmodel 32, 2 heads, 4 layers, ctx 16, fp32), ``CFG4H`` (4 heads) and
``MOE_CFG`` (E 4); their oracles, jitted on the CPU: the serial
``llama_forward`` + ``causal_lm_loss`` for a dense model, ``serial_moe_loss``
(the mean over the ``M D`` microbatch groups of ``ce + w aux``) for MoE, and
``make_sp_loss`` per microbatch for SP-MoE.  Tolerances are theirs: loss
rtol 1e-5, gradients atol 2e-4 + rtol 2e-3, and EP against the
replicated-expert pipeline loss rtol 1e-6, gradients atol 2e-5 + rtol 2e-4.
The TP-MoE cases scale the router by 30, as the JAX test does, so that no
routing decision sits at a tie that the TP sums' rounding could flip.

Two spawned gloo worlds run every case, one step each at SGD lr 0 (the
gradients it leaves are the step's, synced): 4 ranks (``data 2 x stage 2``,
then ``stage 2 x model 2`` and ``stage 2 x seq 2``) and 8 ranks, the
three-axis layouts only (``data 2 x stage 2 x model 2``, ``data x stage x
seq`` and ``stage x seq x model``), each re-used through ``Mesh.regrid``,
both started together while the JAX references compile.  Each case's
gradients are merged from the ranks' stage exports: over ``model`` by the
TP dims, over ``data`` by the expert dim under EP, then over the stages.

The refusals run on a mesh object with no process group, and the grid's
numbering against ``make_mesh``'s device order needs no world.  The ranks
import this module, so it imports jax only inside the fixtures and tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import ep, tp  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    SCHEDULES,
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid, _grid, init_mesh  # noqa: E402

BASE = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=4, ctx_size=16, dtype="float32")
CFGS = {"dense": BASE, "dense4h": dict(BASE, num_heads=4),
        "moe": dict(BASE, n_experts=4, capacity_factor=2.0),
        "moe4h": dict(BASE, num_heads=4, n_experts=4, capacity_factor=2.0)}
TOKENS = {"t4": np.random.default_rng(11).integers(0, 64, (4, 16)).astype(np.int32),
          "t8": np.random.default_rng(12).integers(0, 64, (8, 16)).astype(np.int32)}
# grid name -> (world, init_mesh/regrid arguments)
GRIDS = {"dp-pp": (4, dict(data=2, stages=2)), "pp-tp": (4, dict(data=1, stages=2, model=2)),
         "pp-sp": (4, dict(data=1, stages=2, seq=2)),
         "dp-pp-tp": (8, dict(data=2, stages=2, model=2)),
         "dp-pp-sp": (8, dict(data=2, stages=2, seq=2)),
         "pp-sp-tp": (8, dict(data=1, stages=2, seq=2, model=2))}
CHUNKS = {"interleaved": 2, "interleaved-1f1b": 2}


def _case(grid, params, tokens, schedule, cf=None, flash=False, **axes):
    return dict(grid=grid, params=params, tokens=tokens, schedule=schedule, cf=cf,
                flash=flash, V=CHUNKS.get(schedule, 1), axes=axes)


CASES = {}
for _s in SCHEDULES:
    for _cf in (2.0, 0.5):
        CASES[f"ep {_s} cf{_cf}"] = _case("dp-pp", "moe", "t8", _s, _cf, ep_axis="data")
        CASES[f"replicated {_s} cf{_cf}"] = _case("dp-pp", "moe", "t8", _s, _cf)
    CASES[f"tp {_s}"] = _case("pp-tp", "dense", "t4", _s, tp_axis="model")
for _s, _cf in (("gpipe", 2.0), ("gpipe", 0.5), ("1f1b", 2.0), ("interleaved", 2.0)):
    CASES[f"tp-moe {_s} cf{_cf}"] = _case("pp-tp", "moe sharp", "t4", _s, _cf, tp_axis="model")
for _s in ("gpipe", "1f1b", "interleaved-1f1b"):
    for _mode, _flash in (("ring", False), ("flash", True), ("ulysses", False)):
        CASES[f"sp {_mode} {_s}"] = _case("pp-sp", "dense", "t4", _s, flash=_flash,
                                          seq_axis="seq", sp_mode=_mode.replace("flash", "ring"))
CASES["sp-moe gpipe"] = _case("pp-sp", "moe", "t4", "gpipe", 2.0, seq_axis="seq")
for _s in ("gpipe", "1f1b", "interleaved-1f1b"):
    CASES[f"dp-tp {_s}"] = _case("dp-pp-tp", "dense", "t8", _s, tp_axis="model")
CASES["dp-tp-moe gpipe cf0.5"] = _case("dp-pp-tp", "moe sharp", "t8", "gpipe", 0.5,
                                       tp_axis="model")
CASES["dp-sp flash gpipe"] = _case("dp-pp-sp", "dense", "t8", "gpipe", flash=True,
                                   seq_axis="seq")
CASES["dp-sp ulysses 1f1b"] = _case("dp-pp-sp", "dense", "t8", "1f1b", seq_axis="seq",
                                    sp_mode="ulysses")
for _mode, _s in (("ring", "gpipe"), ("ulysses", "gpipe"), ("ring", "1f1b"),
                  ("ulysses", "1f1b"), ("ring", "interleaved-1f1b")):
    CASES[f"sp-tp {_mode} {_s}"] = _case("pp-sp-tp", "dense4h", "t4", _s, seq_axis="seq",
                                         tp_axis="model", sp_mode=_mode)
CASES["sp-tp-moe gpipe"] = _case("pp-sp-tp", "moe4h sharp", "t4", "gpipe", 2.0,
                                 seq_axis="seq", tp_axis="model")
M = 2  # microbatches, every case


def _cfg(case) -> LlamaConfig:
    cfg = LlamaConfig(**CFGS[case["params"].split()[0]])
    if case["cf"] is not None:
        cfg = replace(cfg, capacity_factor=case["cf"])
    return replace(cfg, use_flash=case["flash"])


def comp_rank(rdv, world: int, params: dict):
    """Every case on the grids of a world of ``world`` ranks: its coordinates,
    the loss (last stage) and its stage's gradients after one step; and each
    grid's lines along every axis through this rank."""
    out = {"lines": {}}
    grids = [g for g, (w, _) in GRIDS.items() if w == world]
    first = GRIDS[grids[0]][1]
    with init_mesh(rdv, first["data"], first["stages"], device="cpu",
                   seq=first.get("seq"), model=first.get("model")) as world_mesh:
        meshes = {grids[0]: world_mesh}
        for g in grids[1:]:
            kw = GRIDS[g][1]
            meshes[g] = world_mesh.regrid(kw["data"], kw["stages"], seq=kw.get("seq"),
                                          model=kw.get("model"))
        for g, mesh in meshes.items():
            out["lines"][g] = {n: mesh.axis(n).ranks for n in mesh.grid.names}
        for name, case in CASES.items():
            if case["grid"] not in meshes:
                continue
            mesh, cfg = meshes[case["grid"]], _cfg(case)
            stage = shard_staged_params(params[case["params"]], cfg, mesh, case["V"],
                                        ep_axis=case["axes"].get("ep_axis"),
                                        tp_axis=case["axes"].get("tp_axis"))
            step = make_pipeline_train_step(
                stage, cfg, torch.optim.SGD(stage.parameters(), lr=0.0), mesh, M,
                case["schedule"], case["V"], **case["axes"])
            loss = step(torch.from_numpy(TOKENS[case["tokens"]]).long())
            out[name] = (mesh.coords, None if loss is None else float(loss),
                         llama.export_grads(stage))
    return out


@pytest.fixture(scope="module")
def params():
    out = {}
    for key, seed in (("dense", 3), ("dense4h", 4), ("moe", 5), ("moe4h", 6)):
        out[key] = llama.export_params(llama.Llama(
            LlamaConfig(**CFGS[key]), device="cpu", generator=torch.Generator().manual_seed(seed)))
    for key in ("moe", "moe4h"):
        sharp = llama.map_blocks(np.copy, out[key]["blocks"])
        sharp["moe"]["router"] = 30.0 * sharp["moe"]["router"]
        out[f"{key} sharp"] = dict(out[key], blocks=sharp)
    return out


def _jax_refs(params, devices8):
    """Each oracle's loss and gradients, keyed as :func:`_oracle` keys them."""
    import jax
    import jax.numpy as jnp

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.parallel.sp import make_sp_loss
    from ddl25spring_tpu.utils import config as jconfig
    from ddl25spring_tpu.utils.mesh import make_mesh

    refs = {}
    for key in {_oracle(c) for c in CASES.values()}:
        kind, pkey, tkey, groups, cf = key
        jcfg = jconfig.LlamaConfig(**CFGS[pkey.split()[0]])
        if cf is not None:
            jcfg = jconfig.LlamaConfig(**{**CFGS[pkey.split()[0]], "capacity_factor": cf})
        tokens = jnp.asarray(TOKENS[tkey])
        if kind == "serial":
            def loss(p, jcfg=jcfg, tokens=tokens):
                return causal_lm_loss(jllama.llama_forward(p, tokens, jcfg), tokens)
        elif kind == "moe":
            def loss(p, jcfg=jcfg, tokens=tokens, groups=groups):
                def per_mb(mb):
                    logits, aux = jllama.llama_forward_with_aux(p, mb, jcfg)
                    return causal_lm_loss(logits, mb) + jcfg.moe_aux_weight * aux

                return jnp.mean(jax.vmap(per_mb)(tokens.reshape(groups, -1, 16)))
        else:
            sp_loss = make_sp_loss(jcfg, make_mesh(devices8[:2], seq=2), seq_axis="seq")

            def loss(p, sp_loss=sp_loss, tokens=tokens, groups=groups):
                mbs = tokens.reshape(groups, -1, 16)
                return jnp.mean(jnp.stack([sp_loss(p, mbs[m]) for m in range(groups)]))

        value, grads = jax.jit(jax.value_and_grad(loss))(params[pkey])
        refs[key] = (float(value), jax.tree.map(np.asarray, grads))
    return refs


def _oracle(case) -> tuple:
    """``(kind, params, tokens, groups, cf)`` of the case's JAX oracle: the
    MoE groups are the ``M D`` per-replica microbatches (SP-MoE: ``M``)."""
    D = GRIDS[case["grid"]][1]["data"]
    if case["params"].startswith("dense"):
        return "serial", case["params"], case["tokens"], None, None
    if "seq_axis" in case["axes"]:
        return "sp-moe", case["params"], case["tokens"], M, case["cf"]
    return "moe", case["params"], case["tokens"], M * D, case["cf"]


@pytest.fixture(scope="module")
def runs(params, devices8, tmp_path_factory):
    """Both worlds' results, and the JAX references computed meanwhile."""
    with ThreadPoolExecutor(2) as pool:
        worlds = {w: pool.submit(spawn, comp_rank, w, w, params, timeout=240,
                                 tmpdir=str(tmp_path_factory.mktemp(f"rdv{w}")))
                  for w in (4, 8)}
        refs = _jax_refs(params, devices8)
        return {w: f.result() for w, f in worlds.items()}, refs


def _merge_ep(shards: list[dict]) -> dict:
    """One stage's export from its replicas' expert slices (dim 1 of the
    ``[Lc, E, ...]`` expert stacks)."""
    moe = dict(shards[0]["blocks"]["moe"])
    for k in ep.EXPERT_KEYS:
        moe[k] = np.concatenate([s["blocks"]["moe"][k] for s in shards], 1)
    return dict(shards[0], blocks=dict(shards[0]["blocks"], moe=moe))


def _result(runs, name):
    """The case's loss (every last-stage rank's, all equal) and its
    gradients merged into the full tree."""
    case = CASES[name]
    world, kw = GRIDS[case["grid"]]
    grid = _grid(kw["data"], kw["stages"], kw.get("seq"), kw.get("model"), None, world)
    ranks = [r[name] for r in runs[0][world]]
    losses = [loss for _, loss, _ in ranks if loss is not None]
    assert len(losses) == world // grid.size
    np.testing.assert_allclose(losses, losses[0], rtol=1e-7)
    by = {c: g for c, _, g in ranks}
    names = grid.names
    stages = []
    for s in range(grid.size):
        def at(**idx):
            c = [idx.get(n, 0) for n in names]
            c[1] = s
            return by[tuple(c)]

        if "model" in names:
            shards = [at(model=t) for t in range(grid.shape[names.index("model")])]
            stages.append(tp.merge_tp_params(shards, shard_vocab=False))
        elif "ep_axis" in case["axes"]:
            stages.append(_merge_ep([at(data=d) for d in range(grid.data)]))
        else:
            stages.append(at())
    return losses[0], llama.merge_stage_exports(stages, num_chunks=case["V"])


def _close(got, want, atol, rtol):
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=path)


def _against_oracle(runs, name):
    loss, grads = _result(runs, name)
    want_loss, want_grads = runs[1][_oracle(CASES[name])]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _close(grads, want_grads, 2e-4, 2e-3)
    return loss, grads


EP = [n for n in CASES if n.startswith("ep ")]


@pytest.mark.parametrize("name", EP)
def test_ep_dp_pp_expert_sharded_equals_replicated_and_serial(runs, name):
    """EP x DP x PP on every schedule, ample capacity and heavy drops:
    loss and gradients equal the replicated-expert pipeline's and JAX's
    per-microbatch oracle (routing is per replica, before the all-to-all);
    the expert stacks' gradients are whole once divided by D."""
    loss, grads = _against_oracle(runs, name)
    want_loss, want_grads = _against_oracle(runs, name.replace("ep ", "replicated "))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    _close(grads, want_grads, 2e-5, 2e-4)
    assert np.abs(grads["blocks"]["moe"]["w_gate"]).max() > 0


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(("tp ", "dp-tp "))])
def test_pipeline_tp_equals_serial(runs, name):
    _against_oracle(runs, name)


@pytest.mark.parametrize("name", [n for n in CASES if "tp-moe" in n])
def test_pipeline_tp_moe_equals_serial(runs, name):
    _against_oracle(runs, name)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(("sp ", "dp-sp "))])
def test_pipeline_sp_equals_serial(runs, name):
    _against_oracle(runs, name)


@pytest.mark.parametrize("name", ["sp-moe gpipe", "sp-tp-moe gpipe"])
def test_pipeline_sp_moe_equals_sp_oracle(runs, name):
    """Each seq shard dispatches its own tokens and the aux is the shards'
    mean: JAX's ``make_sp_loss`` per microbatch, at tp 1 and 2."""
    _against_oracle(runs, name)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("sp-tp ")])
def test_pipeline_sp_tp_equals_serial(runs, name):
    _against_oracle(runs, name)


def test_every_rank_sees_the_grid_as_make_mesh_lays_it_out(runs, devices8):
    """Every axis' line through every rank, on the grids of both worlds,
    is the devices that ``make_mesh`` puts along that axis through the
    rank's device: rank ``r`` is device ``r`` of the row-major reshape."""
    from ddl25spring_tpu.utils.mesh import make_mesh

    for g, (world, kw) in GRIDS.items():
        names = {"data": kw["data"], "stage": kw["stages"],
                 **{n: kw[n] for n in ("seq", "model") if kw.get(n)}}
        devs = make_mesh(devices8[:world], **names).devices
        ids = np.vectorize(lambda d: d.id)(devs)
        for r, rank in enumerate(runs[0][world]):
            at = tuple(int(i) for i in np.argwhere(ids == devices8[r].id)[0])
            for k, n in enumerate(names):
                idx = list(at)
                idx[k] = slice(None)
                want = tuple(devices8.index(d) for d in devs[tuple(idx)])
                assert rank["lines"][g][n] == want, (g, r, n)


def test_three_axis_grid_numbering_and_lines():
    """``(data, stage, model)``: ``r = (d S + s) T + t``; the pipeline's peers
    differ only in ``stage``; a line over two axes runs row-major."""
    grid = _grid(2, 2, None, 2, None, 8)
    assert grid.names == ("data", "stage", "model") and grid.shape == (2, 2, 2)
    assert [grid.coords(r) for r in range(8)] == [
        (d, s, t) for d in range(2) for s in range(2) for t in range(2)]
    assert all(grid.rank(*grid.coords(r)) == r for r in range(8))
    assert [grid.next_rank(r) for r in range(8)] == [2, 3, None, None, 6, 7, None, None]
    assert [grid.prev_rank(r) for r in range(8)] == [None, None, 0, 1, None, None, 4, 5]
    assert grid.line(5, "data") == [1, 5] and grid.line(5, "model") == [4, 5]
    assert grid.line(5, ("data", "model")) == [0, 1, 4, 5]
    assert grid.lines("stage") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    sst = _grid(1, 2, 2, 2, None, 8)
    assert sst.names == ("data", "stage", "seq", "model")
    assert sst.coords(5) == (0, 1, 0, 1) and sst.line(5, "seq") == [5, 7]
    # the 2-D grids keep their numbering and helpers
    assert RankGrid(2, 3).dp_ranks(1) == [1, 4] and RankGrid(2, 3).axis_ranks(1) == [3, 4, 5]
    with pytest.raises(ValueError, match="needs 8 ranks"):
        _grid(2, 2, None, 2, None, 4)
    with pytest.raises(ValueError, match="only stages=, seq= or model="):
        _grid(1, 2, None, None, 2, 4)
    with pytest.raises(ValueError, match="not distinct names"):
        RankGrid(1, 2, "model", (("seq", 2),))


# ------------------------------------------------------------------ refusals


def _fake_mesh(data, stages, seq=None, model=None) -> Mesh:
    """A mesh object of rank 0 with no process group: enough for the checks,
    which read only the grid."""
    grid = _grid(data, stages, seq, model, None,
                 data * stages * (seq or 1) * (model or 1))
    return Mesh(grid, 0, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {n: None for n in grid.names})


def _refusal(exc, match, cfg, mesh, schedule="gpipe", V=1, **axes):
    cfg = LlamaConfig(**cfg)
    if V > 1:
        stage = llama.LlamaChunkedStage(cfg, 0, mesh.grid.size, V, device="cpu",
                                        generator=torch.Generator())
    else:
        stage = llama.LlamaStage(cfg, 0, mesh.grid.size, device="cpu",
                                 generator=torch.Generator())
    with pytest.raises(exc, match=match):
        make_pipeline_train_step(stage, cfg, torch.optim.SGD(stage.parameters(), lr=0.0),
                                 mesh, M, schedule, V, **axes)


def test_compositions_refuse_what_the_jax_package_refuses(params):
    moe, dense = CFGS["moe"], CFGS["dense"]
    dp_pp, pp_tp, pp_sp = _fake_mesh(2, 2), _fake_mesh(1, 2, model=2), _fake_mesh(1, 2, seq=2)
    with pytest.raises(NotImplementedError, match="exclusive"):
        shard_staged_params(params["moe"], LlamaConfig(**moe), _fake_mesh(2, 2, model=2),
                            ep_axis="data", tp_axis="model")
    _refusal(NotImplementedError, "exclusive", moe, _fake_mesh(2, 2, model=2),
             ep_axis="data", tp_axis="model")
    for schedule, V in (("1f1b-stash", 1), ("interleaved", 2)):
        _refusal(NotImplementedError, "residual", dense, pp_sp, schedule, V, seq_axis="seq")
    _refusal(NotImplementedError, "seq_axis with ep_axis", moe, _fake_mesh(2, 2, seq=2),
             ep_axis="data", seq_axis="seq")
    for schedule, V in (("1f1b", 1), ("interleaved-1f1b", 2)):
        _refusal(NotImplementedError, "dense", moe, pp_sp, schedule, V, seq_axis="seq")
    _refusal(ValueError, "needs schedule='interleaved'", dense, pp_sp, "gpipe", 2,
             seq_axis="seq")
    _refusal(ValueError, "unknown SP mode 'zigzag'", dense, pp_sp, seq_axis="seq",
             sp_mode="zigzag")
    _refusal(ValueError, r"local heads \(1\) divisible by the 'seq' axis size \(2\)", dense,
             _fake_mesh(1, 2, seq=2, model=2), seq_axis="seq", tp_axis="model",
             sp_mode="ulysses")
    _refusal(ValueError, r"num_heads \(2\) not divisible by model=4", dense,
             _fake_mesh(1, 2, model=4), tp_axis="model")
    _refusal(ValueError, r"n_experts \(6\) not divisible by model=4",
             dict(moe, num_heads=4, n_experts=6), _fake_mesh(1, 2, model=4), tp_axis="model")
    _refusal(ValueError, "ep_axis given but cfg.n_experts == 0", dense, dp_pp, ep_axis="data")
    _refusal(ValueError, "must be the data axis", moe, dp_pp, ep_axis="stage")
    _refusal(ValueError, "3 experts not divisible by data=2", dict(moe, n_experts=3), dp_pp,
             ep_axis="data")
    # the layouts that hold: no refusal before a step would run
    assert pp_tp.axis("model").size == 2
