"""The port's expert parallelism against the JAX package's, on the CPU.

Twins of ``tests/test_ep.py`` (D 16, F 32, E 4, T 64; fp32), from one set of
seeded numpy weights and tokens.  The single-process layer (``moe_ffn``,
``_dispatch_tensors``) is held to JAX's on the same inputs; the
expert-parallel layer runs in one spawned gloo world of 4 ranks, taking each
layout in turn (``Mesh.regrid``): ``ep = 4`` (1 x 4), ``ep = 2`` (2 x 2, each
replica an expert group of its own on the whole batch) and EP x DP (2 x 2
with ``data_axis``, tokens sharded over all four ranks).  It is held to
JAX's ``make_ep_moe_fn`` on as many CPU devices and, under overflow, to
JAX's ``moe_ffn`` per shard group, as the JAX tests hold theirs.

Tolerances are the JAX tests': outputs atol 1e-6 + rtol 1e-5, gradients
atol 2e-6 + rtol 1e-4, the aux estimator of the sharded layer rtol 5e-3
against the dense one.  The JAX references compile while the ranks run.
The ranks import this module, so it imports jax only inside the fixtures
and tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel import ep  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import all_to_all  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

D, F, E, T = 16, 32, 4, 64
_rng = np.random.default_rng(0)
PARAMS = {"router": 0.02 * _rng.standard_normal((D, E)),
          "w_gate": 0.02 * _rng.standard_normal((E, D, F)),
          "w_up": 0.02 * _rng.standard_normal((E, D, F)),
          "w_down": 0.02 * _rng.standard_normal((E, F, D))}
PARAMS = {k: v.astype(np.float32) for k, v in PARAMS.items()}
X = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
TARGET = np.random.default_rng(2).standard_normal((T, D)).astype(np.float32)
LLAMA = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16,
             dtype="float32", n_experts=4, capacity_factor=4.0)
LLAMA_TOKENS = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(np.int32)
TRAIN_STEPS, TRAIN_LR = 3, 0.1
# case -> (grid: "ep4" 1x4 | "ep2" 2x2 | "2d" 2x2 with data_axis, cf, top_k)
CASES = {"ample ep2": ("ep2", float(E), 1), "ample ep4": ("ep4", float(E), 1),
         "tight ep2": ("ep2", 0.5, 1), "tight ep4": ("ep4", 0.5, 1),
         "top2 ep2": ("ep2", float(E), 2), "top2 ep4": ("ep4", float(E), 2),
         "ample 2d": ("2d", float(E), 1)}



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's default threads contend for its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layout(grids, name):
    return grids[name], ("data" if name == "2d" else None)


def ep_rank(rdv):
    """Every case on this rank: its ``[E/ep]`` slice, the global output and
    aux, the summed kept counts, and the gradients of ``mean(y^2)`` (router
    whole, expert slices); the all-to-all layout; a few EP train steps; the
    EP LLaMA forward."""
    out = {}
    with init_mesh(rdv, 1, expert=4, device="cpu") as world:
        grids = {"ep4": world, "ep2": world.regrid(2, expert=2)}
        grids["2d"] = grids["ep2"]
        for case, (grid, cf, k) in CASES.items():
            mesh, data_axis = _layout(grids, grid)
            axis = mesh.axis("expert")
            p = ep.shard_moe_params(PARAMS, axis.size, axis.index)
            f = ep.make_ep_moe_fn(mesh, capacity_factor=cf, return_stats=True,
                                  data_axis=data_axis, top_k=k)
            y, aux, stats = f(p, _t(X))
            (y ** 2).mean().backward()
            out[case] = {"index": axis.index, "y": y.detach().numpy(), "aux": float(aux),
                         "kept": stats["kept"].numpy(), "assigned": stats["assigned"],
                         "grads": {key: p[key].grad.numpy() for key in ep.MOE_KEYS}}
        # the all-to-all over a leading dim of ep: slot j goes to index j, and
        # slot j of the result came from index j (lax.all_to_all tiled=False)
        axis = world.axis("expert")
        sent = torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2) + 100 * axis.index
        out["a2a"] = (axis.index, all_to_all(sent, axis, 0, 0).numpy())
        # the standalone EP train step, ep = 2, plain SGD
        mesh = grids["ep2"]
        axis = mesh.axis("expert")
        p = ep.shard_moe_params(PARAMS, 2, axis.index)
        step = ep.make_ep_train_step(p, torch.optim.SGD(p.parameters(), lr=TRAIN_LR), mesh)
        out["train"] = [float(step((_t(X), _t(TARGET)))) for _ in range(TRAIN_STEPS)]
        # MoE LLaMA with the EP layer in every block, ep = 2
        cfg = LlamaConfig(**LLAMA)
        model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        fn = ep.make_ep_moe_fn(mesh, capacity_factor=cfg.capacity_factor)
        with torch.no_grad():
            logits, aux = llama.llama_forward_with_aux(model, _t(LLAMA_TOKENS).long(), cfg)
            for block in model.blocks:
                block.moe = ep.shard_moe_params(block.moe, 2, axis.index)
            x = llama.embed(model, _t(LLAMA_TOKENS).long(), cfg)
            x, ep_aux = llama.apply_blocks(model.blocks, x, cfg, moe_fn=fn)
            out["llama"] = (logits.numpy(), float(aux),
                            llama.unembed(model, x, cfg).numpy(), float(ep_aux))
    return out


def _jax_refs(devices8):
    """JAX's dense layer per case (whole batch, and per shard group under
    overflow), its ``make_ep_moe_fn`` per case, the dense gradients, its
    all-to-all, its EP train step and LLaMA forward."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu.parallel import ep as jep
    from ddl25spring_tpu.utils.mesh import make_mesh

    x = jnp.asarray(X)
    refs = {}
    for case, (grid, cf, k) in CASES.items():
        n_ep = 4 if grid == "ep4" else 2
        n_shards = 4 if grid in ("ep4", "2d") else 2

        def dense_loss(p):
            y, aux = jep.moe_ffn(p, x, cf, top_k=k)
            return (y ** 2).mean(), (y, aux)

        (_, (y, aux)), g = jax.jit(jax.value_and_grad(dense_loss, has_aux=True))(PARAMS)
        kept = np.zeros(E, np.float32)
        for sx in np.split(X, n_shards):
            kept += np.asarray(jep.moe_ffn(PARAMS, jnp.asarray(sx), cf, return_stats=True,
                                           top_k=k)[2]["kept"])
        mesh = (make_mesh(devices8[:4], data=2, expert=2) if grid == "2d"
                else make_mesh(devices8[:n_ep], expert=n_ep))
        f = jep.make_ep_moe_fn(mesh, capacity_factor=cf, return_stats=True, top_k=k,
                               data_axis="data" if grid == "2d" else None)
        y_ep, aux_ep, st = jax.jit(f)(jep.shard_moe_params(PARAMS, mesh), x)
        refs[case] = {"y": np.asarray(y), "aux": float(aux), "grads": jax.tree.map(np.asarray, g),
                      "kept_groups": kept, "y_ep": np.asarray(y_ep), "aux_ep": float(aux_ep),
                      "kept_ep": np.asarray(st["kept"]), "assigned_ep": float(st["assigned"])}
    # lax.all_to_all(tiled=False) on 4 devices, each sending its [4, 3, 2] block
    mesh = make_mesh(devices8[:4], expert=4)
    blocks = np.stack([np.arange(24, dtype=np.float32).reshape(4, 3, 2) + 100 * i
                       for i in range(4)])
    a2a = jax.jit(jax.shard_map(
        lambda b: jax.lax.all_to_all(b[0], "expert", 0, 0, tiled=False)[None],
        mesh=mesh, in_specs=jax.sharding.PartitionSpec("expert"),
        out_specs=jax.sharding.PartitionSpec("expert")))(blocks)
    refs["a2a"] = np.asarray(a2a)
    # JAX's EP train step (SGD), ep = 2
    mesh = make_mesh(devices8[:2], expert=2)
    tx = optax.sgd(TRAIN_LR)
    step = jep.make_ep_train_step(tx, mesh, capacity_factor=1.25)
    p = jep.shard_moe_params(PARAMS, mesh)
    state, losses = tx.init(p), []
    for _ in range(TRAIN_STEPS):
        p, state, loss = step(p, state, (x, jnp.asarray(TARGET)))
        losses.append(float(loss))
    refs["train"] = losses
    return refs


def _jax_llama(params):
    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.utils import config as jconfig

    logits, aux = jllama.llama_forward_with_aux(params, LLAMA_TOKENS,
                                                jconfig.LlamaConfig(**LLAMA))
    return np.asarray(logits), float(aux)


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    """The 4 ranks' results and the JAX references, computed meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, ep_rank, 4, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _jax_refs(devices8)
        cfg = LlamaConfig(**LLAMA)
        params = llama.export_params(
            llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(5)))
        refs["llama"] = _jax_llama(params)
        return ranks.result(), refs


def _close(a, b, atol=1e-6, rtol=1e-5, msg=""):
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=msg)


# ------------------------------------------------------ the single-process layer


def _moe(p=PARAMS, x=X, **kw):
    return ep.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), **kw)


def _jmoe(p=PARAMS, x=X, **kw):
    import jax.numpy as jnp

    from ddl25spring_tpu.parallel.ep import moe_ffn

    return moe_ffn(p, jnp.asarray(x), **kw)


def test_moe_routes_to_multiple_experts():
    logits = _t(X) @ _t(PARAMS["router"])
    assert len(set(logits.argmax(-1).tolist())) > 1


@pytest.mark.parametrize("cf", [0.25, float(E)])
def test_capacity_overflow_drops_tokens(cf):
    """Tight capacity drops tokens (their rows of y are 0), the kept rows
    equal the ample layer's; each side equals JAX's ``moe_ffn`` (y, aux and
    the kept counts)."""
    y, aux, st = _moe(capacity_factor=cf, return_stats=True)
    jy, jaux, jst = _jmoe(capacity_factor=cf, return_stats=True)
    _close(y.numpy(), np.asarray(jy))
    _close(float(aux), float(jaux))
    np.testing.assert_array_equal(st["kept"].numpy(), np.asarray(jst["kept"]))
    assert st["assigned"] == float(jst["assigned"]) == T
    if cf < 1:
        y_ample, _ = _moe(capacity_factor=float(E))
        dropped = (y == 0).all(-1)
        assert dropped.any(), "tight capacity should drop some tokens"
        assert int(dropped.sum()) == T - int(st["kept"].sum())
        _close(y[~dropped].numpy(), y_ample[~dropped].numpy())


def test_top2_matches_explicit_expert_sum_and_jax():
    """``top_k=2`` at ample capacity is the renormalized-gate-weighted sum of
    each token's two highest-prob experts' outputs, and JAX's top-2 layer."""
    y, aux = _moe(capacity_factor=float(E), top_k=2)
    x, p = _t(X), {k: _t(v) for k, v in PARAMS.items()}
    gates, experts = torch.softmax(x @ p["router"], -1).topk(2, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    per_expert = torch.stack([torch.nn.functional.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
                              @ p["w_down"][e] for e in range(E)])  # [E, T, D]
    expect = sum(gates[:, j:j + 1] * per_expert[experts[:, j], torch.arange(T)]
                 for j in range(2))
    _close(y.numpy(), expect.numpy(), atol=1e-5, rtol=1e-4)
    jy, jaux = _jmoe(capacity_factor=float(E), top_k=2)
    _close(y.numpy(), np.asarray(jy))
    _close(float(aux), float(jaux))
    assert float(aux) > 0


def test_top1_unchanged_by_topk_plumbing():
    y1, aux1 = _moe(capacity_factor=2.0)
    y2, aux2 = _moe(capacity_factor=2.0, top_k=1)
    assert torch.equal(y1, y2) and float(aux1) == float(aux2)


def test_top2_overflow_drops_second_choices_first():
    """Choice-major filling (JAX's crafted 4-token case: t0 wants A second,
    t1..t3 want it first, C = 2), then JAX's ``_dispatch_tensors`` on random
    logits at top 1 and 2 under overflow: every tensor equal."""
    import jax.numpy as jnp

    from ddl25spring_tpu.parallel.ep import _dispatch_tensors as jdispatch

    A, B = 0, 1
    logits = torch.tensor([[2.0, 5.0], [5.0, 2.0], [5.0, 2.0], [5.0, 2.0]])
    disp, _, _, kept = ep._dispatch_tensors(logits, 2, top_k=2)
    assert disp[0, A].sum() == 0 and disp[1, A].sum() == 1 and disp[2, A].sum() == 1
    assert disp[3, A].sum() == 0
    assert disp[0, B].sum() == 1 and disp[1, B].sum() == 1
    assert disp[2, B].sum() == 0 and disp[3, B].sum() == 0
    np.testing.assert_array_equal(kept.numpy(), [2.0, 2.0])
    logits = np.random.default_rng(9).standard_normal((T, E)).astype(np.float32) * 3
    for k in (1, 2):
        C = ep.capacity(T, 0.5, k, E)
        got = ep._dispatch_tensors(_t(logits), C, k)
        want = jdispatch(jnp.asarray(logits), C, k)
        for name, a, b in zip(("disp", "combine", "aux", "kept"), got, want):
            _close(a.numpy(), np.asarray(b), msg=f"top {k} {name}")
    y, _, st = _moe(capacity_factor=0.5, return_stats=True, top_k=2)
    assert (st["kept"] <= ep.capacity(T, 0.5, 2, E)).all()
    assert st["assigned"] == 2 * T and st["assigned"] - float(st["kept"].sum()) > 0
    assert torch.isfinite(y).all()


def test_capacity_is_the_jax_truncation():
    for tokens, cf, k in ((768, 1.25, 1), (768, 1.25, 2), (64, 0.5, 1), (3, 0.1, 1),
                          (100, 1.1, 2), (64, 0.25, 1)):
        assert ep.capacity(tokens, cf, k, E) == max(1, int(tokens * cf * k / E))
    assert ep.capacity(768, 1.25, 1, 4) == 240 and ep.capacity(768, 1.25, 2, 4) == 480


def test_top2_llama_trains():
    """A top-2 MoE LLaMA trains through ``causal_lm_loss + w aux``."""
    cfg = LlamaConfig(**{**LLAMA, "capacity_factor": 2.0, "moe_top_k": 2})
    model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = _t(np.random.default_rng(1).integers(0, 64, (4, 16))).long()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(12):
        opt.zero_grad()
        logits, aux = llama.llama_forward_with_aux(model, tokens, cfg)
        loss = causal_lm_loss(logits, tokens) + cfg.moe_aux_weight * aux
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


def test_shard_moe_params_are_jaxs_per_device_slices(devices8):
    from ddl25spring_tpu.parallel.ep import shard_moe_params
    from ddl25spring_tpu.utils.mesh import make_mesh

    for n in (2, 4):
        mesh = make_mesh(devices8[:n], expert=n)
        sharded = shard_moe_params(PARAMS, mesh)
        for i, dev in enumerate(devices8[:n]):
            mine = ep.shard_moe_params(PARAMS, n, i)
            for key in ep.MOE_KEYS:
                shard, = [s for s in sharded[key].addressable_shards if s.device == dev]
                np.testing.assert_array_equal(mine[key].detach().numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="do not split"):
        ep.shard_moe_params(PARAMS, 3, 0)


# ------------------------------------------------------------ the EP layer


def _shard_order(ranks, case):
    return sorted(ranks, key=lambda r: r[case]["index"])


@pytest.mark.parametrize("case", ["ample ep2", "ample ep4"])
def test_ep_equals_dense_with_ample_capacity(runs, case):
    ranks, refs = runs
    want = refs[case]
    for r in ranks:
        _close(r[case]["y"], want["y"])
        _close(r[case]["y"], want["y_ep"])
        np.testing.assert_allclose(r[case]["aux"], want["aux"], rtol=5e-3)
        np.testing.assert_allclose(r[case]["aux"], want["aux_ep"], rtol=1e-5)


def test_ep_grads_equal_dense(runs):
    """Output-path gradients: the router's whole on every rank, each rank's
    expert slice, against the dense layer's."""
    ranks, refs = runs
    want = refs["ample ep2"]["grads"]
    for r in ranks:
        got = r["ample ep2"]
        El = E // 2
        sl = slice(got["index"] * El, (got["index"] + 1) * El)
        for key in ep.MOE_KEYS:
            w = want[key] if key == "router" else want[key][sl]
            _close(got["grads"][key], w, atol=2e-6, rtol=1e-4, msg=key)


@pytest.mark.parametrize("case", ["tight ep2", "tight ep4"])
def test_ep_drop_accounting_matches_dense(runs, case):
    """Under overflow the kept counts equal the dense layer's over each shard
    group (JAX's oracle) and JAX's EP layer's; dropped tokens are zero rows."""
    ranks, refs = runs
    want = refs[case]
    counts = np.bincount((X @ PARAMS["router"]).argmax(-1), minlength=E)
    assert counts.max() > counts.min()
    for r in ranks:
        got = r[case]
        np.testing.assert_array_equal(got["kept"], want["kept_groups"])
        np.testing.assert_array_equal(got["kept"], want["kept_ep"])
        assert got["assigned"] == want["assigned_ep"] == T
        dropped = T - got["kept"].sum()
        assert dropped > 0
        assert (got["y"] == 0).all(-1).sum() == dropped
        _close(got["y"], want["y_ep"])
        np.testing.assert_allclose(got["aux"], want["aux_ep"], rtol=1e-5)


def test_ep_dp_2d_grid_equals_dense(runs):
    """EP x DP on 2 x 2 (data x expert), tokens over all four ranks: output
    and gradients equal the dense layer's, every token kept."""
    ranks, refs = runs
    want = refs["ample 2d"]
    for r in ranks:
        got = r["ample 2d"]
        _close(got["y"], want["y"])
        _close(got["y"], want["y_ep"])
        assert got["assigned"] == T and got["kept"].sum() == T
        sl = slice(got["index"] * 2, (got["index"] + 1) * 2)
        for key in ep.MOE_KEYS:
            w = want["grads"][key] if key == "router" else want["grads"][key][sl]
            _close(got["grads"][key], w, atol=2e-6, rtol=1e-4, msg=key)


@pytest.mark.parametrize("case", ["top2 ep2", "top2 ep4"])
def test_ep_top2_equals_dense(runs, case):
    ranks, refs = runs
    want = refs[case]
    for r in ranks:
        _close(r[case]["y"], want["y"])
        _close(r[case]["y"], want["y_ep"])
        np.testing.assert_allclose(r[case]["aux"], want["aux"], rtol=5e-3)


def test_all_to_all_is_the_untiled_jax_layout(runs):
    """``comm.all_to_all(x, axis, 0, 0)`` on a leading dim of ``ep`` moves
    what ``lax.all_to_all(x, axis, 0, 0, tiled=False)`` moves."""
    ranks, refs = runs
    for r in ranks:
        i, got = r["a2a"]
        np.testing.assert_array_equal(got, refs["a2a"][i])


def test_moe_trains_and_matches_jax_ep_step(runs):
    """The EP train step (ep = 2, SGD) takes the losses of JAX's
    ``make_ep_train_step`` and they fall."""
    ranks, refs = runs
    for r in ranks:
        np.testing.assert_allclose(r["train"], refs["train"], rtol=1e-5)
    assert refs["train"][-1] < refs["train"][0]


def test_moe_llama_with_ep_moe_fn(runs):
    """MoE LLaMA with the EP layer in every block (ep = 2, ample capacity)
    equals the single-process forward and JAX's; the aux estimators differ
    per shard, within JAX's 0.25."""
    ranks, refs = runs
    want_logits, want_aux = refs["llama"]
    for r in ranks:
        logits, aux, ep_logits, ep_aux = r["llama"]
        _close(logits, want_logits, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
        _close(ep_logits, want_logits, atol=2e-4, rtol=2e-4)
        assert np.isfinite(ep_aux)
        np.testing.assert_allclose(ep_aux, want_aux, rtol=0.25)
