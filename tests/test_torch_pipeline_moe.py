"""Switch-MoE LLaMA through the port's pipeline executor, on the CPU, against
the JAX package's serial oracle.

The JAX tests' ``MOE_CFG`` (vocab 64, dmodel 32, 2 heads, 4 layers, ctx 16,
fp32, E 4, capacity factor 2.0) and their oracle
(``tests/test_pipeline.py::serial_moe_loss``): a stage dispatches the ``[mb
L, D]`` tokens of one microbatch, so the pipeline's loss is the mean over
the ``M D`` microbatches of ``causal_lm_loss + w aux`` from JAX's
``llama_forward_with_aux``, routing and drops included.  One spawned gloo
world of 4 ranks runs a 1 x 4 pipeline (``gpipe``, ``1f1b``; M = 4) and the
2 x 2 DP x PP grid under all five schedules (``interleaved*`` with 2 chunks;
M = 2), one step at SGD lr 0 each: the loss on the last stage and the
gradients, replica 0's stage exports merged.  A capacity factor of 0.5 on
``gpipe`` runs the drop path.

Tolerances (the JAX pipeline tests'): loss rtol 1e-5, gradients atol 2e-4 +
rtol 2e-3; schedule against schedule, gradients within 1e-6.  The ranks
import this module, so it imports jax only inside the fixtures and tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipeline_train_step,
    shard_staged_params,
)
from ddl25spring_tpu_torch.utils.config import LlamaConfig, replace  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import init_mesh  # noqa: E402

MOE = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=4, ctx_size=16,
           dtype="float32", n_experts=4, capacity_factor=2.0)
CFG = LlamaConfig(**MOE)
TOKENS = np.random.default_rng(7).integers(0, 64, (8, 16)).astype(np.int32)
# case -> (data, stages, M, schedule, chunks, capacity factor)
CASES = {"gpipe 1x4": (1, 4, 4, "gpipe", 1, 2.0), "1f1b 1x4": (1, 4, 4, "1f1b", 1, 2.0),
         "gpipe 2x2": (2, 2, 2, "gpipe", 1, 2.0), "1f1b 2x2": (2, 2, 2, "1f1b", 1, 2.0),
         "1f1b-stash 2x2": (2, 2, 2, "1f1b-stash", 1, 2.0),
         "interleaved 2x2": (2, 2, 2, "interleaved", 2, 2.0),
         "interleaved-1f1b 2x2": (2, 2, 2, "interleaved-1f1b", 2, 2.0),
         "gpipe 2x2 drops": (2, 2, 2, "gpipe", 1, 0.5)}



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's default threads contend for its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def moe_rank(rdv, params):
    """Every case: this rank's coordinates, the loss (last stage) and its
    stage's gradients after one SGD step at lr 0."""
    out = {}
    with init_mesh(rdv, 1, stages=4, device="cpu") as world:
        grids = {1: world, 2: world.regrid(2, stages=2)}
        for name, (data, _, M, schedule, V, cf) in CASES.items():
            mesh = grids[data]
            cfg = replace(CFG, capacity_factor=cf)
            stage = shard_staged_params(params, cfg, mesh, num_chunks=V)
            step = make_pipeline_train_step(stage, cfg, torch.optim.SGD(stage.parameters(), lr=0.0),
                                            mesh, M, schedule, num_chunks=V)
            loss = step(torch.from_numpy(TOKENS).long())
            out[name] = (mesh.coords, None if loss is None else float(loss),
                         llama.export_grads(stage))
    return out


@pytest.fixture(scope="module")
def params():
    return llama.export_params(
        llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(4)))


def _serial_refs(params):
    """JAX's ``serial_moe_loss`` (mean over the microbatch groups of ``ce + w
    aux``) and its gradients, per (groups, capacity factor) the cases use."""
    import jax
    import jax.numpy as jnp

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss
    from ddl25spring_tpu.utils import config as jconfig

    refs = {}
    for groups, cf in {(d * M, cf) for d, _, M, _, _, cf in CASES.values()}:
        jcfg = jconfig.LlamaConfig(**{**MOE, "capacity_factor": cf})

        def serial(p, groups=groups, jcfg=jcfg):
            def per_mb(mb):
                logits, aux = jllama.llama_forward_with_aux(p, mb, jcfg)
                return causal_lm_loss(logits, mb) + jcfg.moe_aux_weight * aux

            return jnp.mean(jax.vmap(per_mb)(TOKENS.reshape(groups, -1, 16)))

        loss, grads = jax.jit(jax.value_and_grad(serial))(params)
        refs[groups, cf] = (float(loss), jax.tree.map(np.asarray, grads))
    return refs


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, moe_rank, 4, params, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        refs = _serial_refs(params)
        return ranks.result(), refs


def _case(ranks, name):
    """The case's loss on the last stages (every replica's, all equal) and
    replica 0's gradients merged into the full tree."""
    data, S, M, _, V, cf = CASES[name]
    losses = [r[name][1] for r in ranks if r[name][0][1] == S - 1]
    assert len(losses) == data and all(x == losses[0] for x in losses)
    stages = sorted((r[name] for r in ranks if r[name][0][0] == 0), key=lambda r: r[0][1])
    return losses[0], llama.merge_stage_exports([g for _, _, g in stages], num_chunks=V)


def _against_serial(runs, name):
    ranks, refs = runs
    data, _, M, _, _, cf = CASES[name]
    want_loss, want_grads = refs[data * M, cf]
    loss, grads = _case(ranks, name)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert [p for p, _ in flatten(grads)] == [p for p, _ in flatten(want_grads)]
    for (path, a), (_, b) in zip(flatten(grads), flatten(want_grads)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=path)
    return grads


def _same(a, b, atol=1e-6):
    for (path, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=path)


def test_gpipe_moe_loss_and_grads_equal_serial(runs):
    grads = _against_serial(runs, "gpipe 1x4")
    # the router's gradient flows (gates and aux are differentiable)
    assert np.abs(grads["blocks"]["moe"]["router"]).max() > 0


def test_1f1b_moe_equals_gpipe_and_serial(runs):
    grads = _against_serial(runs, "1f1b 1x4")
    _same(grads, _case(runs[0], "gpipe 1x4")[1])


def test_moe_dp_pp_2d_mesh_equals_serial(runs):
    grads = _against_serial(runs, "gpipe 2x2")
    for name in ("1f1b 2x2", "1f1b-stash 2x2"):
        _same(_against_serial(runs, name), grads)


def test_moe_dp_pp_drops_equal_serial(runs):
    """Capacity factor 0.5: the stages drop tokens, each microbatch group as
    the serial oracle drops them."""
    _against_serial(runs, "gpipe 2x2 drops")


def test_interleaved_moe_equals_serial(runs):
    _against_serial(runs, "interleaved 2x2")


def test_interleaved_1f1b_moe_equals_serial(runs):
    _same(_against_serial(runs, "interleaved-1f1b 2x2"), _case(runs[0], "interleaved 2x2")[1])


def test_moe_stage_builds_and_llama_forward_refuses(params):
    """A MoE stage holds a ``moe`` subtree in every block; its plain forward
    and ``llama_forward`` raise (the aux would be lost), ``with_aux`` runs."""
    stage = llama.LlamaStage(CFG, 0, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(hasattr(b, "moe") and not hasattr(b, "w_gate") for b in stage.blocks)
    tokens = torch.from_numpy(TOKENS[:2]).long()
    with pytest.raises(NotImplementedError, match="n_experts > 0"):
        llama.stage_forward(stage, tokens, CFG)
    with torch.no_grad():
        out, aux = llama.stage_forward(stage, tokens, CFG, with_aux=True)
    assert out.shape == (2, 16, 32) and float(aux) > 0
    model = llama.load_jax_params(
        llama.Llama(CFG, device="cpu", generator=torch.Generator().manual_seed(0)), params)
    with pytest.raises(NotImplementedError, match="n_experts > 0"):
        llama.llama_forward(model, tokens, CFG)
