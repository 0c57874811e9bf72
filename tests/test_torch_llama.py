"""The port's LLaMA pieces and whole model against the JAX package's, on the CPU.

Same inputs from a seeded numpy generator, float32, weights carried across by
``load_jax_params``.  Tolerances: per-piece 1e-6 (the same float32 arithmetic
in another framework), losses 1e-5, logits 1e-4 (two layers of matmuls
accumulated in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu.models import llama as jllama  # noqa: E402
from ddl25spring_tpu.ops import losses as jlosses  # noqa: E402
from ddl25spring_tpu.utils import config as jconfig  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops import losses  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402

SMALL = dict(vocab_size=96, dmodel=64, num_heads=2, n_layers=2, ctx_size=64,
             dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_mirrors_the_reference():
    for name in ("LlamaConfig", "PipelineConfig", "DpPpConfig", "FlConfig"):
        ref = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        port = [(f.name, f.default) for f in dataclasses.fields(getattr(config, name))]
        assert port == ref, name
    cfg = config.LlamaConfig()
    assert (cfg.head_dim, cfg.ffn_dim) == (48, 1152)
    assert config.replace(cfg, n_layers=2).n_layers == 2


def test_rms_norm_and_rope_match():
    x = _rng().standard_normal((2, 16, 4, 32), dtype=np.float32)
    scale = _rng(1).standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(
        llama.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jllama.rms_norm(x, scale)), atol=1e-6)
    cos_j, sin_j = jllama.rope_angles(16, 32)
    cos_t, sin_t = llama.rope_angles(16, 32)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    pos = np.arange(5, 21, dtype=np.float32)  # shifted global positions
    np.testing.assert_allclose(
        llama.rope_angles(16, 32, pos=_t(pos))[1].numpy(),
        np.asarray(jllama.rope_angles(16, 32, pos=pos)[1]), atol=1e-6)
    np.testing.assert_allclose(
        llama.apply_rope(_t(x), cos_t, sin_t).numpy(),
        np.asarray(jllama.apply_rope(x, cos_j, sin_j)), atol=1e-6)


def test_dense_causal_attention_matches():
    q, k, v = (_rng(s).standard_normal((2, 24, 3, 16), dtype=np.float32)
               for s in range(3))
    np.testing.assert_allclose(
        llama.causal_attention(_t(q), _t(k), _t(v), torch.float32).numpy(),
        np.asarray(jllama.causal_attention(q, k, v, jnp.float32)), atol=1e-6)


@pytest.mark.parametrize("name", [
    "causal_lm_loss", "causal_lm_loss_pad", "cross_entropy_logits", "nll_loss",
    "masked_nll_loss", "accuracy", "vae_loss",
])
def test_losses_match(name):
    rng = _rng(3)
    logits = rng.standard_normal((3, 10, 17), dtype=np.float32)
    tokens = rng.integers(0, 17, (3, 10)).astype(np.int32)
    flat = rng.standard_normal((12, 17), dtype=np.float32)
    labels = rng.integers(0, 17, 12).astype(np.int32)
    mask = (rng.random(12) > 0.3).astype(np.float32)
    recon, x, mu, logvar = (rng.standard_normal((4, 6), dtype=np.float32)
                            for _ in range(4))
    logp = flat - np.log(np.exp(flat).sum(-1, keepdims=True))
    args = {
        "causal_lm_loss": ("causal_lm_loss", (logits, tokens), {}),
        "causal_lm_loss_pad": ("causal_lm_loss", (logits, tokens), {"pad_id": 3}),
        "cross_entropy_logits": ("cross_entropy_logits", (flat, labels), {}),
        "nll_loss": ("nll_loss", (logp, labels), {}),
        "masked_nll_loss": ("masked_nll_loss", (logp, labels, mask), {}),
        "accuracy": ("accuracy", (flat, labels), {}),
        "vae_loss": ("vae_loss", (recon, x, mu, logvar), {}),
    }[name]
    fn, a, kw = args
    want = getattr(jlosses, fn)(*a, **kw)
    got = getattr(losses, fn)(*map(_t, a), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small_model():
    cfg = jconfig.LlamaConfig(**SMALL)
    params = jax.tree.map(np.asarray, jllama.init_llama_params(jax.random.PRNGKey(0), cfg))
    model = llama.Llama(config.LlamaConfig(**SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return params, llama.load_jax_params(model, params)


@pytest.mark.parametrize("use_flash", [False, True])
def test_logits_match_jax(small_model, use_flash):
    """Whole-model logits; with ``use_flash`` the JAX side runs the Pallas
    kernels in interpret mode and the port its kernels' plain versions."""
    params, model = small_model
    tokens = _rng(4).integers(0, SMALL["vocab_size"], (2, 64)).astype(np.int32)
    jcfg = jconfig.LlamaConfig(**SMALL, use_flash=use_flash)
    want = jllama.llama_forward(params, tokens, jcfg)
    got = llama.llama_forward(model, _t(tokens).long(),
                              config.LlamaConfig(**SMALL, use_flash=use_flash))
    assert got.dtype == torch.float32 and got.shape == (2, 64, SMALL["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_bridge_round_trips_exactly(small_model):
    params, model = small_model
    out = llama.export_params(model)
    assert jax.tree.structure(out) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        llama.load_jax_params(model, {**params, "embed": params["embed"][:5]})


def test_init_is_seeded_normal_and_moe_is_refused():
    """The seeded init (dense and MoE), and ``llama_forward``'s refusal of a
    MoE config, whose aux would be lost (JAX ``llama.py:280``)."""
    cfg = config.LlamaConfig(**SMALL)
    a = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    b = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    assert torch.equal(a.blocks[0].ln1, torch.ones(64))
    moe_cfg = config.replace(cfg, n_experts=4)
    a = llama.Llama(moe_cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    b = llama.Llama(moe_cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    moe = a.blocks[0].moe
    assert not hasattr(a.blocks[0], "w_gate")
    assert moe.router.shape == (64, 4) and moe.w_gate.shape == (4, 64, 256)
    assert moe.w_down.shape == (4, 256, 64) and abs(moe.w_up.std().item() - 0.02) < 2e-3
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MoE"):
        llama.llama_forward(a, tokens, moe_cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        a(tokens)


MOE = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16,
           dtype="float32", n_experts=4, capacity_factor=2.0)


@pytest.fixture
def one_torch_thread():
    """One torch thread for the MoE tests: the suite runs its files side by
    side on one host, and torch's default threads contend for its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_pair(**kw):
    """The port's MoE ``Llama`` from a seed and its weights as the JAX pytree."""
    cfg = config.LlamaConfig(**{**MOE, **kw})
    model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, model, llama.export_params(model)


def _composite(logits, aux, tokens, cfg):
    return losses.causal_lm_loss(logits, tokens) + cfg.moe_aux_weight * aux


@pytest.mark.parametrize("kw", [{}, {"moe_top_k": 2}, {"capacity_factor": 0.5}],
                         ids=["top1", "top2", "drops"])
@pytest.mark.usefixtures("one_torch_thread")
def test_moe_llama_forward_and_aux(kw):
    """Logits, aux and the gradients of ``causal_lm_loss + w aux`` against
    JAX's ``llama_forward_with_aux`` from the same weights (top 1, top 2,
    and capacity 0.5, which drops); at ample capacity the token-flattened
    dispatch keeps causality and the examples independent."""
    cfg, model, params = _moe_pair(**kw)
    jcfg = jconfig.LlamaConfig(**{**MOE, **kw})
    tokens = _rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    logits, aux = llama.llama_forward_with_aux(model, _t(tokens).long(), cfg)
    assert logits.shape == (2, 16, 64) and torch.isfinite(logits).all()
    assert 0.5 < float(aux.detach()) < 8.0
    jlogits, jaux = jllama.llama_forward_with_aux(params, tokens, jcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    loss = _composite(logits, aux, _t(tokens).long(), cfg)
    loss.backward()

    def jloss_fn(p):
        jl, ja = jllama.llama_forward_with_aux(p, tokens, jcfg)
        return jlosses.causal_lm_loss(jl, tokens) + jcfg.moe_aux_weight * ja

    jloss, jgrads = jax.value_and_grad(jloss_fn)(params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for (path, a), (_, b) in zip(flatten(llama.export_grads(model)), flatten(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=path)
    if kw:
        return
    changed = tokens.copy()
    changed[0, 10] = (changed[0, 10] + 1) % 64
    with torch.no_grad():
        logits_b, _ = llama.llama_forward_with_aux(model, _t(changed).long(), cfg)
    np.testing.assert_allclose(logits[0, :10].detach().numpy(), logits_b[0, :10].numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits[1].detach().numpy(), logits_b[1].numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_moe_llama_trains():
    """The switch recipe, LM loss + weighted aux, falls under Adam, and the
    router's gradient flows."""
    cfg, model, _ = _moe_pair()
    tokens = _t(_rng(1).integers(0, 64, (4, 16))).long()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    history = []
    for _ in range(30):
        opt.zero_grad()
        loss = _composite(*llama.llama_forward_with_aux(model, tokens, cfg), tokens, cfg)
        loss.backward()
        if not history:
            assert model.blocks[0].moe.router.grad.abs().max() > 0
        opt.step()
        history.append(float(loss.detach()))
    assert history[-1] < 0.5 * history[0], history[::10]
    assert all(np.isfinite(history))


@pytest.mark.usefixtures("one_torch_thread")
def test_moe_bridge_round_trips_flat_and_staged():
    """A JAX MoE pytree (structure from ``jax.eval_shape`` of its init) goes
    across bit for bit: flat, staged ``[S, L/S, ...]`` into ``LlamaStage``s
    and interleaved ``[S, V, Lc, ...]`` into ``LlamaChunkedStage``s; the
    splits equal JAX's."""
    cfg = config.LlamaConfig(**{**MOE, "n_layers": 4})
    jcfg = jconfig.LlamaConfig(**{**MOE, "n_layers": 4})
    shapes = jax.eval_shape(lambda: jllama.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = _rng(5)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = llama.load_jax_params(
        llama.Llama(cfg, device="cpu", generator=torch.Generator()), params)
    out = llama.export_params(model)
    assert jax.tree.structure(out) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for S, V in ((2, 1), (2, 2)):
        split = (llama.split_blocks_interleaved(params, S, V) if V > 1
                 else llama.split_blocks_for_stages(params, S))
        want = (jllama.split_blocks_interleaved(params, S, V) if V > 1
                else jllama.split_blocks_for_stages(params, S))
        for (pa, a), (pb, b) in zip(flatten(split), flatten(jax.tree.map(np.asarray, want))):
            assert pa == pb and np.array_equal(a, b)
        stages = [llama.load_stage_params(
            llama.LlamaChunkedStage(cfg, s, S, V, device="cpu", generator=torch.Generator())
            if V > 1 else llama.LlamaStage(cfg, s, S, device="cpu", generator=torch.Generator()),
            split) for s in range(S)]
        merged = llama.merge_stage_exports([llama.export_params(st) for st in stages],
                                           num_chunks=V)
        assert [p for p, _ in flatten(merged)] == [p for p, _ in flatten(params)]
        for (path, a), (_, b) in zip(flatten(merged), flatten(params)):
            assert np.array_equal(a, b), path
        back = (llama.merge_blocks_interleaved(split) if V > 1
                else llama.merge_blocks_from_stages(split))
        for (_, a), (_, b) in zip(flatten(back), flatten(params)):
            assert np.array_equal(a, b)
