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
    cfg = config.LlamaConfig(**SMALL)
    a = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    b = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert abs(a.embed.std().item() - 0.02) < 2e-3
    assert torch.equal(a.blocks[0].ln1, torch.ones(64))
    with pytest.raises(NotImplementedError, match="MoE"):
        llama.Llama(config.replace(cfg, n_experts=4), device="cpu",
                    generator=torch.Generator())
