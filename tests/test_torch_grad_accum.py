"""The port's single-process microbatch gradient accumulation
(``parallel/pipeline.make_grad_accum_step``) on the CPU: the tiny LLaMA's
accumulated SGD step (M = 3) against one full-batch step of the port
(within 1e-6, by linearity) and against the JAX package's
``make_grad_accum_step`` (within 1e-5, as ``tests/test_pipeline.py::
test_grad_accum_equals_full_batch``); each microbatch gets its own
generator, drawn per ``(seed, step, m)``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import make_grad_accum_step  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.prng import seeded_generator  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16, dtype="float32")
M, LR = 3, 0.1
TOKENS = np.random.default_rng(40).integers(0, 64, (6, 16)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's CPU kernels would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.utils import config as jconfig

    return jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jconfig.LlamaConfig(**TINY)))


def _model(params):
    return llama.load_jax_params(
        llama.Llama(config.LlamaConfig(**TINY), device="cpu",
                    generator=torch.Generator().manual_seed(0)), params)


def _accumulated(params, seen=None):
    model = _model(params)

    def loss_fn(m, tokens, gen):
        if seen is not None:
            seen.append((tokens.shape[0], gen))
        return causal_lm_loss(m(tokens), tokens)

    step = make_grad_accum_step(model, loss_fn, torch.optim.SGD(model.parameters(), lr=LR), M)
    gens = [seeded_generator(7, 0, m) for m in range(M)]
    loss = step(torch.from_numpy(TOKENS).long(), gens)
    return float(loss), llama.export_params(model), gens


def _close(got, want, **tol):
    for (pa, a), (pb, b) in zip(flatten(got), flatten(want)):
        assert pa == pb
        np.testing.assert_allclose(a, np.asarray(b), err_msg=pa, **tol)


def test_accumulated_step_equals_full_batch(params):
    seen = []
    loss, got, gens = _accumulated(params, seen)
    assert [n for n, _ in seen] == [2, 2, 2]
    assert [g for _, g in seen] == gens  # generator m goes with microbatch m
    model = _model(params)
    step = make_train_step(model, lambda m, t: causal_lm_loss(m(t), t),
                           torch.optim.SGD(model.parameters(), lr=LR))
    want_loss = float(step(torch.from_numpy(TOKENS).long()))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    _close(got, llama.export_params(model), atol=1e-6, rtol=0)


def test_accumulated_step_matches_jax(params):
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss as jloss
    from ddl25spring_tpu.parallel.pipeline import make_grad_accum_step as jaccum
    from ddl25spring_tpu.utils import config as jconfig

    jcfg = jconfig.LlamaConfig(**TINY)
    tx = optax.sgd(LR)
    step = jaccum(lambda p, b, key: jloss(jllama.llama_forward(p, b, jcfg), b), tx, M,
                  donate=False)
    p, _, loss = step(params, tx.init(params), TOKENS, jax.random.PRNGKey(2))
    got_loss, got, _ = _accumulated(params)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    _close(got, jax.tree.map(np.asarray, p), atol=1e-5, rtol=1e-4)


def test_accumulation_guards(params):
    model = _model(params)
    step = make_grad_accum_step(model, lambda m, t, g: causal_lm_loss(m(t), t),
                                torch.optim.SGD(model.parameters(), lr=LR), 4)
    with pytest.raises(ValueError, match="not divisible by 4"):
        step(torch.from_numpy(TOKENS).long(), [None] * 4)
    with pytest.raises(ValueError, match="3 generators for 4"):
        step(torch.from_numpy(TOKENS[:4]).long(), [None] * 3)
