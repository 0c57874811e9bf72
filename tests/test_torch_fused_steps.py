"""K train steps per dispatch (``parallel/pipeline.fuse_train_steps``) on the
CPU, where a fused window is a loop of the step: fused equals sequential
bitwise for ``make_train_step`` and ``make_grad_accum_step``; the port's
fused K = 3 against the JAX ``fuse_train_steps(step, 3)`` on the same
weights and tokens, with the tolerances of ``tests/test_pipeline.py::
test_fused_steps_equal_sequential`` (losses rtol 1e-5, parameters atol 1e-5
and rtol 1e-4; SGD 0.05 as there); the window-size check; the refusal of
steps whose transport cannot be graphed (a fake CUDA ``Comm``: the check
runs before anything touches a card); and ``lab.dp_pp --workload llama
--scan-steps 2`` on the CPU against the unfused run.  The graph itself runs
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.lab import dp_pp  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step  # noqa: E402
from ddl25spring_tpu_torch.parallel.pipeline import (  # noqa: E402
    fuse_train_steps,
    graph_refusal,
    make_grad_accum_step,
)
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.prng import seeded_generator  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16, dtype="float32")
K = 3
WINDOW = np.random.default_rng(7).integers(0, 64, (K, 4, 16)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host."""
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
        jax.random.PRNGKey(5), jconfig.LlamaConfig(**TINY)))


def _lm_loss(m, tokens, *gen):
    return causal_lm_loss(m(tokens), tokens)


def _build(params, kind, lr=8e-4):
    """A model from ``params``, its Adam (SGD for ``"sgd"``) and its step."""
    model = llama.load_jax_params(
        llama.Llama(config.LlamaConfig(**TINY), device="cpu",
                    generator=torch.Generator().manual_seed(0)), params)
    if kind == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=lr)
    else:
        opt = torch.optim.Adam(model.parameters(), lr=lr)
    if kind == "grad_accum":
        accum = make_grad_accum_step(model, _lm_loss, opt, 2)
        gens = [seeded_generator(0, 0, m) for m in range(2)]
        return model, opt, lambda tokens: accum(tokens, gens)
    return model, opt, make_train_step(model, _lm_loss, opt)


@pytest.mark.parametrize("kind", ["train_step", "grad_accum"])
def test_fused_equals_sequential_bitwise(params, kind):
    window = torch.from_numpy(WINDOW).long()
    model, _, step = _build(params, kind)
    seq = torch.stack([step(window[i]) for i in range(K)])
    fmodel, fopt, fstep = _build(params, kind)
    fused = fuse_train_steps(fstep, K, module=fmodel, optimizer=fopt, device="cpu")(window)
    assert fused.shape == (K,) and torch.equal(fused, seq)
    for a, b in zip(model.parameters(), fmodel.parameters()):
        assert torch.equal(a, b)


def test_fused_matches_the_jax_fuse_train_steps(params):
    import jax
    import optax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.ops.losses import causal_lm_loss as j_causal_lm_loss
    from ddl25spring_tpu.parallel import dp as jdp
    from ddl25spring_tpu.parallel.pipeline import fuse_train_steps as j_fuse_train_steps
    from ddl25spring_tpu.utils import config as jconfig

    jcfg = jconfig.LlamaConfig(**TINY)
    tx = optax.sgd(0.05)
    jstep = jdp.make_train_step(
        lambda p, tokens, key: j_causal_lm_loss(jllama.llama_forward(p, tokens, jcfg), tokens),
        tx, donate=False, sentinel=False)
    key = jax.random.PRNGKey(0)
    jmulti = j_fuse_train_steps(lambda p, o, t: jstep(p, o, t, key), K, donate=False)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    want_params, _, want = jmulti(jparams, tx.init(jparams), WINDOW)

    model, opt, step = _build(params, "sgd", lr=0.05)
    got = fuse_train_steps(step, K, module=model, optimizer=opt, device="cpu")(
        torch.from_numpy(WINDOW).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(llama.export_params(model)), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


def test_a_window_of_another_size_raises(params):
    model, opt, step = _build(params, "train_step")
    multi = fuse_train_steps(step, K, module=model, optimizer=opt, device="cpu")
    with pytest.raises(ValueError, match="fused for 3 steps but got a window of 2"):
        multi(torch.from_numpy(WINDOW[:2]).long())
    with pytest.raises(ValueError, match="different sizes"):
        multi({"a": torch.zeros(3, 2), "b": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="k >= 1"):
        fuse_train_steps(step, 0, module=model, optimizer=opt, device="cpu")


def test_steps_whose_transport_cannot_be_graphed_raise(params):
    """A CUDA ``Comm`` built without a card: gloo stages a card's tensors
    through pinned host buffers, which a CUDA graph cannot hold; a step over
    NCCL waits for the multi-card items.  A process alone, or the CPU, is
    not refused."""
    model, opt, step = _build(params, "train_step")
    cuda = torch.device("cuda")
    staged = Comm("gloo", cuda)
    assert staged.staged
    with pytest.raises(ValueError, match="host copy"):
        fuse_train_steps(step, K, module=model, optimizer=opt, device=cuda, comm=staged)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        fuse_train_steps(step, K, module=model, optimizer=opt, device=cuda,
                         comm=Comm("nccl", cuda))
    assert graph_refusal(cuda) is None
    assert graph_refusal("cpu", Comm("gloo", torch.device("cpu"))) is None


def test_lab_fuses_llama_steps_as_a_loop_on_the_cpu(capsys):
    argv = ["--workload", "llama", "--device", "cpu", "--iters", "2", "--seq-len", "16",
            "--timeout", "120"]
    fused = dp_pp.main([*argv, "--scan-steps", "2"])
    assert "2 step(s) per dispatch" in capsys.readouterr().out  # the header
    plain = dp_pp.main(argv)
    assert len(fused["losses"]) == 2 and fused["losses"] == plain["losses"]
