"""The port's training slice against the JAX package's, on the CPU: the Adam
train step, the TinyStories stream, the tokenizer resolution and the primer.

Tolerances: losses rtol 1e-5 and parameters atol 5e-5 after 3 float32 Adam
steps (optax's ``adam`` and torch's ``Adam`` apply the same bias-corrected
update with eps outside the square root; only rounding differs).
"""

import jax
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.data import tinystories as jtinystories  # noqa: E402
from ddl25spring_tpu.data import tokenizer as jtokenizer  # noqa: E402
from ddl25spring_tpu.models import llama as jllama  # noqa: E402
from ddl25spring_tpu.ops.losses import causal_lm_loss as j_causal_lm_loss  # noqa: E402
from ddl25spring_tpu.parallel import dp as jdp  # noqa: E402
from ddl25spring_tpu.utils import config as jconfig  # noqa: E402
from ddl25spring_tpu_torch import primer  # noqa: E402
from ddl25spring_tpu_torch.data import tinystories, tokenizer  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import causal_lm_loss  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402
from ddl25spring_tpu_torch.utils.device import resolve_device  # noqa: E402

SMALL = dict(vocab_size=96, dmodel=64, num_heads=2, n_layers=2, ctx_size=32,
             dtype="float32")
LR = 8e-4


def test_three_adam_steps_match_jax():
    jcfg = jconfig.LlamaConfig(**SMALL)
    params = jllama.init_llama_params(jax.random.PRNGKey(0), jcfg)
    batches = [np.random.default_rng(s).integers(0, 96, (3, 32)).astype(np.int32)
               for s in range(3)]

    model = llama.load_jax_params(
        llama.Llama(config.LlamaConfig(**SMALL), device="cpu",
                    generator=torch.Generator().manual_seed(0)),
        jax.tree.map(np.asarray, params))
    step = make_train_step(
        model, lambda m, tokens: causal_lm_loss(m(tokens), tokens),
        torch.optim.Adam(model.parameters(), lr=LR))
    got_losses = [step(torch.from_numpy(b).long()).item() for b in batches]

    tx = optax.adam(LR)
    jstep = jdp.make_train_step(
        lambda p, tokens, key: j_causal_lm_loss(
            jllama.llama_forward(p, tokens, jcfg), tokens),
        tx, donate=False, sentinel=False)
    opt_state, want_losses = tx.init(params), []
    for b in batches:
        params, opt_state, loss = jstep(params, opt_state, b, jax.random.PRNGKey(0))
        want_losses.append(float(loss))

    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got = llama.export_params(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5)


@pytest.mark.parametrize("skip", [0, 7])
def test_tinystories_batches_are_byte_identical(skip):
    kw = dict(batch_size=3, seq_l=64, skip=skip, seed=1, min_chars=20_000)
    want = iter(jtinystories.TinyStories(jtokenizer.ByteTokenizer(), **kw))
    got = iter(tinystories.TinyStories(tokenizer.ByteTokenizer(), **kw))
    for _ in range(40):  # past the wrap-around of the stream
        a, b = next(got), next(want)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tokenizer_resolution(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no data/bpe.json here
    monkeypatch.delenv("DDL25_SP_MODEL", raising=False)
    monkeypatch.delenv("DDL25_BPE_MODEL", raising=False)
    tok = tokenizer.get_tokenizer()
    assert isinstance(tok, tokenizer.ByteTokenizer)
    ref = jtokenizer.ByteTokenizer()
    text = "Lily found a shiny box. é"
    assert tok.encode(text) == ref.encode(text)
    assert tok.decode(tok.encode(text)) == text
    (tmp_path / "sp.model").write_bytes(b"")
    for path in ("x.json", "x.model"):
        with pytest.raises(NotImplementedError, match="later slice"):
            tokenizer.get_tokenizer(path)
    monkeypatch.setenv("DDL25_SP_MODEL", str(tmp_path / "sp.model"))
    with pytest.raises(NotImplementedError, match="SentencePiece"):
        tokenizer.get_tokenizer()
    monkeypatch.setenv("DDL25_SP_MODEL", str(tmp_path / "missing.model"))
    monkeypatch.setenv("DDL25_BPE_MODEL", str(tmp_path / "sp.model"))
    with pytest.raises(NotImplementedError, match="BPE"):
        tokenizer.get_tokenizer()


def test_resolve_device_never_falls_back_to_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)


@pytest.mark.parametrize("flags", [[], ["--no-flash"]], ids=["flash", "dense"])
def test_primer_trains_on_cpu(capsys, flags):
    out = primer.main(["--device", "cpu", "--iters", "2", "--seq-len", "64", *flags])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert abs(out["losses"][0] - np.log(4096)) < 1.0  # random init: ~uniform
    assert "iter   1  loss" in capsys.readouterr().out
