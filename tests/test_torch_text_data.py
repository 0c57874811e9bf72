"""The port's tokenizers, held against the JAX package's on the same seeded
text: twins of ``tests/test_text_data.py`` (byte, SentencePiece through the
pure-Python processor on ``data/tinystories.model``, the trained BPE, native
against Python, ``get_tokenizer``'s four branches), the LLaMA labs sized by
their tokenizer as the JAX labs are, and the twin of
``examples/golden_tables.py``."""

import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.data import tokenizer as jtok  # noqa: E402
from ddl25spring_tpu.data.tinystories import TinyStories as JaxTinyStories  # noqa: E402
from ddl25spring_tpu_torch.data import sp_model  # noqa: E402
from ddl25spring_tpu_torch.data import tokenizer as ttok  # noqa: E402
from ddl25spring_tpu_torch.data.tinystories import TinyStories, generate_story  # noqa: E402

SP_MODEL = "data/tinystories.model"
CASES = [
    "", "   ", "a", " a", "a ", "trailing ws   ", "\n\nleading",
    "One day Tom went to the park. The cat found a red ball.",
    "Tabs\tand  spaces Ünïcòde \n newlines",
    "nbsp\xa0thin ideo　sep done",
    "café naïve 你好世界",
]


def _corpus(n_stories=400, seed=7):
    rng = np.random.default_rng(seed)
    return " ".join(generate_story(rng) for _ in range(n_stories))


@pytest.fixture(scope="module")
def bpe_pair():
    """The same corpus trained into a BPE by each package."""
    corpus = _corpus()
    return ttok.BpeTokenizer.train(corpus, 128), jtok.BpeTokenizer.train(corpus, 128)


@pytest.fixture(scope="module")
def sp_pair():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ttok.SentencePieceTokenizer(SP_MODEL), jtok.SentencePieceTokenizer(SP_MODEL)


def test_byte_tokenizer_roundtrip():
    tok, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    text = "One day Tom went to the park. Ünïcòde too."
    ids = tok.encode(text)
    assert ids == ref.encode(text) and ids[0] == tok.bos_id
    assert max(ids) < tok.vocab_size == ref.vocab_size
    assert tok.decode(ids) == text


def test_bpe_trains_compresses_roundtrips(tmp_path, bpe_pair):
    """The same merges from the same corpus; the same ids; a shorter encoding
    than bytes; artifacts written by either package load in the other."""
    tok, ref = bpe_pair
    assert tok.merges == [tuple(m) for m in ref.merges] and len(tok.merges) > 50
    assert tok.vocab_size == ref.vocab_size == 259 + len(tok.merges)
    text = "One day Tom went to the park. The cat found a red ball."
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert len(ids) < 0.7 * len(ttok.ByteTokenizer().encode(text))
    assert tok.decode(ids) == text == ref.decode(ids)
    weird = "Tabs\tand  spaces Ünïcòde \n newlines"
    assert tok.decode(tok.encode(weird)) == weird
    tok.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "jax.json"))
    assert jtok.BpeTokenizer.load(str(tmp_path / "port.json")).encode(text) == ids
    assert ttok.BpeTokenizer.load(str(tmp_path / "jax.json")).encode(text) == ids


def test_native_bpe_encode_matches_python(bpe_pair):
    """The C++ loop of ``native/bpe.cc`` equals the Python loop and JAX's
    encoder on every case, with and without bos; ``native`` says which runs."""
    tok, ref = bpe_pair
    if not tok.native:
        pytest.skip("native BPE lib unavailable (no toolchain)")
    py = ttok.BpeTokenizer(tok.merges, native=False)
    assert not py.native
    for text in CASES:
        for bos in (True, False):
            assert tok.encode(text, add_bos=bos) == py.encode(text, add_bos=bos) == \
                ref.encode(text, add_bos=bos), repr(text)
        assert tok.decode(tok.encode(text)) == text


def test_bpe_pickles_with_its_native_handle(bpe_pair):
    """A BPE crosses into a spawned rank by pickle: it rebuilds its handle."""
    import pickle

    tok, _ = bpe_pair
    back = pickle.loads(pickle.dumps(tok))
    assert back.merges == tok.merges and back.native == tok.native
    assert back.encode(CASES[7]) == tok.encode(CASES[7])


def test_sp_ids_and_decode_equal_jax_on_the_model(sp_pair):
    """``data/tinystories.model`` through both pure-Python processors: the
    same vocabulary, special ids, ids and decodes on seeded stories."""
    tok, ref = sp_pair
    assert (tok.vocab_size, tok.pad_id, tok.bos_id, tok.eos_id) == \
        (ref.vocab_size, ref.pad_id, ref.bos_id, ref.eos_id)
    assert tok.vocab_size == 512
    rng = np.random.default_rng(3)
    for text in [generate_story(rng) for _ in range(20)] + CASES[7:9]:
        ids = tok.encode(text, add_bos=True)
        assert ids == ref.encode(text, add_bos=True)
        assert tok.decode(ids[1:]) == ref.decode(ids[1:])
    text = "One day Zoe went to the school. The mouse came to play."
    body = tok.encode(text, add_bos=True)[1:]
    assert len(body) < len(text.encode()) // 2 and tok.decode(body) == text


def test_sp_model_wire_roundtrip_across_packages(tmp_path):
    """The port's protobuf writer and reader are the inverses of JAX's."""
    from ddl25spring_tpu.data import sp_model as jsp

    pieces = [("<pad>", 0.0, sp_model.CONTROL), ("<s>", 0.0, sp_model.CONTROL),
              ("</s>", 0.0, sp_model.CONTROL), ("<unk>", 0.0, sp_model.UNKNOWN),
              ("▁the", -1.5, sp_model.NORMAL), ("▁", -2.25, sp_model.NORMAL),
              ("e", -3.0, sp_model.NORMAL)]
    sp_model.write_sp_model(pieces, tmp_path / "port.model")
    jsp.write_sp_model(pieces, tmp_path / "jax.model")
    assert (tmp_path / "port.model").read_bytes() == (tmp_path / "jax.model").read_bytes()
    got = sp_model.read_sp_model(tmp_path / "jax.model")
    assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in pieces]
    assert all(abs(s1 - s2) < 1e-6 for (_, s1, _), (_, s2, _) in zip(pieces, got))


def test_sp_viterbi_prefers_trained_pieces_and_handles_unknowns(tmp_path):
    pieces = [("<pad>", 0.0, sp_model.CONTROL), ("<s>", 0.0, sp_model.CONTROL),
              ("</s>", 0.0, sp_model.CONTROL), ("<unk>", 0.0, sp_model.UNKNOWN),
              ("▁ab", -1.0, sp_model.NORMAL), ("▁a", -2.0, sp_model.NORMAL),
              ("b", -2.0, sp_model.NORMAL), ("▁", -3.0, sp_model.NORMAL),
              ("a", -3.0, sp_model.NORMAL)]
    p = tmp_path / "m.model"
    sp_model.write_sp_model(pieces, p)
    sp = sp_model.PySentencePieceProcessor(p)
    assert sp.encode("ab") == [4]
    ids = sp.encode("aXb")
    assert sp._unk in ids and ids[0] == 5
    assert sp.decode(ids) == "a ⁇ b"


def test_sp_tokenizer_warns_once_on_pure_python_fallback():
    with contextlib.suppress(ImportError):
        import sentencepiece  # noqa: F401

        pytest.skip("real sentencepiece installed; no fallback to warn on")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ttok.SentencePieceTokenizer(SP_MODEL)
    msgs = [str(w.message) for w in caught]
    assert any("PySentencePieceProcessor" in m and "approximate" in m.lower() for m in msgs)


@pytest.mark.parametrize("branch", ["explicit-json", "explicit-model", "sp-env", "bpe-env",
                                    "bytes"])
def test_get_tokenizer_resolves_the_jax_branches(tmp_path, monkeypatch, bpe_pair, branch):
    """``get_tokenizer`` takes the JAX function's branch, in its order, and
    raises nowhere: the same tokenizer kind, vocabulary and ids."""
    tok, _ = bpe_pair
    path = tmp_path / "bpe.json"
    tok.save(str(path))
    monkeypatch.delenv("DDL25_SP_MODEL", raising=False)
    monkeypatch.delenv("DDL25_BPE_MODEL", raising=False)
    arg = None
    if branch == "explicit-json":
        arg = str(path)
    elif branch == "explicit-model":
        arg = SP_MODEL
    elif branch == "sp-env":
        monkeypatch.setenv("DDL25_SP_MODEL", SP_MODEL)
        monkeypatch.setenv("DDL25_BPE_MODEL", str(path))  # SentencePiece wins
    elif branch == "bpe-env":
        monkeypatch.setenv("DDL25_BPE_MODEL", str(path))
    else:
        monkeypatch.setenv("DDL25_BPE_MODEL", "")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, ref = ttok.get_tokenizer(arg), jtok.get_tokenizer(arg)
    assert type(got).__name__ == type(ref).__name__
    assert got.vocab_size == ref.vocab_size
    assert got.encode(CASES[7]) == ref.encode(CASES[7])


def test_bpe_feeds_tinystories_and_trainstep(bpe_pair):
    """The stream under the trained BPE equals JAX's batch for batch, and
    one tiny LLaMA sized by the tokenizer trains on it: losses finite and
    falling over a few Adam steps."""
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.ops.losses import causal_lm_loss
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    tok, ref = bpe_pair
    ds = iter(TinyStories(tok, batch_size=4, seq_l=32, min_chars=50_000))
    jds = iter(JaxTinyStories(ref, batch_size=4, seq_l=32, min_chars=50_000))
    batches = [next(ds) for _ in range(6)]
    for b in batches[:2]:
        np.testing.assert_array_equal(b, next(jds))
    assert max(int(b.max()) for b in batches) < tok.vocab_size
    cfg = LlamaConfig(vocab_size=tok.vocab_size, dmodel=32, num_heads=2, n_layers=2,
                      ctx_size=32, dtype="float32")
    model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []
    for b in batches:
        t = torch.from_numpy(np.asarray(b)).long()
        opt.zero_grad()
        loss = causal_lm_loss(llama.llama_forward(model, t, cfg), t)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("sp_env", [None, SP_MODEL], ids=["bytes", "sentencepiece"])
@pytest.mark.parametrize("lab", ["s01_b2_dp_pp", "s01_b1_microbatches"])
def test_llama_labs_size_the_vocabulary_by_the_tokenizer(monkeypatch, lab, sp_env):
    """The port's LLaMA labs build the JAX labs' config: ``vocab_size`` is
    the tokenizer's (``lab/s01_b2_dp_pp.py:117-121``,
    ``lab/s01_b1_microbatches.py:94-100``), 259 under bytes and 512 under
    ``DDL25_SP_MODEL=data/tinystories.model``; the ranks get that tokenizer."""
    from ddl25spring_tpu_torch.lab import dp_pp, microbatches

    monkeypatch.delenv("DDL25_BPE_MODEL", raising=False)
    if sp_env:
        monkeypatch.setenv("DDL25_SP_MODEL", sp_env)
    else:
        monkeypatch.delenv("DDL25_SP_MODEL", raising=False)
    got = {}
    monkeypatch.setattr(dp_pp, "spawn", lambda fn, world, job, timeout: got.update(job=job)
                        or [None] * world)
    run = dp_pp.main if lab == "s01_b2_dp_pp" else microbatches.main
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run(["--workload", "llama", "--device", "cpu"] if lab == "s01_b2_dp_pp"
            else ["--device", "cpu"])
        want = jtok.get_tokenizer().vocab_size
    job = got["job"]
    assert job.cfg.vocab_size == want == (512 if sp_env else 259)
    assert job.tokenizer.vocab_size == want


def test_tutorial_dp_ga_sizes_the_vocabulary_by_the_tokenizer(monkeypatch):
    """``examples/tutorial_1b/intro_dp_ga.py:51-53``: the embedding has the
    tokenizer's rows, and the stream never indexes past them."""
    from ddl25spring_tpu_torch.examples.tutorial_1b import intro_dp_ga

    monkeypatch.delenv("DDL25_SP_MODEL", raising=False)
    monkeypatch.delenv("DDL25_BPE_MODEL", raising=False)
    run = intro_dp_ga.main(["--device", "cpu", "--iters", "1", "--seq-len", "16"])
    assert len(run["losses"]) == 1 and np.isfinite(run["losses"]).all()
    assert run["ranks"][0]["vocab_size"] == 259


def test_golden_tables_say_what_they_stand_on(monkeypatch, capsys, tmp_path):
    """The twin of ``examples/golden_tables.py``: the same golden values, a
    header naming the synthetic stand-in when ``DDL25_MNIST_DIR`` finds no
    IDX files, and one row per server beside its golden value (the servers
    stubbed: the table's layout, not FL, is under test here)."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    from ddl25spring_tpu_torch.examples import golden_tables as gt

    path = Path(__file__).resolve().parents[1] / "examples" / "golden_tables.py"
    spec = importlib.util.spec_from_file_location("jax_golden_tables", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert gt.GOLDEN == ref.GOLDEN
    monkeypatch.setenv("DDL25_MNIST_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    seen = []

    class Fake:
        def __init__(self, **kw):
            seen.append(kw)

        def run(self, rounds):
            return SimpleNamespace(test_accuracy=[0.5] * rounds)

    monkeypatch.setattr(gt, "FedAvgServer", type("FakeAvg", (Fake,), {}))
    monkeypatch.setattr(gt, "FedSgdGradientServer", type("FakeSgd", (Fake,), {}))
    rows = gt.main(["--quick", "--device", "cpu", "--rounds", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# data: SYNTHETIC stand-in") and "DDL25_MNIST_DIR" in out[0]
    assert [(r["server"], r["N"], r["C"], r["golden"]) for r in rows] == \
        [("FedAvg", 10, 0.1, 0.932), ("FedSGD", 10, 0.1, 0.4287)]
    assert any(line.split()[:5] == ["FedAvg", "10", "0.1", "0.5000", "0.9320"] for line in out)
    assert [kw["batch_size"] for kw in seen] == [100, -1]
    assert all(kw["device"] == "cpu" and kw["seed"] == 10 for kw in seen)
