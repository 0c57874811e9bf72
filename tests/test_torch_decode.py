"""The port's KV-cache decode (``models/decode.py``) against its own full
forward and against the JAX package's ``models/decode.py``, on the CPU.

The weights are a seeded draw of the port's ``Llama`` exported as the JAX
pytree (``llama.export_params``); prompts come from a seeded numpy
generator.  Tolerances: fp32 logits within 1e-5 of JAX's; tokens exact.
Every cross-package token comparison first asserts that the top-2 logit
margin at each generated position exceeds ``MARGIN`` (10x the logit band),
so a flipped argmax shows as a defect, not as noise.  Sampled tokens come
from another generator than ``jax.random`` (a kept divergence): the
samplers are held to JAX by their filtered logits and by support.

TP generation (``make_tp_generate``) runs in one spawned gloo world of 2
ranks (its rank function lives in ``test_torch_serve_tp.py``, which imports
no jax at the top, so the ranks start fast): greedy tokens against JAX's
``make_tp_generate`` on 2 CPU devices, the MoE sampled chain against the
port's single-process ``generate`` with a generator seeded alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.models import decode as jdecode  # noqa: E402
from ddl25spring_tpu.models import llama as jllama  # noqa: E402
from ddl25spring_tpu.utils import config as jconfig  # noqa: E402
from ddl25spring_tpu_torch.models import decode as dm  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Axis  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid  # noqa: E402

SIZES = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=32,
             dtype="float32")
CFG = LlamaConfig(**SIZES)
BAND = 1e-5     # fp32 logits, port against JAX
MARGIN = 1e-4   # the top-2 gap every compared greedy token must clear


def _model(cfg, seed=0):
    m = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return m.requires_grad_(False)


def _jax_params(model):
    return jax.tree.map(jnp.asarray, llama.export_params(model))


@pytest.fixture(scope="module")
def setup():
    model = _model(CFG)
    prompt = np.random.default_rng(1).integers(1, 64, size=(2, 5)).astype(np.int32)
    return model, _jax_params(model), prompt


def _teacher_forced(model, prompt, cfg, n, with_aux=False):
    """argmax of the FULL forward over the growing sequence, and the top-2
    margin at each step."""
    seq = torch.from_numpy(prompt).long()
    out, gaps = [], []
    for _ in range(n):
        if with_aux:
            logits, _ = llama.llama_forward_with_aux(model, seq, cfg)
        else:
            logits = llama.llama_forward(model, seq, cfg)
        top2 = logits[:, -1].topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        nxt = logits[:, -1].argmax(-1)
        out.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).numpy(), gaps


def test_greedy_generate_equals_full_forward_and_jax(setup):
    model, jparams, prompt = setup
    n = 8
    got = dm.generate(model, torch.from_numpy(prompt), CFG, n).numpy()
    want, gaps = _teacher_forced(model, prompt, CFG, n)
    np.testing.assert_array_equal(got, want)
    assert min(gaps) > MARGIN, gaps
    jcfg = jconfig.LlamaConfig(**SIZES)
    ref = np.asarray(jax.jit(lambda p, t: jdecode.generate(p, t, jcfg, n))(
        jparams, jnp.asarray(prompt)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("top_k", [1, 2])
def test_greedy_generate_moe(top_k):
    """MoE blocks decode at ample capacity: the per-token routing (top-1 and
    top-2) equals the trained forward's, so the oracle holds exactly."""
    sizes = dict(SIZES, n_experts=4, capacity_factor=4.0, moe_top_k=top_k)
    cfg = LlamaConfig(**sizes)
    model = _model(cfg, seed=2)
    prompt = np.random.default_rng(3).integers(1, 64, size=(2, 4)).astype(np.int32)
    n = 6
    got = dm.generate(model, torch.from_numpy(prompt), cfg, n).numpy()
    want, gaps = _teacher_forced(model, prompt, cfg, n, with_aux=True)
    np.testing.assert_array_equal(got, want)
    if top_k == 2:  # one JAX MoE decode: its scan compiles in ~2 s
        assert min(gaps) > MARGIN, gaps
        ref = np.asarray(jdecode.generate(_jax_params(model), jnp.asarray(prompt),
                                          jconfig.LlamaConfig(**sizes), n))
        np.testing.assert_array_equal(got, ref)


def test_decode_step_matches_forward_slice_and_jax(setup):
    """One incremental step after a prefilled cache == the last-position
    logits of the full forward (the JAX test's 1e-4), and JAX's full forward
    within BAND."""
    model, jparams, prompt = setup
    B, P = prompt.shape
    cache = dm.init_kv_cache(CFG, B, P + 1)
    for i in range(P):
        logits, cache = dm.decode_step(model, cache, torch.from_numpy(prompt[:, i]), i, CFG)
    full = llama.llama_forward(model, torch.from_numpy(prompt).long(), CFG)[:, -1]
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=1e-4, rtol=1e-4)
    ref = jllama.llama_forward(jparams, jnp.asarray(prompt), jconfig.LlamaConfig(**SIZES))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref[:, -1]), atol=BAND)


def test_kv_cache_refusals():
    with pytest.raises(ValueError, match="num_heads=0"):
        dm.init_kv_cache(CFG, batch=1, max_len=8, num_heads=0)
    k, v = dm.init_kv_cache(CFG, batch=1, max_len=8, num_heads=1)
    assert k.shape == (CFG.n_layers, 1, 8, 1, CFG.head_dim)
    with pytest.raises(ValueError, match="max_len=4"):
        dm.generate(_model(CFG), torch.ones((1, 3), dtype=torch.int32), CFG, 2, max_len=4)
    # TP generation: a head count the model axis does not divide, and a
    # vocab sharded over no axis, are refused; over an axis of one rank (no
    # collective runs) both layouts give the single-process tokens
    mesh4 = Mesh(RankGrid(1, 4, "model"), 0, torch.device("cpu"), "gloo", None,
                 {"data": None, "model": None})
    with pytest.raises(ValueError, match="not divisible"):
        dm.make_tp_generate(CFG, mesh4, 4)
    prompt = torch.ones((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shard_vocab"):
        dm.generate(_model(CFG), prompt, CFG, 2, shard_vocab=True)
    one = Axis("model", None, None, (0,), 0)
    want = dm.generate(_model(CFG), prompt, CFG, 3)
    for sv in (False, True):
        got = dm.generate(_model(CFG), prompt, CFG, 3, tp_axis=one, shard_vocab=sv)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_temperature_sampling_deterministic_and_in_range(setup):
    model, _, prompt = setup
    p = torch.from_numpy(prompt)

    def draw(seed):
        return dm.generate(model, p, CFG, 6, temperature=0.8,
                           key=torch.Generator().manual_seed(seed)).numpy()

    a, b, c = draw(7), draw(7), draw(8)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 6) and a.min() >= 0 and a.max() < CFG.vocab_size
    assert not np.array_equal(a, c)  # another seed, another sample
    out = dm.generate(model, p, CFG, 5, temperature=0.9, top_k=8, top_p=0.9,
                      key=torch.Generator().manual_seed(3)).numpy()
    assert out.shape == (2, 5) and out.min() >= 0 and out.max() < CFG.vocab_size


def test_top_k_mask_equals_jax_and_restricts_support():
    """The top-k filter keeps exactly ``lax.top_k``'s set; every sample of
    both packages lands in it; k=1 is greedy whatever the draw."""
    logits = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 32)))
    keep = np.isfinite(dm.filter_logits(torch.from_numpy(logits), 1.0, top_k=5).numpy())
    topk_sets = np.asarray(jax.lax.top_k(jnp.asarray(logits), 5)[1])
    for b in range(4):
        assert set(np.nonzero(keep[b])[0]) == set(topk_sets[b].tolist())
    for seed in range(20):
        tok = dm.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(seed),
                               temperature=1.0, top_k=5).numpy()
        assert keep[np.arange(4), tok].all()
    for seed in range(5):
        jtok = np.asarray(jdecode.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                                temperature=1.0, top_k=5))
        assert keep[np.arange(4), jtok].all()
    greedy = logits.argmax(-1)
    for seed in range(5):
        np.testing.assert_array_equal(
            dm.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(seed),
                             temperature=1.0, top_k=1).numpy(), greedy)


def test_top_p_mask_equals_the_nucleus_and_jax_samples_lie_in_it():
    """The nucleus filter keeps exactly the smallest prefix of the sorted
    vocab reaching mass p (the JAX test's numpy reconstruction); JAX's and
    the port's samples lie in it; p -> 0 and p = 0 are greedy."""
    logits = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 16)) * 3.0)
    p = 0.7
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    order = np.argsort(-probs, axis=-1)
    keep = np.isfinite(dm.filter_logits(torch.from_numpy(logits), 1.0, top_p=p).numpy())
    for b in range(3):
        mass, nucleus = 0.0, set()
        for idx in order[b]:
            nucleus.add(int(idx))
            mass += probs[b, idx]
            if mass >= p:
                break
        assert set(np.nonzero(keep[b])[0]) == nucleus
    for seed in range(30):
        tok = dm.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(seed),
                               temperature=1.0, top_p=p).numpy()
        assert keep[np.arange(3), tok].all()
    for seed in range(5):
        jtok = np.asarray(jdecode.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                                temperature=1.0, top_p=p))
        assert keep[np.arange(3), jtok].all()
    greedy = logits.argmax(-1)
    for p_edge in (1e-6, 0.0):
        for seed in range(5):
            np.testing.assert_array_equal(
                dm.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(seed),
                                 temperature=1.0, top_p=p_edge).numpy(), greedy)


def test_combined_filter_equals_the_jax_filters_composed():
    """k then p, at a temperature: the kept set equals the nucleus of the
    top-k survivors (JAX's composition, rebuilt from ``lax.top_k`` and the
    softmax of the scaled survivors)."""
    logits = np.array(jax.random.normal(jax.random.PRNGKey(2), (5, 40)) * 2.0)
    t, k, p = 0.7, 10, 0.8
    keep = np.isfinite(dm.filter_logits(torch.from_numpy(logits), t, top_k=k,
                                        top_p=p).numpy())
    scaled = logits.astype(np.float32) / np.float32(t)
    top = np.asarray(jax.lax.top_k(jnp.asarray(scaled), k)[1])
    for b in range(5):
        probs = np.asarray(jax.nn.softmax(jnp.asarray(scaled[b, top[b]])))
        mass, nucleus = 0.0, set()
        for j in np.argsort(-probs):
            nucleus.add(int(top[b, j]))
            mass += probs[j]
            if mass >= p:
                break
        assert set(np.nonzero(keep[b])[0]) == nucleus


# ------------------------------------------------------------ TP generation

TP_SIZES = dict(vocab_size=64, dmodel=32, num_heads=4, n_layers=2, ctx_size=32,
                dtype="float32")
TP_MOE = dict(TP_SIZES, n_experts=4, capacity_factor=4.0)
TP_PROMPT = np.random.default_rng(1).integers(1, 64, size=(2, 5)).astype(np.int32)
TP_MOE_PROMPT = np.random.default_rng(3).integers(1, 64, size=(2, 4)).astype(np.int32)
TP_SAMPLING = dict(temperature=0.8, top_k=8, seed=7)


@pytest.fixture(scope="module")
def tp_runs(devices8, tmp_path_factory):
    """The 2 ranks' tokens for the three cases, JAX's ``make_tp_generate``
    (computed meanwhile) and the port's single-process ones."""
    from concurrent.futures import ThreadPoolExecutor

    from ddl25spring_tpu.parallel.tp import shard_tp_params
    from ddl25spring_tpu.utils.mesh import make_mesh
    from ddl25spring_tpu_torch.parallel.launch import spawn
    from test_torch_serve_tp import tp_generate_rank

    cfg, moe_cfg = LlamaConfig(**TP_SIZES), LlamaConfig(**TP_MOE)
    model, moe = _model(cfg, seed=0), _model(moe_cfg, seed=2)
    params, moe_params = llama.export_params(model), llama.export_params(moe)
    s = TP_SAMPLING
    cases = [(cfg, params, TP_PROMPT, 8, sv, 0.0, 0, None) for sv in (True, False)]
    cases.append((moe_cfg, moe_params, TP_MOE_PROMPT, 6, True, s["temperature"], s["top_k"],
                  s["seed"]))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, tp_generate_rank, 2, cases, timeout=120,
                            tmpdir=str(tmp_path_factory.mktemp("rdv")))
        mesh = make_mesh(devices8[:2], model=2)
        jcfg = jconfig.LlamaConfig(**TP_SIZES)
        jparams = jax.tree.map(jnp.asarray, params)
        refs = {sv: np.asarray(jdecode.make_tp_generate(jcfg, mesh, 8, shard_vocab=sv)(
            shard_tp_params(jparams, mesh, shard_vocab=sv), jnp.asarray(TP_PROMPT),
            jax.random.PRNGKey(0))) for sv in (True, False)}
        refs["sampled"] = dm.generate(moe, torch.from_numpy(TP_MOE_PROMPT), moe_cfg, 6,
                                      temperature=s["temperature"], top_k=s["top_k"],
                                      key=torch.Generator().manual_seed(s["seed"])).numpy()
        _, refs["gaps"] = _teacher_forced(model, TP_PROMPT, cfg, 8)
        return ranks.result(), refs


@pytest.mark.parametrize("shard_vocab", [True, False])
def test_tp_generate_equals_single_device(tp_runs, shard_vocab):
    """Head-sharded attention and cache, the row-parallel sums and (with
    ``shard_vocab``) the vocab-sharded embedding and one logits all-gather:
    greedy tokens on both ranks equal JAX ``make_tp_generate``'s."""
    ranks, refs = tp_runs
    assert min(refs["gaps"]) > MARGIN, refs["gaps"]
    for r in ranks:
        np.testing.assert_array_equal(r[0 if shard_vocab else 1], refs[shard_vocab])


def test_tp_generate_moe_and_sampled(tp_runs):
    """Switch-MoE blocks under TP (global routing, expert slices, the sum
    completing the combine) and a sampled chain: every rank draws the same
    stream, the single-process ``generate``'s with the same generator."""
    ranks, refs = tp_runs
    for r in ranks:
        np.testing.assert_array_equal(r[2], refs["sampled"])
