"""The port's split-NN VFL and tabular VAE/TSTR against the JAX package's,
on the CPU, one torch thread, on the real ``data/heart.csv``.

Tolerances: the encoded heart matrix and the party partition are bitwise
equal; the VFL logits (evaluation) and one AdamW step with dropout off within
1e-5 of the JAX network's forward and ``optax.adamw`` step; the VAE's
train-mode forward with a given ``eps``, one Adam step and the BatchNorm
running statistics after it within 1e-5 of flax's.  The last needs flax's
BatchNorm: torch's ``BatchNorm1d`` (unbiased running variance) misses it.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.data import heart  # noqa: E402
from ddl25spring_tpu_torch.fl import generative, vertical  # noqa: E402
from ddl25spring_tpu_torch.models import flax_bridge  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return heart.load_heart(seed=42)


def _close_trees(got: dict, want: dict, rel: float):
    want = dict(flatten(want))
    got = flatten(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, a in got:
        ref = np.asarray(want[path])
        assert a.shape == ref.shape, path
        assert np.abs(a - ref).max() <= rel * max(np.abs(ref).max(), 1.0), path


def test_heart_data_is_the_jax_packages_bitwise(data):
    from ddl25spring_tpu.data import heart as jheart

    want = jheart.load_heart(seed=42)
    assert data["provenance"] == want["provenance"] == "real"
    assert data["x"].shape == (1025, want["x"].shape[1]) and data["x"].dtype == np.float32
    assert np.array_equal(data["x"], want["x"]) and np.array_equal(data["y"], want["y"])
    assert data["feature_names"] == want["feature_names"]
    assert data["feature_slices"] == want["feature_slices"]
    for k in (2, 4):
        got = heart.partition_features(data["feature_slices"], k)
        ref = jheart.partition_features(want["feature_slices"], k)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)) and len(got) == k
        assert sorted(np.concatenate(got).tolist()) == list(range(data["x"].shape[1]))


# -------------------------------------------------------------------- VFL


def _numpy_params(init, seed):
    """A flax params tree from ``jax.eval_shape`` of ``init``, numpy float32
    from ``seed``: kernels N(0, 1/fan_in), everything else N(0, 0.1)."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / leaf.shape[0]), leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))["params"]


def test_vfl_forward_and_adamw_step_match_jax(data):
    """The JAX package's split network (its ``BottomModel``s, ``TopModel`` and
    the cut-layer concat of ``VFLNetwork._forward``, dropout off) and an
    ``optax.adamw(1e-3)`` step, against the port's on the same weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu.fl.vertical import BottomModel, TopModel
    from ddl25spring_tpu.ops.losses import cross_entropy_logits as jce

    feats = heart.partition_features(data["feature_slices"], 4)
    x, y = data["x"][:64], data["y"][:64]
    bottoms = [BottomModel(2 * len(f)) for f in feats]
    top = TopModel(2)
    key = jax.random.PRNGKey(0)
    params = {"bottoms": [_numpy_params(lambda m=m, f=f: m.init(key, jnp.zeros((1, len(f)))), i)
                          for i, (m, f) in enumerate(zip(bottoms, feats))],
              "top": _numpy_params(lambda: top.init(key, jnp.zeros((1, 2 * x.shape[1]))), 9)}
    xs = [x[:, f] for f in feats]

    def forward(p):
        acts = [m.apply({"params": q}, xi) for m, q, xi in zip(bottoms, p["bottoms"], xs)]
        return top.apply({"params": p["top"]}, jnp.concatenate(acts, axis=1))

    tx = optax.adamw(1e-3)
    grads = jax.jit(jax.grad(lambda p: jce(forward(p), y)))(params)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))

    net = vertical.VFLNetwork(feats, lr=1e-3, seed=42, device="cpu")
    for m, p in zip(net.bottoms, params["bottoms"]):
        flax_bridge.load_flax_params(m, p)
    flax_bridge.load_flax_params(net.top, params["top"])
    parts = net.split(torch.from_numpy(np.array(x)))
    with torch.no_grad():
        logits = net.forward(parts).numpy()
    np.testing.assert_allclose(logits, np.asarray(jax.jit(forward)(params)), atol=1e-5)
    net.step(parts, torch.from_numpy(np.array(y)).long(), None)
    got = {"bottoms": {str(i): flax_bridge.export_params(m) for i, m in enumerate(net.bottoms)},
           "top": flax_bridge.export_params(net.top)}
    want = {"bottoms": {str(i): p for i, p in enumerate(want["bottoms"])}, "top": want["top"]}
    _close_trees(got, want, 1e-5)
    assert net.opt.defaults["weight_decay"] == 1e-4  # optax.adamw's, not torch's 1e-2


def test_vfl_trains_above_chance(data):
    x, y = data["x"], data["y"]
    n = int(0.8 * len(x))
    net = vertical.VFLNetwork(heart.partition_features(data["feature_slices"], 4), seed=42,
                              device="cpu")
    losses = net.train_with_settings(10, 64, x[:n], y[:n])
    assert losses[-1] < losses[0]
    acc, _ = net.test(x[n:], y[n:])
    assert acc > max(np.mean(y[n:]), 1 - np.mean(y[n:])) - 0.05  # beats/approaches majority
    masks = net.draw_masks(5)
    assert [tuple(m.shape) for m in masks] == [(5, b.out_dim) for b in net.bottoms] + [(5, 256)]


# -------------------------------------------------------------- VAE, TSTR


def _vae_variables(module, x, key, seed):
    """flax variables of ``module`` on ``x``, numpy float32 from ``seed``:
    kernels N(0, 1/fan_in), biases and means N(0, 0.1), scales 1 + N(0, 0.1),
    variances U(0.5, 1.5)."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0.0, np.sqrt(1.0 / shape[0]), shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(key, x, train=True, key=key))
    return jax.tree_util.tree_map_with_path(fill, shapes)


LR = 1e-3


@pytest.fixture(scope="module")
def vae_case(data):
    """The JAX package's ``VaeModule`` on 16 real rows: its train-mode forward
    (``mutable=["batch_stats"]``) and one step of ``TabularVAE``'s train step
    (``vae_loss``, ``optax.adam(1e-3)``), from numpy weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from ddl25spring_tpu.fl.generative import VaeModule
    from ddl25spring_tpu.ops.losses import vae_loss

    real = np.concatenate([data["x"][:16], data["y"][:16, None].astype(np.float32)], axis=1)
    module = VaeModule(real.shape[1])
    key = jax.random.PRNGKey(5)
    variables = _vae_variables(module, real, key, 1)
    eps = np.asarray(jax.random.normal(key, (16, 16)))  # VaeModule's draw for this key
    apply = jax.jit(lambda p, s: module.apply({"params": p, "batch_stats": s}, real, train=True,
                                              key=key, mutable=["batch_stats"]))
    params, stats = variables["params"], variables["batch_stats"]
    (recon, mu, logvar), upd = apply(params, stats)
    tx = optax.adam(LR)

    def loss_fn(p):
        (r, m, lv), mutated = apply(p, stats)
        return vae_loss(r, jnp.asarray(real), m, lv), mutated["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"x": real, "eps": eps, "variables": variables,
            "forward": [np.asarray(a) for a in (recon, mu, logvar)],
            "stats_after_forward": to_np(upd["batch_stats"]), "loss": float(loss),
            "params": to_np(optax.apply_updates(params, updates)), "stats": to_np(new_stats)}


def _port_vae(case):
    vae = generative.TabularVAE(d_in=case["x"].shape[1], seed=42, device="cpu")
    flax_bridge.load_flax_params(vae.module, case["variables"]["params"],
                                 case["variables"]["batch_stats"])
    return vae


def test_vae_forward_adam_step_and_running_stats_match_flax(vae_case):
    vae = _port_vae(vae_case)
    x, eps = torch.tensor(vae_case["x"]), torch.tensor(vae_case["eps"])
    module = copy.deepcopy(vae.module).train()
    with torch.no_grad():
        out = module(x, eps)
    for a, ref in zip(out, vae_case["forward"]):
        assert np.abs(a.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    _close_trees(flax_bridge.export_batch_stats(module), vae_case["stats_after_forward"], 1e-5)

    loss = vae.step(x, eps)
    assert abs(float(loss) - vae_case["loss"]) <= 1e-5 * abs(vae_case["loss"])
    _close_trees(flax_bridge.export_batch_stats(vae.module), vae_case["stats"], 1e-5)
    # where a gradient is zero but for rounding (a Dense bias that feeds a
    # BatchNorm, whose mean the norm takes out; a weight into an output
    # column whose target is 0 on every row) Adam's first step moves the
    # weight by up to lr either way, by the sign of the noise: those elements
    # are held to 2 lr, every other one to 1e-5 of its leaf
    want = dict(flatten(vae_case["params"]))
    grads = dict(flatten(flax_bridge.export_grads(vae.module)))
    g_max = max(np.abs(g).max() for g in grads.values())
    noise = 0
    for path, a in flatten(flax_bridge.export_params(vae.module)):
        rounding = np.abs(grads[path]) <= 1e-5 * g_max
        tol = np.where(rounding, 2 * LR, 1e-5 * max(np.abs(want[path]).max(), 1.0))
        assert (np.abs(a - want[path]) <= tol).all(), path
        noise += int(rounding.sum())
    assert noise < 0.05 * sum(g.size for g in grads.values())


def test_the_biased_variance_trap_matters(vae_case):
    """torch's ``BatchNorm1d`` (momentum 0.1 = flax's 0.9) updates the running
    variance with the unbiased batch variance: on the encoder's first norm it
    misses flax's running variance by far more than the 1e-5 band."""
    vae = _port_vae(vae_case)
    enc = vae.module.encoder
    bn = torch.nn.BatchNorm1d(enc.BatchNorm_0.weight.numel(), momentum=0.1, eps=1e-5)
    with torch.no_grad():
        bn.running_mean.copy_(enc.BatchNorm_0.running_mean)
        bn.running_var.copy_(enc.BatchNorm_0.running_var)
        bn.train()(enc.Dense_0(torch.tensor(vae_case["x"])))
    want = vae_case["stats_after_forward"]["encoder"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], atol=1e-5)
    assert np.abs(bn.running_var.numpy() - want["var"]).max() > 1e-3


def test_vae_loss_decreases_and_samples(data):
    real = np.concatenate([data["x"], data["y"][:, None].astype(np.float32)], axis=1)
    vae = generative.TabularVAE(d_in=real.shape[1], seed=42, device="cpu")
    losses = vae.train_with_settings(5, 64, real)
    assert losses[-1] < losses[0]
    mu, logvar = vae.encode_stats(real)
    synth = vae.sample(100, mu, logvar)
    assert synth.shape == (100, real.shape[1])
    assert set(np.unique(synth[:, -1])) <= {0.0, 1.0}  # label clipped and rounded


def test_tstr_harness(data):
    x, y = data["x"], data["y"]
    n = int(0.8 * len(x))
    vae = generative.TabularVAE(d_in=x.shape[1] + 1, seed=42, device="cpu")
    vae.train_with_settings(3, 64, np.concatenate([x[:n], y[:n, None].astype(np.float32)], 1))
    res = generative.tstr(vae, x[:n], y[:n], x[n:], y[n:])
    assert 0.0 <= res["synthetic"] <= 1.0
    assert res["real"] > 0.6  # the evaluator learns the real data
