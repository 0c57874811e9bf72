"""The port's ResNet-18 and CIFAR-10 data against the JAX package's, on the CPU,
narrow (width 8) and float32, weights passed across from flax with
``load_flax_params``.  The flax weights are drawn from a numpy seed into the
tree that ``jax.eval_shape(model.init)`` describes (no compiled init), with
scales and biases away from 1 and 0 so that the bridge moves every leaf.

Tolerances: logits within 1e-5 of max |logit| (the convs and norms differ in
summation order only); 3 SGD-momentum steps within 5e-5 of optax (losses and
parameters); BatchNorm's train-mode output and running statistics within
1e-5 of max |ref|; the pipeline stages composed equal the whole model to
1e-6.  The uint8 CIFAR-10 batches are compared byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.data import cifar10  # noqa: E402
from ddl25spring_tpu_torch.models import resnet  # noqa: E402
from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits  # noqa: E402
from ddl25spring_tpu_torch.parallel import bucketing  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import make_train_step, param_leaves  # noqa: E402

W = 8
X = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
Y = np.array([3, 1, 7, 0], np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host, and torch's CPU kernels would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _port(norm, variables):
    m = resnet.ResNet18(norm=norm, width=W, generator=torch.Generator().manual_seed(9))
    return resnet.load_flax_params(m, variables["params"], variables.get("batch_stats"))


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def numpy_variables(model, seed: int) -> dict:
    """A flax variables tree of ``model``'s structure on ``X``, numpy float32
    from ``seed``: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases
    and BatchNorm means N(0, 0.1), BatchNorm variances U(0.5, 1.5)."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            a = rng.normal(0.0, 0.1, shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), X)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def flax_group():
    import jax

    from ddl25spring_tpu.models.resnet import ResNet18

    model = ResNet18(norm="group", width=W)
    variables = numpy_variables(model, 0)
    logits = jax.jit(model.apply)(variables, X)
    return model, variables, np.asarray(logits)


def test_group_logits_match_flax(flax_group):
    _, variables, want = flax_group
    m = _port("group", variables)
    with torch.no_grad():
        got = m(_nchw(X))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _close(got.numpy(), want, 1e-5)
    # the bridge round-trips: every leaf back in flax's layout, bit for bit
    back = bucketing.flatten(resnet.export_params(m))
    ref = bucketing.flatten(variables["params"])
    assert [p for p, _ in back] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(back, ref):
        assert a.shape == b.shape and np.array_equal(a, b), path


def test_exports_are_copies(flax_group):
    """An exported leaf keeps its value when the parameter (or its gradient)
    changes in place afterwards: a float32 CPU tensor's ``numpy()`` shares
    its memory, so the bridge must copy."""
    m = _port("group", variables=flax_group[1])
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    params, grads = resnet.export_params(m), resnet.export_grads(m)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
            p.grad.zero_()
    for (path, a), (_, b) in zip(bucketing.flatten(params),
                                 bucketing.flatten(flax_group[1]["params"])):
        assert np.array_equal(a, b), path
    assert all((g == 1).all() for _, g in bucketing.flatten(grads))


@pytest.mark.parametrize("trap", ["symmetric-stride-2-padding", "torch-groupnorm-eps"])
def test_the_flax_traps_matter(flax_group, monkeypatch, trap):
    """The logits check above fails with torch's defaults in either place:
    ``padding=1`` on the stride-2 convs, or GroupNorm's eps 1e-5."""
    _, variables, want = flax_group
    m = _port("group", variables)
    if trap == "symmetric-stride-2-padding":
        monkeypatch.setattr(resnet, "same_pads", lambda size, k, stride: (k // 2, k // 2))
    else:
        for mod in m.modules():
            if isinstance(mod, resnet.GroupNorm):
                mod.eps = 1e-5
    with torch.no_grad():
        got = m(_nchw(X)).numpy()
    assert np.abs(got - want).max() > 1e-5 * np.abs(want).max()


def test_same_padding_rule():
    assert resnet.same_pads(32, 3, 1) == (1, 1)
    assert resnet.same_pads(32, 3, 2) == (0, 1)   # flax pads the bottom only
    assert resnet.same_pads(31, 3, 2) == (1, 1)
    assert resnet.same_pads(32, 1, 2) == (0, 0)   # the 1x1 shortcut


def test_three_sgd_momentum_steps_match_optax(flax_group):
    import jax
    import optax

    from ddl25spring_tpu.ops.losses import cross_entropy_logits as jce

    model, variables, _ = flax_group
    # three batches of the bench's data: synthetic CIFAR-10, normalized
    data = cifar10.load_cifar10_u8(n_train=64)
    x = cifar10.normalize_on_device(torch.from_numpy(data["x"][:12])).numpy()
    batches = [(x[i:i + 4], data["y"][i:i + 4]) for i in (0, 4, 8)]
    tx = optax.sgd(0.1, momentum=0.9)

    @jax.jit
    def jstep(p, o, x, y):
        loss, g = jax.value_and_grad(lambda p: jce(model.apply({"params": p}, x), y))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    params, opt_state, want = variables["params"], tx.init(variables["params"]), []
    for x, y in batches:
        params, opt_state, loss = jstep(params, opt_state, x, y)
        want.append(float(loss))

    m = _port("group", variables)
    step = make_train_step(m, lambda mod, b: cross_entropy_logits(mod(b[0]), b[1]),
                           torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9))
    got = [step((_nchw(x), torch.from_numpy(y))).item() for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=5e-5)
    for (path, a), (_, b) in zip(bucketing.flatten(resnet.export_params(m)),
                                 bucketing.flatten(jax.tree.map(np.asarray, params))):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=path)


def test_batchnorm_train_step_matches_flax_mutable():
    """Train-mode output and the updated ``batch_stats`` (flax keeps 0.9 of
    the running statistics and takes the biased batch variance); then the
    eval-mode output, which reads the running statistics."""
    import jax

    from ddl25spring_tpu.models.resnet import ResNet18

    model = ResNet18(norm="batch", width=W)
    variables = numpy_variables(model, 3)
    want, upd = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                                 mutable=["batch_stats"]))(variables, X)
    want_eval = jax.jit(model.apply)({"params": variables["params"], **upd}, X)

    m = _port("batch", variables).train()
    with torch.no_grad():
        got = m(_nchw(X))
    _close(got.numpy(), want, 1e-5)
    stats = bucketing.flatten(resnet.export_batch_stats(m))
    ref = bucketing.flatten(jax.tree.map(np.asarray, upd["batch_stats"]))
    assert [p for p, _ in stats] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(stats, ref):
        _close(a, b, 1e-5)
    # an unbiased running variance would differ from flax's by n/(n-1)
    var = [b for p, b in ref if p.endswith("var")]
    before = [b for p, b in bucketing.flatten(variables["batch_stats"]) if p.endswith("var")]
    assert any(np.abs(v - v0).max() > 1e-3 for v, v0 in zip(var, before))
    with torch.no_grad():
        got_eval = m.eval()(_nchw(X))
    _close(got_eval.numpy(), want_eval, 1e-5)


@pytest.mark.parametrize("num_stages", [1, 2, 3, 4])
def test_stages_compose_to_the_whole_model(flax_group, num_stages):
    _, variables, _ = flax_group
    whole = _port("group", variables)
    stages = resnet.make_resnet_stages(num_stages, width=W, seed=5)
    for st, tree in zip(stages, resnet.split_params_for_stages(variables["params"], num_stages)):
        resnet.load_flax_params(st, tree)
        assert sorted(resnet.export_params(st)) == sorted(tree)
    with torch.no_grad():
        h = _nchw(X)
        for st in stages:
            h = st(h)
        want = whole(_nchw(X))
    torch.testing.assert_close(h, want, rtol=0, atol=1e-6)
    # each hop's shape per sample: the plan's count against the chain's tensors
    shapes, h = [], _nchw(X)
    with torch.no_grad():
        for st in stages:
            h = st(h)
            shapes.append(tuple(h.shape[1:]))
    assert resnet.boundary_shapes(num_stages, width=W) == shapes
    # a rank builds its own stage alone, with the same weights
    alone = resnet.resnet_stage(num_stages - 1, num_stages, width=W, seed=5)
    assert all(torch.equal(a, b) for a, b in zip(alone.parameters(),
                                                 resnet.make_resnet_stages(
                                                     num_stages, width=W, seed=5)[-1]
                                                 .parameters()))


def test_stage_counts_outside_1_to_4_raise():
    for bad in (0, 5):
        with pytest.raises(ValueError, match="S in"):
            resnet.make_resnet_stages(bad, width=W)


def test_param_tree_plans_the_jax_buckets(flax_group):
    from ddl25spring_tpu.parallel import bucketing as jbucketing

    _, variables, _ = flax_group
    m = _port("group", variables)
    for bb in (2048, 16384, bucketing.DEFAULT_BUCKET_BYTES):
        got = bucketing.plan_buckets(param_leaves(m), bb)
        want = jbucketing.plan_buckets(variables["params"], bb)
        assert got.buckets == tuple(tuple(b) for b in want.buckets)
        assert got.sizes == tuple(want.sizes)


def test_full_width_parameter_count():
    m = resnet.ResNet18(norm="group", generator=torch.Generator().manual_seed(0))
    s0, s1 = resnet.make_resnet_stages(2)
    count = [sum(p.numel() for p in mod.parameters()) for mod in (m, s0, s1)]
    assert count == [11_173_962, 675_392, 10_498_570]


def test_normalized_cifar10_splits_equal_the_jax_package():
    from ddl25spring_tpu.data import cifar10 as jcifar10

    got = cifar10.load_cifar10(n_train=32, n_test=16)
    want = jcifar10.load_cifar10(n_train=32, n_test=16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_cifar10_batches_are_byte_identical():
    from ddl25spring_tpu.data import cifar10 as jcifar10

    got, want = cifar10.load_cifar10_u8(n_train=64), jcifar10.load_cifar10_u8(n_train=64)
    assert got["provenance"] == want["provenance"]
    for k in ("x", "y"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    assert np.array_equal(cifar10.MEAN, jcifar10.MEAN) and np.array_equal(cifar10.STD,
                                                                           jcifar10.STD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_on_device_matches_jax(dtype):
    import jax.numpy as jnp

    from ddl25spring_tpu.data.native_loader import normalize_on_device as jnorm

    x = cifar10.load_cifar10_u8(n_train=64)["x"][:8]
    got = cifar10.normalize_on_device(torch.from_numpy(x), getattr(torch, dtype))
    want = np.asarray(jnorm(jnp.asarray(x), getattr(jnp, dtype)).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:  # one bf16 rounding of each operation on each side
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=2e-2)
