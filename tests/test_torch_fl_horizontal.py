"""The port's horizontal FL (FedSGD, FedAvg) and its data against the JAX
package's, on the CPU, one torch thread.

Flax weights are drawn from a numpy seed into the tree that
``jax.eval_shape(model.init)`` describes and passed across through numpy.
Tolerances: the MNIST arrays, the client splits and the chosen clients are
bitwise equal; ``MnistCnn``'s logits within 1e-5 and its gradients within
1e-5 of each leaf's max |ref|; the FedSGD and FedAvg rounds within atol
1e-5 (and rtol 1e-4 over two rounds) of the JAX servers'; the vmapped round
within 1e-6 of the per-client loop; the A1 oracle (FedSGD vs FedAvg at
B=-1, E=1, with dropout on) within atol 1e-5, rtol 1e-4 and 2e-4 in test
accuracy per round, the reference notebook's band.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from torch import nn  # noqa: E402

from ddl25spring_tpu_torch import bench  # noqa: E402
from ddl25spring_tpu_torch.data import mnist, splitter  # noqa: E402
from ddl25spring_tpu_torch.fl import horizontal  # noqa: E402
from ddl25spring_tpu_torch.fl.horizontal import FedAvgServer, FedSgdGradientServer  # noqa: E402
from ddl25spring_tpu_torch.models import flax_bridge, mnist_cnn  # noqa: E402
from ddl25spring_tpu_torch.models.layers import dense, dropout, keep_mask  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.utils.prng import client_round_generator  # noqa: E402


class TinyMlp(nn.Module):
    """The counterpart of the JAX tests' dropout-free ``TinyMlp``."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.Dense_0 = dense(784, 32, g)
        self.Dense_1 = dense(32, 10, g)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return torch.log_softmax(self.Dense_1(x), -1)


class TinyDropoutMlp(TinyMlp):
    """A narrow model with dropout (0.3 after the hidden layer), whose masks
    come from the caller, as ``MnistCnn``'s do."""

    def dropout_masks(self, rows, generator):
        return (keep_mask((rows, 32), 0.3, generator),)

    def forward(self, x, masks=None):
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = dropout(x, masks[0] if masks else None, 0.3)
        return torch.log_softmax(self.Dense_1(x), -1)


@pytest.fixture(scope="module")
def small_data():
    return mnist.load_mnist(n_train=300, n_test=100)


def _jax_tiny_mlp():
    import flax.linen as fnn

    class JaxTinyMlp(fnn.Module):  # tests/test_fl_horizontal.py's TinyMlp
        @fnn.compact
        def __call__(self, x, *, train: bool = False):
            x = x.reshape((x.shape[0], -1))
            x = fnn.relu(fnn.Dense(32)(x))
            return fnn.log_softmax(fnn.Dense(10)(x))

    return JaxTinyMlp()


def _tree_close(got: dict, want: dict, atol, rtol=0.0):
    want = {p: np.asarray(a) for p, a in flatten(want)}
    got = flatten(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, a in got:
        np.testing.assert_allclose(a, want[path], atol=atol, rtol=rtol, err_msg=path)


# ------------------------------------------------------------------- data


def test_mnist_and_splits_are_the_jax_packages_bitwise(small_data):
    from ddl25spring_tpu.data import mnist as jmnist
    from ddl25spring_tpu.data import splitter as jsplitter

    want = jmnist.load_mnist(n_train=300, n_test=100)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert small_data[k].dtype == want[k].dtype and np.array_equal(small_data[k], want[k]), k
    assert small_data["x_train"].shape == (300, 28, 28, 1)
    y = small_data["y_train"]
    for iid in (True, False):
        got = splitter.split_indices(y, 7, iid, 10)
        ref = jsplitter.split_indices(y, 7, iid, 10)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)) and len(got) == len(ref)
        stacked = splitter.stack_client_data(small_data["x_train"], y, got)
        for a, b in zip(stacked, jsplitter.stack_client_data(small_data["x_train"], y, ref)):
            assert np.array_equal(a, b)


def test_client_choice_is_the_jax_servers(small_data):
    from ddl25spring_tpu.fl import FedAvgServer as JaxFedAvg

    kw = dict(nr_clients=10, client_fraction=0.3, batch_size=50, nr_local_epochs=1, lr=0.05,
              seed=10, data=small_data)
    jserver = JaxFedAvg(model=_jax_tiny_mlp(), **kw)
    server = FedAvgServer(model=TinyMlp(), device="cpu", **kw)
    assert server.clients_per_round == jserver.clients_per_round == 3
    for _ in range(3):
        assert np.array_equal(server.sample_clients(), jserver.sample_clients())
    assert [server.round_message_count(r) for r in range(3)] == [6, 12, 18]


# ---------------------------------------------------------------- MnistCnn


def _numpy_params(model, x, seed):
    """A flax params tree of ``model`` on ``x``, numpy float32 from ``seed``:
    kernels N(0, 1/fan_in), biases N(0, 0.1)."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(model.init, jax.random.PRNGKey(0), x))["params"]


@pytest.fixture(scope="module")
def flax_cnn(small_data):
    import jax

    from ddl25spring_tpu.models.mnist_cnn import MnistCnn as JaxCnn
    from ddl25spring_tpu.ops.losses import nll_loss as jnll

    model = JaxCnn()
    x, y = small_data["x_train"][:4], small_data["y_train"][:4]
    params = _numpy_params(model, x, 0)
    logits = jax.jit(lambda p: model.apply({"params": p}, x))(params)
    grads = jax.jit(jax.grad(lambda p: jnll(model.apply({"params": p}, x), y)))(params)
    return params, x, y, np.asarray(logits), jax.tree.map(np.asarray, grads)


def _port_cnn(params):
    return mnist_cnn.load_flax_params(
        mnist_cnn.MnistCnn(generator=torch.Generator().manual_seed(1)), params)


def test_mnist_cnn_logits_and_gradients_match_flax(flax_cnn):
    from ddl25spring_tpu_torch.ops.losses import nll_loss

    params, x, y, want_logits, want_grads = flax_cnn
    m = _port_cnn(params)
    logits = m(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-5)
    nll_loss(logits, torch.from_numpy(y)).backward()
    got = dict(flatten(mnist_cnn.export_grads(m)))
    for path, ref in flatten(want_grads):
        assert got[path].shape == ref.shape
        assert np.abs(got[path] - ref).max() <= 1e-5 * np.abs(ref).max(), path
    # the bridge round-trips every leaf bit for bit, and its exports are copies
    back = mnist_cnn.export_params(m)
    for (pa, a), (pb, b) in zip(flatten(back), flatten(params)):
        assert pa == pb and np.array_equal(a, b), pa
    with torch.no_grad():
        m.Dense_0.weight.add_(1.0)
    assert np.array_equal(back["Dense_0"]["kernel"], params["Dense_0"]["kernel"])


def test_the_flatten_permutation_matters(flax_cnn):
    """Loaded without the HWC -> CHW permutation of ``Dense_0``'s rows, the
    logits miss flax's by far more than the 1e-5 band above."""
    params, x, _, want, _ = flax_cnn
    m = flax_bridge.load_flax_params(
        mnist_cnn.MnistCnn(generator=torch.Generator().manual_seed(1)), params)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 1e-2


def test_mnist_cnn_dropout_masks_are_the_callers(small_data):
    m = mnist_cnn.MnistCnn(generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(small_data["x_train"][:8])
    g = torch.Generator().manual_seed(5)
    masks = m.dropout_masks(8, g)
    assert [tuple(t.shape) for t in masks] == [(8, 64, 12, 12), (8, 128)]
    assert all(t.dtype == torch.bool for t in masks)
    assert 0.65 < masks[0].float().mean() < 0.85 and 0.35 < masks[1].float().mean() < 0.65
    with torch.no_grad():
        a, b = m(x, masks), m(x, m.dropout_masks(8, torch.Generator().manual_seed(5)))
        assert torch.equal(a, b) and not torch.equal(a, m(x))


# ------------------------------------------------------- servers vs the JAX ones


def _jax_and_port(small_data, port_model, jax_cls, port_cls, **kw):
    jserver = jax_cls(model=_jax_tiny_mlp(), data=small_data, **kw)
    server = port_cls(model=port_model, data=small_data, device="cpu", **kw)
    flax_bridge.load_flax_params(server.model, jserver.params)
    return jserver, server


def test_fedsgd_and_fedavg_full_batch_match_the_jax_servers(small_data):
    from ddl25spring_tpu.fl import FedAvgServer as JaxFedAvg
    from ddl25spring_tpu.fl import FedSgdGradientServer as JaxFedSgd

    kw = dict(nr_clients=5, client_fraction=0.4, lr=0.05, seed=10, batch_size=-1,
              nr_local_epochs=1)
    for jax_cls, port_cls in ((JaxFedSgd, FedSgdGradientServer), (JaxFedAvg, FedAvgServer)):
        jserver, server = _jax_and_port(small_data, TinyMlp(), jax_cls, port_cls, **kw)
        for r in range(2):
            jserver.round(r)
            server.round(r)
        _tree_close(flax_bridge.export_params(server.model), jserver.params, 1e-5, 1e-4)
        assert server.test_accuracy() == jserver.test_accuracy()


def _jax_orders(server_seed, r, chosen, counts, max_n, b, epochs):
    """The JAX package's row orders for each chosen client and epoch
    (``horizontal.py:254-263``): the real rows shuffled by a uniform key,
    pads after them, zeros up to ``nb * b``."""
    import jax
    import jax.numpy as jnp

    from ddl25spring_tpu.utils.prng import client_round_key

    nb = -(-max_n // b)
    base = jax.random.PRNGKey(server_seed)
    out = []
    for e in range(epochs):
        rows = []
        for i, count in zip(chosen, counts):
            ekey = jax.random.fold_in(client_round_key(base, r, int(i)), e)
            u = jax.random.uniform(jax.random.fold_in(ekey, nb + 1), (max_n,))
            perm = jnp.argsort(jnp.where(jnp.arange(max_n) < count, u, 2.0))
            rows.append(np.concatenate([np.asarray(perm), np.zeros(nb * b - max_n, np.int64)]))
        out.append(torch.from_numpy(np.stack(rows)).long())
    return out


def test_noniid_minibatch_round_matches_jax_with_its_row_orders(small_data):
    """One non-IID FedAvg round at B=16, E=2: the port's round handed the JAX
    package's own row orders lands within 1e-5 of the JAX server's round."""
    from ddl25spring_tpu.fl import FedAvgServer as JaxFedAvg

    kw = dict(nr_clients=7, client_fraction=0.43, lr=0.05, seed=10, batch_size=16,
              nr_local_epochs=2, iid=False)
    jserver, server = _jax_and_port(small_data, TinyMlp(), JaxFedAvg, FedAvgServer, **kw)
    chosen = server.sample_clients()
    jserver.round(0)
    counts = server.counts[chosen]
    assert server.cx.shape[1] > counts.min(), "want a chosen client with pad rows"
    orders = _jax_orders(10, 0, chosen, counts, server.cx.shape[1], 16, 2)
    idx = torch.as_tensor(chosen)
    new = horizontal.make_fedavg_round(server.model, 0.05, 16, 2)(
        server.params, server.cx[idx], server.cy[idx], server.counts_dev[idx],
        lambda e: orders[e], lambda e, i: ())
    _tree_close(flax_bridge.export_params(new), jserver.params, 1e-5)


def test_vmapped_round_equals_a_per_client_loop(small_data):
    """One vmapped FedAvg round (dropout on, non-IID, B=16, E=2) equals the
    clients trained one by one from the same generators, then averaged."""
    server = FedAvgServer(nr_clients=4, client_fraction=1.0, batch_size=16, nr_local_epochs=2,
                          lr=0.05, iid=False, seed=10, model=TinyDropoutMlp(),
                          data=small_data, device="cpu")
    chosen = np.random.default_rng(10).choice(4, 4, replace=False)
    assert len(set(server.counts.tolist())) > 1, "want unequal client sizes"
    params0 = {n: t.clone() for n, t in server.params.items()}
    server.round(0)
    local = horizontal.make_fedavg_round(server.model, 0.05, 16, 2)
    per_client = []
    for i in chosen:
        draws = horizontal.ClientDraws(server.model, [client_round_generator(10, 0, int(i))],
                                       server.counts[[i]], server.cx.shape[1], 16, "cpu")
        sl = slice(int(i), int(i) + 1)
        per_client.append(local(params0, server.cx[sl], server.cy[sl], server.counts_dev[sl],
                                draws.orders, draws.masks))
    w = server.counts[chosen] / server.counts.sum()
    for n, t in server.params.items():
        looped = sum(float(wi) * c[n] for wi, c in zip(w, per_client))
        torch.testing.assert_close(t, looped, atol=1e-6, rtol=0)


def test_a1_oracle_with_dropout_on(small_data):
    """Homework A1 with dropout on: FedSGD-with-gradients equals
    FedAvg(B=-1, E=1)-with-weights, because both draw each client's masks
    first from the same per-(round, client) generator."""
    common = dict(nr_clients=4, client_fraction=0.5, lr=0.05, seed=10, data=small_data,
                  batch_size=-1, nr_local_epochs=1, device="cpu")
    grad_server = FedSgdGradientServer(model=TinyDropoutMlp(3), **common)
    weight_server = FedAvgServer(model=TinyDropoutMlp(3), **common)
    no_dropout = FedAvgServer(model=TinyMlp(3), **common)
    for r in range(3):
        grad_server.round(r)
        weight_server.round(r)
        no_dropout.round(r)
        assert abs(grad_server.test_accuracy() - weight_server.test_accuracy()) <= 2e-4
    for n, a in grad_server.params.items():
        torch.testing.assert_close(a, weight_server.params[n], atol=1e-5, rtol=1e-4)
    # the masks were applied: the same weights and clients without dropout differ
    assert (no_dropout.params["Dense_0.weight"] - weight_server.params["Dense_0.weight"]
            ).abs().max() > 1e-3


def test_local_update_invariant_to_pad_rows(small_data):
    """Positions ``>= count`` are masked out of the loss: a client padded with
    repeats and the same client padded with junk train to the same weights,
    full batch and minibatch."""
    m = TinyDropoutMlp()
    x = torch.from_numpy(small_data["x_train"][:40])
    y = torch.from_numpy(small_data["y_train"][:40]).long()
    count = 25
    x_rep, x_junk, y_junk = x.clone(), x.clone(), y.clone()
    x_rep[count:] = x[:40 - count]
    x_junk[count:] = 1e3
    y_junk[count:] = 0
    params = {n: p.detach() for n, p in m.named_parameters()}
    for b in (-1, 8):
        out = []
        for xs, ys in ((x_rep, y), (x_junk, y_junk)):
            draws = horizontal.ClientDraws(m, [torch.Generator().manual_seed(3)], [count], 40,
                                           b, "cpu")
            out.append(horizontal.make_fedavg_round(m, 0.05, b, 2)(
                params, xs[None], ys[None], torch.tensor([float(count)]), draws.orders,
                draws.masks))
        for n in params:
            assert torch.equal(out[0][n], out[1][n]), (b, n)


def test_fedavg_learns_counts_messages_and_is_seeded(small_data):
    mk = lambda: FedAvgServer(nr_clients=10, client_fraction=0.5, batch_size=50,  # noqa: E731
                              nr_local_epochs=2, lr=0.05, seed=10, model=TinyDropoutMlp(),
                              data=small_data, device="cpu")
    a, b = mk(), mk()
    res = a.run(3)
    assert res.test_accuracy[-1] > 0.6  # synthetic data is easy
    assert res.message_count == [10, 20, 30]  # 2*(r+1)*5
    df = res.as_df()
    assert list(df["Round"]) == [1, 2, 3] and df["Algorithm"].iloc[0] == "FedAvg"
    b.run(3)
    for n, t in a.params.items():
        assert torch.equal(t, b.params[n]), n


def test_centralized_learns(small_data):
    server = horizontal.CentralizedServer(lr=0.05, batch_size=50, seed=10, data=small_data,
                                          device="cpu")
    res = server.run(2)
    assert res.test_accuracy[-1] > 0.8 and res.message_count == [0, 0]


# ------------------------------------------------------------------- bench


@pytest.fixture
def short_test_set(monkeypatch):
    """The bench's MNIST with 100 test rows: evaluating ``MnistCnn`` on
    10,000 costs ~12 s on one CPU thread."""
    monkeypatch.setattr(bench, "load_mnist",
                        lambda n_train, n_test: mnist.load_mnist(n_train=n_train, n_test=100))


def test_fedavg_secondary_line(short_test_set):
    line = bench.fedavg_secondary(n_rounds=2, device="cpu", n_train=600)
    assert line["metric"] == "fedavg_round_ms" and line["unit"] == "ms/round"
    assert line["value"] > 0 and line["median_ms"] > 0 and line["rounds"] == 2
    assert line["n_train"] == 600 and line["device"] == "cpu"
    assert 0.0 <= line["test_accuracy"] <= 1.0
    json.dumps(line)


def test_bench_main_composes_its_line(monkeypatch, capsys, short_test_set):
    from ddl25spring_tpu_torch import benchmarks
    from ddl25spring_tpu_torch.lab import dp_pp

    seen = []

    def resnet_stub(argv, telemetry=None):
        seen.append(argv)
        # a run that hands back no live step: the line, its telemetry cells off
        return {"line": benchmarks.report_line("dp", 25000.0, "hbm-resident-shuffle", 0.08,
                                               80.0), "ranks": [{}]}

    monkeypatch.setattr(dp_pp, "main", resnet_stub)
    rec = bench.main(["--device", "cpu", "--rounds", "1", "--n-train", "600"])
    assert seen == [["--workload", "resnet", "--device", "cpu"]]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == rec
    assert last["metric"] == "cifar10_resnet18_dp_samples_per_sec_per_chip"
    assert last["value"] == 25000.0
    (fl,) = last["secondary"]
    assert fl["metric"] == "fedavg_round_ms" and fl["rounds"] == 1 and fl["n_train"] == 600
