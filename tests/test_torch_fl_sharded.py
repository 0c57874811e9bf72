"""The FedAvg round with its client axis over ranks (``make_fedavg_round(...,
comm=)``) on the CPU, the counterpart of the JAX round placed over a
``clients`` mesh (``__graft_entry__.py:281-323``): a 2-rank gloo world, 4
clients with unequal, non-IID counts (the dryrun's split: 8 rows a client
plus 3, ``split_indices(iid=False, seed=10)``), B = 4, E = 2, the JAX
package's own row orders handed in.  The sharded round equals the
one-process round within 1e-6 (only the order of the weighted sums moves)
and the JAX ``make_fedavg_round`` over the whole client axis within 1e-5
(the FedAvg band of ``tests/test_torch_fl_horizontal.py``); a client count
that the world does not split evenly raises on every rank.  The ranks
import this module, so it imports jax only inside the tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402

from ddl25spring_tpu_torch.data import splitter  # noqa: E402
from ddl25spring_tpu_torch.fl.horizontal import make_fedavg_round  # noqa: E402
from ddl25spring_tpu_torch.models import flax_bridge  # noqa: E402
from ddl25spring_tpu_torch.models.layers import dense  # noqa: E402
from ddl25spring_tpu_torch.parallel.bucketing import flatten  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402

N_CLIENTS, WORLD, B, E, LR, SEED = 4, 2, 4, 2, 0.05, 10


class TinyMlp(nn.Module):
    """The counterpart of the JAX tests' dropout-free ``TinyMlp``."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.Dense_0 = dense(784, 32, g)
        self.Dense_1 = dense(32, 10, g)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return torch.log_softmax(self.Dense_1(x), -1)


def _model(tree):
    return flax_bridge.load_flax_params(TinyMlp(), tree)


def _round_args(data, orders):
    cx, cy, counts = data
    return (torch.from_numpy(cx), torch.from_numpy(cy).long(),
            torch.from_numpy(counts).float(), lambda e: torch.from_numpy(orders[e]),
            lambda e, i: ())


def sharded_round_rank(rdv, tree, data, orders):
    """One rank of the world: the sharded round over every client, then the
    same call with one client fewer than the world splits."""
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with init_mesh(rdv, data=WORLD, stages=1, device="cpu") as mesh:
        model = _model(tree)
        params = {n: p.detach() for n, p in model.named_parameters()}
        fedavg_round = make_fedavg_round(model, LR, B, E, comm=mesh.comm)
        new = fedavg_round(params, *_round_args(data, orders))
        cx, cy, counts, orders_fn, masks = _round_args(data, orders)
        try:
            fedavg_round(params, cx[:3], cy[:3], counts[:3], orders_fn, masks)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        return {"params": flax_bridge.export_params(_load(model, new)), "refusal": refusal}


def _load(model, new):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(new[n])
    return model


def _jax_orders(counts, max_n):
    """The JAX round's row orders of round 0 for clients ``0..N-1``
    (``horizontal.py:254-263``): the real rows shuffled by a uniform key,
    pads after them, zeros up to ``nb * b``."""
    import jax
    import jax.numpy as jnp

    from ddl25spring_tpu.utils.prng import client_round_key

    nb = -(-max_n // B)
    base = jax.random.PRNGKey(SEED)
    out = []
    for e in range(E):
        rows = []
        for i, count in enumerate(counts):
            ekey = jax.random.fold_in(client_round_key(base, 0, i), e)
            u = jax.random.uniform(jax.random.fold_in(ekey, nb + 1), (max_n,))
            perm = jnp.argsort(jnp.where(jnp.arange(max_n) < count, u, 2.0))
            rows.append(np.concatenate([np.asarray(perm), np.zeros(nb * B - max_n, np.int64)]))
        out.append(np.stack(rows).astype(np.int64))
    return out


def test_sharded_round_equals_one_process_and_jax(tmp_path):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from ddl25spring_tpu.fl.horizontal import make_fedavg_round as j_make_fedavg_round
    from ddl25spring_tpu.utils.prng import client_round_key

    class JaxTinyMlp(fnn.Module):  # tests/test_fl_horizontal.py's TinyMlp
        @fnn.compact
        def __call__(self, x, *, train: bool = False):
            x = x.reshape((x.shape[0], -1))
            x = fnn.relu(fnn.Dense(32)(x))
            return fnn.log_softmax(fnn.Dense(10)(x))

    rng = np.random.default_rng(0)
    n = 8 * N_CLIENTS + 3
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    data = splitter.stack_client_data(x, y, splitter.split_indices(y, N_CLIENTS, False, SEED))
    counts = data[2]
    assert len(set(counts.tolist())) > 1, "want unequal client counts"
    tree = {"Dense_0": {"kernel": rng.normal(0, 784 ** -0.5, (784, 32)).astype(np.float32),
                        "bias": rng.normal(0, 0.1, (32,)).astype(np.float32)},
            "Dense_1": {"kernel": rng.normal(0, 32 ** -0.5, (32, 10)).astype(np.float32),
                        "bias": rng.normal(0, 0.1, (10,)).astype(np.float32)}}
    orders = _jax_orders(counts, data[0].shape[1])

    ranks = spawn(sharded_round_rank, WORLD, tree, data, orders, timeout=120,
                  tmpdir=str(tmp_path))
    model = _model(tree)
    params = {k: p.detach() for k, p in model.named_parameters()}
    one = flax_bridge.export_params(_load(model, make_fedavg_round(model, LR, B, E)(
        params, *_round_args(data, orders))))
    keys = jnp.stack([client_round_key(jax.random.PRNGKey(SEED), 0, i)
                      for i in range(N_CLIENTS)])
    want = j_make_fedavg_round(JaxTinyMlp(), lr=LR, batch_size=B, nr_epochs=E)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(data[0]), jnp.asarray(data[1]),
        jnp.asarray(counts, jnp.float32), keys)
    want = dict(flatten(jax.tree.map(np.asarray, want)))
    before = dict(flatten(tree))
    for r in ranks:
        assert "do not split evenly over 2 ranks" in r["refusal"]
        got = flatten(r["params"])
        assert [p for p, _ in got] == [p for p, _ in flatten(one)]
        for (path, a), (_, b) in zip(got, flatten(one)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=path)
            np.testing.assert_allclose(a, want[path], atol=1e-5, rtol=0, err_msg=path)
        assert all(not np.array_equal(a, before[p]) for p, a in got), "a leaf did not move"
