"""Horizontal federated learning on PyTorch: FedSGD and FedAvg, the
counterpart of the JAX package's ``fl/horizontal.py``.

Capability parity with the reference's HFL framework
(``lab/tutorial_1a/hfl_complete.py:145-390``):

- :class:`CentralizedServer`: plain epoch training control (``:193-216``);
- :class:`FedSgdGradientServer`: each chosen client returns the gradient of
  one full-batch pass; the server applies the weighted average through its
  own SGD step (``:233-312``);
- :class:`FedAvgServer`: each chosen client runs E local epochs of
  minibatch SGD; the server takes the sample-count-weighted average of the
  returned weights (``:316-390``).

Clients.  The JAX round is one ``jax.vmap`` over the stacked client axis,
with nested ``lax.scan``s over epochs and batches.  Here each SGD step of
every chosen client is one ``torch.func.vmap`` over the client axis of
``torch.func.grad`` over ``functional_call`` (:func:`client_grads`),
followed by the plain update ``p - lr * g`` (``optax.sgd``); the epochs and
batches are a Python loop around it (:func:`local_epochs`).  The weighted
average is a dot product over the client axis (``horizontal.py:303-307``).
The stacked client shards ``cx``, ``cy`` and the counts live on the device
from construction on, and each round selects its clients there with
``index_select``.

Sampling.  Client choice is numpy's ``rng.choice`` and the centralized
order ``rng.permutation``, seeded as in the JAX package, so both packages
choose the same clients in the same order.

Randomness.  ``jax.random``'s stream cannot be reproduced in torch, so the
row orders and dropout masks are made explicit: each chosen client draws
them from its own ``torch.Generator`` per (seed, round, client)
(:func:`~ddl25spring_tpu_torch.utils.prng.client_round_generator`), on the
generator's device, and they enter the vmapped step as arguments
(:class:`ClientDraws`).  An epoch's row order is the client's real rows
``[0, count)`` in ``torch.randperm`` order, then its pad rows, then row 0 up
to ``nb * b`` (the layout of ``horizontal.py:250-263``); the loss masks
every position past ``count`` (``masked_nll_loss``), so the result does not
depend on what the pads hold.  A full batch (``B = -1``, or ``B >= `` the
largest shard) keeps the row order and draws no order, so FedSGD and
FedAvg(B=-1, E=1) draw the same first masks from the same generators: the
homework-A1 equivalence holds with dropout on.

Models.  A model takes the JAX package's NHWC batch and returns
log-probabilities; one with dropout has ``dropout_masks(rows, generator)``
and ``forward(x, masks)`` (:class:`~ddl25spring_tpu_torch.models.mnist_cnn.MnistCnn`).
The server's global weights are its ``model``'s parameters.

The client axis over ranks.  ``make_fedavg_round(..., comm=)`` splits the
round's clients over the ranks of a ``torch.distributed`` world, as the JAX
package places the client axis over a mesh (``__graft_entry__.py:281-323``,
``P("clients")``): each rank trains its contiguous block of the clients and
the weighted average is an all-reduce of the weighted sums and the counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call, grad, vmap

from ddl25spring_tpu_torch.data.mnist import load_mnist
from ddl25spring_tpu_torch.data.splitter import split_indices, stack_client_data
from ddl25spring_tpu_torch.models.mnist_cnn import MnistCnn
from ddl25spring_tpu_torch.ops.losses import masked_nll_loss, nll_loss
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.metrics import RunResult, fedavg_message_count
from ddl25spring_tpu_torch.utils.prng import client_round_generator


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_masks(model, rows: int, generator: torch.Generator) -> tuple:
    """``model``'s dropout keep-masks for a batch of ``rows`` (none for a
    model without dropout), on the generator's device."""
    return model.dropout_masks(rows, generator) if hasattr(model, "dropout_masks") else ()


def client_grads(model, params: dict, x, y, mask, masks=(), params_batched: bool = True):
    """Every client's gradient of its masked NLL at once: ``torch.func.vmap``
    over the leading client axis of ``x [K, b, ...]``, ``y [K, b]``,
    ``mask [K, b]`` and each of ``masks``, of ``torch.func.grad`` over
    ``functional_call(model, params, ...)``.  ``params`` holds a stack of
    ``K`` weights per leaf, or with ``params_batched=False`` one set shared
    by every client.  Returns ``{name: [K, ...]}``."""

    def loss(p, bx, by, bm, bmasks):
        return masked_nll_loss(functional_call(model, p, (bx, bmasks) if bmasks else (bx,)),
                               by, bm)

    in_dims = (0 if params_batched else None, 0, 0, 0, 0)
    return vmap(grad(loss), in_dims=in_dims)(params, x, y, mask, tuple(masks))


def local_epochs(model, params: dict, cx, cy, counts, orders, masks, *, lr: float,
                 batch_size: int, nr_epochs: int) -> dict:
    """The chosen clients' local training, side by side: ``nr_epochs``
    epochs of minibatch SGD at ``lr`` from the shared ``params``, on the
    stacked shards ``cx [K, max_n, ...]``, ``cy [K, max_n]`` of which the
    first ``counts [K]`` rows are real.  Parity: ``_make_local_epochs_fn``
    (``horizontal.py:203-286``), which runs one client under ``jax.vmap``.

    ``orders(e)`` gives epoch ``e``'s row order, ``[K, nb * b]`` row
    indices (the real rows in any order, then the pads, then any row up to
    ``nb * b``: positions ``>= count`` are masked out); it is not called for
    a full batch (``batch_size == -1`` or ``>= max_n``), which keeps the row
    order.  ``masks(e, i)`` gives batch ``i`` of epoch ``e``'s stacked
    dropout masks (``()`` for none).  Both are called in training order,
    each once.  Returns the clients' weights, ``{name: [K, ...]}``."""
    K, max_n = cx.shape[:2]
    full = batch_size == -1 or batch_size >= max_n
    b = max_n if full else batch_size
    nb = 1 if full else -(-max_n // b)
    dev = cx.device
    clients = torch.arange(K, device=dev)[:, None]
    counts = counts.reshape(K, 1)
    p = {n: t.expand(K, *t.shape) for n, t in params.items()}
    for e in range(nr_epochs):
        order = None if full else orders(e)
        for i in range(nb):
            pos = torch.arange(i * b, (i + 1) * b, device=dev)
            if full:
                bx, by = cx, cy
            else:
                rows = order[:, i * b:(i + 1) * b]
                bx, by = cx[clients, rows], cy[clients, rows]
            g = client_grads(model, p, bx, by, (pos < counts).float(), masks(e, i))
            p = {n: p[n] - lr * g[n] for n in p}
    return p


def make_fedavg_round(model, lr: float, batch_size: int, nr_epochs: int, comm=None):
    """One FedAvg round: :func:`local_epochs` over the client axis, then the
    sample-count-weighted average (``hfl_complete.py:370-383``).  The
    returned ``fedavg_round(params, cx, cy, counts, orders, masks)`` gives
    the new global weights.

    ``comm`` (a :class:`~ddl25spring_tpu_torch.parallel.comm.Comm` of an
    initialised ``torch.distributed`` world; None: this process takes every
    client) splits the client axis over the world's ranks, as the JAX round
    runs with the axis sharded ``P("clients")`` (``__graft_entry__.py:
    281-323``).  Every rank makes the same call with every client's shards,
    counts, orders and masks, and rank ``r`` of ``W`` trains the contiguous
    block ``[r * N/W, (r+1) * N/W)`` of the ``N`` clients; the world must
    split the clients evenly (``ValueError``, as the JAX sharding requires).
    Each rank sums ``counts_i * params_i`` and ``counts_i`` over its block,
    both sums are all-reduced over the world, and their quotient is the
    average on every rank.  The sums run in another order than the
    one-process ``tensordot(counts / counts.sum(), params)``: expect
    agreement to rounding (1e-6 in fp32), not bitwise.  A gloo world stages
    a card's tensors through pinned host buffers (:class:`Comm`)."""

    def block(x, rank, world):
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    @torch.no_grad()
    def fedavg_round(params, cx, cy, counts, orders, masks):
        if comm is None:
            client = local_epochs(model, params, cx, cy, counts, orders, masks, lr=lr,
                                  batch_size=batch_size, nr_epochs=nr_epochs)
            w = counts / counts.sum()  # hfl_complete.py:370-372
            return {n: torch.tensordot(w, t, dims=1) for n, t in client.items()}
        rank, world = dist.get_rank(), dist.get_world_size()
        if cx.shape[0] % world:
            raise ValueError(f"{cx.shape[0]} clients do not split evenly over {world} ranks: "
                             "the client axis is sharded in equal blocks")
        mine = block(counts, rank, world)
        client = local_epochs(
            model, params, block(cx, rank, world), block(cy, rank, world), mine,
            lambda e: block(orders(e), rank, world),
            lambda e, i: tuple(block(m, rank, world) for m in masks(e, i)),
            lr=lr, batch_size=batch_size, nr_epochs=nr_epochs)
        sums = {n: torch.tensordot(mine, t, dims=1) for n, t in client.items()}
        total = mine.sum().reshape(1)
        comm.all_reduce_sum_([*sums.values(), total])
        return {n: t / total for n, t in sums.items()}

    return fedavg_round


class ClientDraws:
    """One round's row orders and dropout masks for the chosen clients, each
    drawn from that client's own ``generators[k]`` on the generator's device
    and moved to ``device``: :func:`local_epochs`' ``orders`` and ``masks``.
    Each epoch draws its orders (``torch.randperm(count)`` per client) and
    then the masks of its batches, in order."""

    def __init__(self, model, generators: list, counts, max_n: int, batch_size: int, device):
        self.model, self.generators = model, generators
        self.counts = [int(c) for c in counts]
        self.max_n, self.device = max_n, device
        full = batch_size == -1 or batch_size >= max_n
        self.b = max_n if full else batch_size
        self.pad_to = max_n if full else -(-max_n // batch_size) * batch_size

    def orders(self, e: int) -> torch.Tensor:
        rows = []
        for g, c in zip(self.generators, self.counts):
            real = torch.randperm(c, generator=g, device=g.device).to(self.device)
            pads = torch.arange(c, self.max_n, device=self.device)
            fill = torch.zeros(self.pad_to - self.max_n, dtype=torch.long, device=self.device)
            rows.append(torch.cat([real, pads, fill]))
        return torch.stack(rows)

    def masks(self, e: int, i: int) -> tuple:
        per_client = [draw_masks(self.model, self.b, g) for g in self.generators]
        return tuple(torch.stack(ms).to(self.device) for ms in zip(*per_client))


class _HflBase:
    """Shared plumbing: data splitting and stacking on the device, the
    global model, evaluation, :class:`RunResult`.

    ``device`` follows :func:`~ddl25spring_tpu_torch.utils.device.resolve_device`
    (CUDA unless ``"cpu"``; no GPU raises); the clients' generators live on
    ``generator_device`` (default ``device``).  ``model`` defaults to
    :class:`MnistCnn` drawn from ``seed``."""

    def __init__(
        self,
        nr_clients: int,
        client_fraction: float,
        batch_size: int,
        nr_local_epochs: int,
        lr: float,
        iid: bool = True,
        seed: int = 10,
        model=None,
        data: dict | None = None,
        algorithm: str = "",
        stack_clients: bool = True,
        *,
        device=None,
        generator_device=None,
    ):
        self.device = resolve_device(device)
        self.generator_device = (self.device if generator_device is None
                                 else torch.device(generator_device))
        self.n = nr_clients
        self.c = client_fraction
        self.b = batch_size
        self.e = nr_local_epochs
        self.lr = lr
        self.iid = iid
        self.seed = seed
        if model is None:
            model = MnistCnn(generator=torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.data = data or load_mnist()
        self.rng = np.random.default_rng(seed)

        if stack_clients:
            splits = split_indices(self.data["y_train"], self.n, iid, seed)
            cx, cy, self.counts = stack_client_data(
                self.data["x_train"], self.data["y_train"], splits
            )
            self.cx = torch.from_numpy(cx).to(self.device)
            self.cy = torch.from_numpy(cy).long().to(self.device)
            self.counts_dev = torch.from_numpy(self.counts).to(self.device, torch.float32)
        self.x_test = torch.from_numpy(self.data["x_test"]).to(self.device)
        self.y_test = torch.from_numpy(self.data["y_test"]).long().to(self.device)
        self.result = RunResult(algorithm, self.n, self.c, self.b, self.e, lr)

    @property
    def params(self) -> dict:
        """The global weights, ``{name: tensor}`` (the model's parameters,
        detached)."""
        return {n: p.detach() for n, p in self.model.named_parameters()}

    @torch.no_grad()
    def _set_params(self, new: dict) -> None:
        for n, p in self.model.named_parameters():
            p.copy_(new[n])

    @property
    def clients_per_round(self) -> int:
        # round(), not int(): 0.29*100 floats to 28.999... and the reference
        # rounds (hfl_complete.py:278)
        return max(1, round(self.c * self.n))

    def sample_clients(self) -> np.ndarray:
        """Without-replacement client choice per round
        (``hfl_complete.py:278-279``)."""
        return self.rng.choice(self.n, self.clients_per_round, replace=False)

    def _chosen(self, r: int):
        """This round's clients: their shards and counts, selected on the
        device, and their draws."""
        chosen = self.sample_clients()
        idx = torch.as_tensor(chosen, device=self.device)
        gens = [client_round_generator(self.seed, r, int(i), self.generator_device)
                for i in chosen]
        draws = ClientDraws(self.model, gens, self.counts[chosen], self.cx.shape[1], self.b,
                            self.device)
        return (self.cx.index_select(0, idx), self.cy.index_select(0, idx),
                self.counts_dev.index_select(0, idx), draws)

    @torch.no_grad()
    def test_accuracy(self, batch: int = 10_000) -> float:
        """Full test-set accuracy (reference tests on one 10k batch,
        ``hfl_complete.py:172-183``)."""
        correct = 0
        for lo in range(0, len(self.x_test), batch):
            out = self.model(self.x_test[lo:lo + batch])
            correct += int((out.argmax(-1) == self.y_test[lo:lo + batch]).sum())
        return correct / len(self.x_test)

    def round_message_count(self, round_idx: int) -> int:
        return fedavg_message_count(round_idx, self.clients_per_round)

    def _record(self, round_idx: int, wall: float) -> None:
        self.result.wall_time.append(wall)
        self.result.message_count.append(self.round_message_count(round_idx))
        self.result.test_accuracy.append(self.test_accuracy())

    def run(self, nr_rounds: int) -> RunResult:
        for r in range(nr_rounds):
            t0 = time.perf_counter()
            self.round(r)
            _sync(self.device)
            self._record(r, time.perf_counter() - t0)
        return self.result

    def round(self, r: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class CentralizedServer(_HflBase):
    """Non-federated control: epoch training over the full train set
    (parity: ``hfl_complete.py:193-216``; N=C=E fixed to 1).  The train
    split lives on the device; each round's order is ``rng.permutation``,
    drop-last, and its dropout masks come from the round's generator."""

    def __init__(self, lr: float, batch_size: int, seed: int = 10, **kw):
        super().__init__(
            nr_clients=1,
            client_fraction=1.0,
            batch_size=batch_size,
            nr_local_epochs=1,
            lr=lr,
            seed=seed,
            algorithm="Centralized",
            stack_clients=False,  # trains on the full set; no client shards
            **kw,
        )
        self.x_train = torch.from_numpy(self.data["x_train"]).to(self.device)
        self.y_train = torch.from_numpy(self.data["y_train"]).long().to(self.device)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=lr)

    def round_message_count(self, round_idx: int) -> int:
        return 0  # nothing federated is sent (hfl_complete.py:214)

    def round(self, r: int) -> None:
        n = (len(self.x_train) // self.b) * self.b
        order = torch.as_tensor(self.rng.permutation(len(self.x_train))[:n], device=self.device)
        g = client_round_generator(self.seed, r, 0, self.generator_device)
        for lo in range(0, n, self.b):
            idx = order[lo:lo + self.b]
            masks = tuple(m.to(self.device) for m in draw_masks(self.model, self.b, g))
            x = self.x_train[idx]
            loss = nll_loss(self.model(x, masks) if masks else self.model(x), self.y_train[idx])
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()


class FedAvgServer(_HflBase):
    """FedAvg: chosen clients train locally for E epochs, server takes the
    sample-count-weighted average of returned weights
    (parity: ``hfl_complete.py:336-390``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, algorithm="FedAvg", **kw)
        self._round = make_fedavg_round(self.model, self.lr, self.b, self.e)

    def round(self, r: int) -> None:
        cx, cy, counts, draws = self._chosen(r)
        self._set_params(self._round(self.params, cx, cy, counts, draws.orders, draws.masks))


class FedSgdGradientServer(_HflBase):
    """FedSGD: chosen clients return one full-batch gradient; the server
    applies the weighted average via its own SGD step
    (parity: ``hfl_complete.py:233-312``; full batch via ``batch_size=len``
    at ``:235``).  The masks are the first a client draws, as FedAvg's
    first batch's are."""

    def __init__(self, *args, **kw):
        kw.setdefault("batch_size", -1)
        kw.setdefault("nr_local_epochs", 1)
        super().__init__(*args, algorithm="FedSGD", **kw)

    @torch.no_grad()
    def round(self, r: int) -> None:
        cx, cy, counts, draws = self._chosen(r)
        params = self.params
        # mask the tail pad rows so this is each client's exact full-shard
        # gradient (hfl_complete.py:235)
        real = (torch.arange(cx.shape[1], device=self.device) < counts[:, None]).float()
        grads = client_grads(self.model, params, cx, cy, real, draws.masks(0, 0),
                             params_batched=False)
        w = counts / counts.sum()
        self._set_params({n: params[n] - self.lr * torch.tensordot(w, grads[n], dims=1)
                          for n in params})
