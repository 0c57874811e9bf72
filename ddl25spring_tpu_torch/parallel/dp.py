"""Training steps, the counterpart of the JAX package's ``parallel/dp.py``.

The single-device step, and the two data-parallel steps of the reference
course: gradient aggregation (``intro_DP_GA.py:53-66``: backward, all-reduce
SUM of the gradients, divide by the world size, step) and weight aggregation
(local step, then the mean of the weights; the reference's ``intro_DP_WA.py``
is a silent no-op, and this implements its intent as the JAX package does).

The JAX package runs DP as one SPMD program over a mesh ``data`` axis.  The
port runs one process per replica (:mod:`~ddl25spring_tpu_torch.utils.mesh`)
and reduces over the DP group with :class:`~ddl25spring_tpu_torch.parallel.
comm.Comm`: one all-reduce per flat bucket of gradients
(:mod:`~ddl25spring_tpu_torch.parallel.bucketing`), or one per tensor with
``bucket_bytes=None``.  Each step takes the GLOBAL batch, as the JAX step
does, and replica ``d`` of ``D`` takes rows ``[d * B/D, (d+1) * B/D)`` of
every tensor in it, as the JAX step's ``P(data)`` spec hands them out.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ddl25spring_tpu_torch import obs
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.parallel import bucketing
from ddl25spring_tpu_torch.parallel.bucketing import flatten, parts, plan_buckets

# loss_fn(model, batch) -> scalar tensor
LossFn = Callable[[nn.Module, Any], torch.Tensor]


def make_train_step(model: nn.Module, loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    sentinel: bool | None = None):
    """Single-device train step (parity: the centralized loop of
    ``lab/tutorial_1b/primer/intro.py:23-33``): forward, loss, ``backward()``,
    optimizer step.  ``step(batch)`` updates ``model`` in place and returns the
    loss, detached.

    ``sentinel`` (None = follow ``DDL25_SENTINELS`` when the step is built):
    the in-step numerics sentinels, strategy ``"serial"``
    (:mod:`ddl25spring_tpu_torch.obs.sentinels`); the guard is ``step.guard``,
    which :func:`~ddl25spring_tpu_torch.parallel.pipeline.fuse_train_steps`
    drives inside its graph."""
    s_on, s_policy = sentinels.resolve(sentinel)
    guard = (sentinels.Guard("serial", sentinels.named_leaves(model), optimizer,
                             policy=s_policy) if s_on else None)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        if guard is None:
            optimizer.step()
            return loss.detach()
        guard.begin()
        optimizer.step()
        loss = loss.detach()
        guard.end(loss)
        return loss

    step.guard = guard
    return step


def param_leaves(model: nn.Module) -> list:
    """``model``'s parameters as bucketing leaves: in the JAX pytree's flatten
    order when the model has a ``param_tree()`` (so both packages plan the same
    buckets), else in registration order."""
    if hasattr(model, "param_tree"):
        return [leaf for _, leaf in flatten(model.param_tree())]
    return list(model.parameters())


def grad_leaves(leaves: list) -> list:
    """The ``.grad`` of every parameter of ``leaves``, in the same structure."""
    return [leaf.grad if isinstance(leaf, torch.Tensor) else [p.grad for p in leaf]
            for leaf in leaves]


def shard_rows(batch, d: int, n: int, device):
    """Rows ``[d * B/n, (d+1) * B/n)`` of every tensor in ``batch`` (a tensor, or
    a tuple, list or dict of them), moved to ``device``."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, d, n, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_rows(v, d, n, device) for v in batch)
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split over {n} replicas")
    return batch[d * (B // n):(d + 1) * (B // n)].to(device)


def group_guard(strategy: str, s_on: bool, s_policy: str, leaves, optimizer, axis, *,
                weights=None, loss_weight: float = 1.0):
    """The sentinel of a step whose facts are summed over ``axis`` (a
    :class:`~ddl25spring_tpu_torch.parallel.comm.Axis`; its index 0
    records), or None when the sentinel is off."""
    if not s_on:
        return None
    return sentinels.Guard(strategy, leaves, optimizer, policy=s_policy,
                           weights=weights, loss_weight=loss_weight,
                           group=axis.group if axis.size > 1 else None, comm=axis.comm,
                           record=axis.index == 0)


def grad_norm(leaves) -> torch.Tensor:
    """The global norm of the gradients of ``leaves`` (a 0-dim tensor)."""
    grads = [g for leaf in grad_leaves(leaves) for g in parts(leaf) if g is not None]
    norms = torch.stack(torch._foreach_norm(grads)).float()
    return (norms * norms).sum().sqrt()


class _Overlap:
    """The overlapped reduction of :func:`make_dp_train_step`: a
    post-accumulate-grad hook on every parameter counts the gradients of
    its bucket, and the last one to arrive issues the bucket's reduction,
    ``issue(b) -> finish``, while the backward goes on with the layers
    before; a bucket that completes before a lower-numbered one waits for
    it, so every replica issues them in the same order.  DP's ``issue``
    (:func:`_all_reduce_issue`) packs the bucket and starts its all-reduce
    without waiting; ZeRO-2's reduce-scatters it into this rank's rows.
    ``log`` records, per step, ``("grad", leaf)`` as each leaf's last tensor
    gets its gradient and ``("issue", bucket)`` as each bucket's reduction
    is issued."""

    def __init__(self, leaves, plan, issue):
        self.leaves, self.plan, self.issue = leaves, plan, issue
        self.armed = False
        self.log: list[tuple[str, int]] = []
        self._bucket = {i: b for b, idxs in enumerate(plan.buckets) for i in idxs}
        self._need = [len(idxs) for idxs in plan.buckets]
        for i, leaf in enumerate(leaves):
            for p in parts(leaf):
                p.register_post_accumulate_grad_hook(lambda p, i=i: self._arrived(i))

    def start(self):
        self.armed, self.log = True, []
        self._parts = [0] * len(self.leaves)
        self._have = [0] * self.plan.n_buckets
        self._issued: list = []

    def _arrived(self, i: int):
        if not self.armed:
            return
        self._parts[i] += 1
        if self._parts[i] < len(parts(self.leaves[i])):
            return
        self.log.append(("grad", i))
        self._have[self._bucket[i]] += 1
        self._issue_ready()

    def _issue_ready(self, everything: bool = False):
        # buckets go out in index order on every replica, whatever order
        # their gradients complete in: the collectives of a group are
        # matched by their order
        while len(self._issued) < self.plan.n_buckets:
            b = len(self._issued)
            if not everything and self._have[b] < self._need[b]:
                return
            self.log.append(("issue", b))
            self._issued.append(self.issue(b))

    def finish(self):
        """Issue what the backward left (a bucket some of whose gradients came
        from no hook), then finish every bucket, in order."""
        self.armed = False
        self._issue_ready(everything=True)
        for done in self._issued:
            done()


def _all_reduce_issue(leaves, plan, comm, group):
    """DP's ``issue`` for :class:`_Overlap`: pack bucket ``b``'s gradients and
    start their all-reduce (``Comm.start_all_reduce_mean_``); its ``finish``
    waits and writes the means back into ``.grad``."""

    def issue(b):
        buf = plan.pack_bucket(b, grad_leaves(leaves))
        done = comm.start_all_reduce_mean_(buf, group, slot=b)

        def finish():
            done()
            plan.unpack_bucket_into(b, buf, grad_leaves(leaves))

        return finish

    return issue


def make_dp_train_step(model: nn.Module, loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                       mesh, bucket_bytes=bucketing.AUTO, overlap: bool = False,
                       instrument: bool | None = None, sentinel: bool | None = None):
    """Gradient-aggregation DP over ``mesh``'s DP group (the JAX package's
    ``make_dp_train_step``, ``parallel/dp.py:78``).

    ``step(batch)`` takes the global batch, computes this replica's loss and
    gradients on its rows, replaces each gradient by its mean over the
    replicas, steps ``optimizer`` and returns the loss's mean over the
    replicas.  ``bucket_bytes`` (default :data:`~ddl25spring_tpu_torch.
    parallel.bucketing.AUTO`: ``DDL25_BUCKET_BYTES``, 4 MiB when unset)
    launches one all-reduce per flat bucket; ``None``/``0``, one per tensor.
    The mean is elementwise, so both give the same gradients.

    ``overlap=True`` (needs buckets; without a threshold it raises
    ``ValueError``, as the JAX step does) plans the buckets in backward
    order (``plan_buckets(order="backward")``: bucket 0 holds the last
    layers) and issues each bucket's all-reduce from the backward itself, as
    soon as the last of its gradients is accumulated
    (``register_post_accumulate_grad_hook``), so the reduction of the last
    layers runs while the earlier layers still back-propagate; every handle
    is waited on, and the mean unpacked into ``.grad``, before
    ``optimizer.step()``.  The same sums reach the same gradients, so the
    step equals the synchronous one.  ``step.log`` holds the last step's
    hook log (:class:`_Overlap`).  On the staged transport (gloo over a
    card's tensors) the hook's copy to the pinned host buffer waits for the
    card, so the backward stalls at each bucket and the overlap buys little
    there; under NCCL the all-reduce is queued on its own stream.

    ``instrument`` (None = follow the :mod:`~ddl25spring_tpu_torch.obs` flag
    when the step is built): the counters ``dp.loss`` and ``dp.grad_norm``
    (the replicas' mean loss, the averaged gradients' global norm), copied
    from the card without a sync.  ``sentinel`` (None = follow
    ``DDL25_SENTINELS`` when the step is built): the in-step numerics
    sentinels, strategy ``"dp"`` (``"dp-overlap"``); the averaged gradients
    are the same on every replica, so each replica computes the facts alone
    and the first records them.  Both come after the step's own
    reductions and add no hook, so the overlapped step issues its buckets
    as without them.  Disabled, the step runs the operations of one built
    without them."""
    instr = obs.enabled() if instrument is None else bool(instrument)
    s_on, s_policy = sentinels.resolve(sentinel)
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    if overlap and not bb:
        raise ValueError("overlap=True needs the bucketed path; pass a bucket_bytes "
                         "threshold (or leave the AUTO default)")
    leaves = param_leaves(model)
    plan = plan_buckets(leaves, bb, order="backward" if overlap else "forward") if bb else None
    d, comm = mesh.coords[0], mesh.comm
    hooks = (_Overlap(leaves, plan, _all_reduce_issue(leaves, plan, comm, mesh.dp_group))
             if overlap else None)
    guard = (sentinels.Guard("dp-overlap" if overlap else "dp", sentinels.named_leaves(model),
                             optimizer, policy=s_policy, record=d == 0) if s_on else None)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, shard_rows(batch, d, mesh.grid.data, mesh.device))
        if hooks is None:
            loss.backward()
            comm.bucketed_all_reduce_mean_(grad_leaves(leaves), mesh.dp_group, plan)
        else:
            hooks.start()
            loss.backward()
            hooks.finish()
            step.log = list(hooks.log)
        if guard is not None:
            guard.begin()
        optimizer.step()
        loss = loss.detach().clone()
        comm.all_reduce_mean_([loss], mesh.dp_group)
        if instr:
            obs.counters.emit_many({"dp.loss": loss, "dp.grad_norm": grad_norm(leaves)},
                                   force=True)
        if guard is not None:
            guard.end(loss)
        return loss

    step.log = []
    step.guard = guard
    return step


def make_dp_weight_avg_step(model: nn.Module, loss_fn: LossFn,
                            optimizer: torch.optim.Optimizer, mesh,
                            bucket_bytes=bucketing.AUTO, sentinel: bool | None = None):
    """Weight-aggregation DP (the JAX package's ``make_dp_weight_avg_step``,
    ``parallel/dp.py:226``): each replica steps on its own gradients with its
    own optimizer state, then every parameter becomes its mean over the
    replicas (every step, the reference scripts' cadence).  Returns the
    loss's mean over the replicas.  ``bucket_bytes`` as in
    :func:`make_dp_train_step`.

    ``sentinel``: the in-step numerics sentinels, strategy
    ``"dp-weight-avg"``, over each replica's own gradients and updates (the
    updates before the average), their squared norms summed over the DP
    group (JAX's ``axis=``); ``skip`` puts back the parameters and optimizer
    state of before the step on every replica."""
    s_on, s_policy = sentinels.resolve(sentinel)
    bb = bucketing.resolve_bucket_bytes(bucket_bytes)
    leaves = param_leaves(model)
    plan = plan_buckets(leaves, bb) if bb else None
    # detached views share the parameters' storage, so the in-place mean
    # updates the parameters outside autograd
    weights = [leaf.detach() if isinstance(leaf, torch.Tensor) else [p.detach() for p in leaf]
               for leaf in leaves]
    d, comm = mesh.coords[0], mesh.comm
    data = mesh.axis("data")
    guard = group_guard("dp-weight-avg", s_on, s_policy, sentinels.named_leaves(model),
                        optimizer, data, loss_weight=1.0 / data.size)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, shard_rows(batch, d, mesh.grid.data, mesh.device))
        loss.backward()
        if guard is not None:
            guard.begin()
        optimizer.step()
        if guard is not None:
            updates = guard.updates()
        comm.bucketed_all_reduce_mean_(weights, mesh.dp_group, plan)
        loss = loss.detach().clone()
        if guard is not None:
            guard.end(loss, updates)
        comm.all_reduce_mean_([loss], mesh.dp_group)
        return loss

    step.guard = guard
    return step


class TinyMlp(nn.Module):
    """The JAX package's tiny MLP workload (``_tiny_mlp_workload``,
    ``parallel/dp.py:327``): ``tanh(x @ w1 + b1) @ w2``, with ``w1 [16, 32]``,
    ``b1 [32]``, ``w2 [32, 4]`` (zeros, as there; callers load weights), and
    the rule tables' names (``param_tree()``: ``b1``, ``w1``, ``w2``)."""

    def __init__(self, d_in: int = 16, d_h: int = 32, d_out: int = 4, device="cpu"):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(d_in, d_h, device=device))
        self.b1 = nn.Parameter(torch.zeros(d_h, device=device))
        self.w2 = nn.Parameter(torch.zeros(d_h, d_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2

    def param_tree(self) -> dict:
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2}


def tiny_mlp_loss(model: TinyMlp, batch) -> torch.Tensor:
    """The tiny MLP's loss: the mean squared error of ``model(x)`` to ``y``."""
    x, y = batch
    return ((model(x) - y) ** 2).mean()



# the describes' bucket threshold: JAX's (parallel/dp.py:324), a plan of
# several buckets over the tiny MLP's 2,688 bytes, and never the env knob,
# so a signature does not drift with DDL25_BUCKET_BYTES
DESCRIBE_BUCKET_BYTES = 560


def tiny_mlp_workload(mesh, axis: str = "data", params: dict | None = None):
    """The describes' tiny MLP on ``mesh.device`` (JAX ``_tiny_mlp_workload``,
    ``parallel/dp.py:327``): ``w1 [16, 32]``, ``b1 [32]``, ``w2 [32, 4]``
    from ``params`` (numpy, e.g. JAX's) or seeded normal draws, and a seeded
    global batch of ``8 n`` rows.  Returns ``(model, loss_fn, batch,
    param_bytes)``."""
    import numpy as np

    n = mesh.axis(axis).size
    rng = np.random.default_rng(0)
    model = TinyMlp(device=mesh.device)
    with torch.no_grad():
        for name, p in model.param_tree().items():
            src = params[name] if params is not None else \
                rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.3
            p.copy_(torch.as_tensor(np.asarray(src)))
    batch = (torch.from_numpy(rng.standard_normal((8 * n, 16)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((8 * n, 4)).astype(np.float32)))
    param_bytes = sum(p.nbytes for p in model.parameters())
    return model, tiny_mlp_loss, batch, param_bytes


def tiny_llama(mesh, n_layers: int, params: dict | None = None):
    """The describes' tiny LLaMA on ``mesh.device`` (JAX's: vocab 64, dmodel
    16, 2 heads, ctx 16, float32; attention through the flash kernels on the
    card): ``(cfg, model)``, the weights from ``params`` (JAX's numpy
    pytree) or drawn from seed 0."""
    from ddl25spring_tpu_torch.models import llama
    from ddl25spring_tpu_torch.utils.config import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, dmodel=16, num_heads=2, n_layers=n_layers, ctx_size=16,
                      dtype="float32", use_flash=mesh.device.type == "cuda")
    model = llama.Llama(cfg, device=mesh.device, generator=torch.Generator().manual_seed(0))
    if params is not None:
        llama.load_jax_params(model, params)
    return cfg, model


def tiny_tokens(rows: int, cfg):
    """A seeded ``[rows, ctx]`` int64 token batch for the tiny LLaMA."""
    import numpy as np

    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, cfg.ctx_size)))


def describe(mesh, axis: str = "data", bucketed: bool = True, overlap: bool = False,
             bucket_bytes: int | None = None, params: dict | None = None):
    """The ``describe()`` of ``dp`` and ``dp-overlap`` (JAX ``parallel/dp.py:355``):
    one DP step of the tiny MLP, its inputs and its collective signature, for
    :mod:`~ddl25spring_tpu_torch.obs.comm_analytics`.

    Signature, from what :func:`make_dp_train_step` issues: one all-reduce per
    gradient bucket of the :data:`DESCRIBE_BUCKET_BYTES` plan (the gradients'
    bytes in all) and one of the 4-byte loss, all over ``axis``; no other
    kind.  ``overlap=True`` issues the same buckets from the backward.

    Where JAX's compiled inventory differs (``meta["differs_from_jax"]``):
    all-reduce, count: XLA's combiner fuses the bucket all-reduces and the
    loss mean into one op (JAX: 1 op of 2,692 B; the port: ``n_buckets +
    1`` ops of the same 2,692 B)."""
    if overlap and not bucketed:
        raise ValueError("overlap describes the bucketed DP path only")

    model, loss_fn, batch, param_bytes = tiny_mlp_workload(mesh, axis, params)
    bb = (bucket_bytes or DESCRIBE_BUCKET_BYTES) if bucketed else None
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_dp_train_step(model, loss_fn, opt, mesh, bucket_bytes=bb, overlap=overlap,
                              instrument=False, sentinel=False)
    leaves = param_leaves(model)
    n_buckets = (plan_buckets(leaves, bb, order="backward" if overlap else "forward").n_buckets
                 if bucketed else len(leaves))
    expected = {
        "scalar_bytes": 64,
        "all-reduce": {"min_bytes": param_bytes, "max_bytes": param_bytes + 256,
                       "axes": [axis], "count": n_buckets + 1},
        "forbidden": ["all-gather", "reduce-scatter", "collective-permute", "all-to-all"],
    }
    return {
        "fn": step, "args": (batch,), "lowered": "train_step",
        "meta": {"param_bytes": param_bytes, "grad_bytes": param_bytes,
                 "n_param_leaves": len(leaves),
                 **({"n_buckets": n_buckets, "bucket_bytes": bb} if bucketed else {}),
                 **({"overlap": True} if overlap else {}),
                 "differs_from_jax": {"all-reduce": ("count",)}},
        "expected": expected,
    }
