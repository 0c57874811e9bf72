"""Transport between ranks, and the differentiable collectives built on it:
the counterpart of the collectives the JAX package leaves to XLA
(``lax.ppermute``, ``lax.psum``/``pmean``, ``lax.all_gather``,
``lax.all_to_all``) and of the transposes JAX derives for them.

Under NCCL (every rank on a card of its own) tensors go as they are, the
point-to-point ones through ``batch_isend_irecv``.  Under gloo, which takes
CPU tensors only, a CUDA tensor is staged through a pinned host buffer per
shape, dtype and slot (the place of an operation in its exchange), reused
from call to call: copy to the host, send or all-reduce there, copy back to
the card.  Point-to-point traffic goes in exchanges (:meth:`Comm.send_recv`):
every send and receive of one is posted before any is waited on.  That staging is the transport of a
one-card run, not a way around the card; every byte it moves is counted.

A :class:`Comm` counts, until :meth:`Comm.take_stats` resets them, the bytes
it staged through the host, the seconds it spent posting sends (and waiting
for an exchange that only sends) and waiting for exchanges that receive,
the seconds of its all-reduces and those of its all-gathers,
reduce-scatters and all-to-alls (``collective_s``), staging included.  A
staged exchange or all-reduce first waits for the card to finish the work queued before it,
outside the clock, so its seconds are transport only; a receive counts the
wait for the peer.  Under NCCL the calls return once the transfer
is queued on the stream, so its seconds are host time only.

Differentiable collectives over one :class:`Axis` of the rank grid, each a
``torch.autograd.Function`` whose backward is the transpose JAX derives
inside ``shard_map``:

- :func:`ring_pass` (``lax.ppermute`` to the next index, ``n - 1`` times):
  every hop sends to ``(i + 1) % n`` and receives from ``(i - 1) % n`` in one
  exchange; the backward runs the hops in reverse, each the reverse shift;
- :func:`all_to_all` (``lax.all_to_all(split_axis=a, concat_axis=b,
  tiled=True)``), whose backward is the all-to-all with ``a`` and ``b``
  swapped;
- :func:`copy_in` (identity forward, all-reduce-sum backward) and
  :func:`reduce_out` (all-reduce-sum forward, identity backward): Megatron's
  ``f`` and ``g``.  A replicated value entering a rank-local product goes
  through ``copy_in``, a sum of rank-local partial products through
  ``reduce_out``: under JAX's VMA typing the first is the implicit ``pcast``
  to varying, whose transpose is a ``psum``, the second the ``psum``;
- :func:`all_gather` of a value every rank then uses identically (the loss
  is replicated over the axis): its backward is this rank's own slot of the
  cotangent, not a sum over the ranks, which would count the loss ``n``
  times;
- :func:`gather_rows` (``lax.all_gather(tiled=True)`` of ZeRO's ``[1, K]``
  rows into ``[n, K]``), whose backward is the reduce-scatter SUM of the
  cotangent into this rank's row: each rank's loss differs, and every rank's
  gradient of the gathered value counts.  It can finish a gather that
  :meth:`Comm.start_all_gather` issued earlier, which is how ZeRO's LLaMA
  step prefetches the next layer.

A collective's backward runs only if autograd reaches it, and every rank
of the axis must run it, in the same order.  :func:`ring_pass` is therefore
one node for all ``n - 1`` hops: a block that a rank receives but does not
use still has its cotangent (zeros) passed on, where a chain of one node
per hop would let autograd prune that rank's unused hops and leave its
peers waiting.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ddl25spring_tpu_torch.parallel.bucketing import BucketPlan, parts


class Comm:
    """One rank's transport over ``backend`` for tensors on ``device``."""

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        self.device = torch.device(device)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self._host: dict[tuple, torch.Tensor] = {}
        self.take_stats()

    def take_stats(self) -> dict:
        """The counts since the last call, which sets them to 0."""
        out = {k: getattr(self, k, 0) for k in
               ("bytes_staged", "send_s", "recv_wait_s", "allreduce_s", "collective_s")}
        self.bytes_staged = 0
        self.send_s = self.recv_wait_s = self.allreduce_s = self.collective_s = 0.0
        return out

    def _buffer(self, shape, dtype, slot=None) -> torch.Tensor:
        """The pinned host buffer of ``shape``/``dtype`` for ``slot``: the
        operations of one exchange, or the buckets of one overlapped
        all-reduce, are in flight together and each needs its own."""
        key = (tuple(shape), dtype, slot)
        if key not in self._host:
            self._host[key] = torch.empty(key[0], dtype=dtype, pin_memory=True)
        return self._host[key]

    def _to_host(self, t: torch.Tensor, slot=None) -> torch.Tensor:
        buf = self._buffer(t.shape, t.dtype, slot)
        buf.copy_(t)  # waits for the card to finish t
        self.bytes_staged += t.nbytes
        return buf

    def _from_host(self, buf: torch.Tensor, out: torch.Tensor):
        out.copy_(buf)  # synchronous, so the buffer can be reused at once
        self.bytes_staged += buf.nbytes

    def _settle(self):
        """Let the card finish the work queued so far (staged transport only,
        which waits for it anyway), so the clock that starts next counts
        transport and not compute."""
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()

    def send_recv(self, sends=(), recvs=()) -> list[torch.Tensor]:
        """One exchange: post every send ``(tensor, dst, tag)`` and every
        receive ``(shape, dtype, src, tag)`` before waiting on any, then wait
        for all of them; returns the received tensors, in order, on this
        rank's device.  A send and a receive between the same two ranks in
        opposite directions must go in one exchange: posted one after the
        other, two blocking sends can wait for each other for ever.

        The wait counts as ``recv_wait_s`` when the exchange receives, else
        as ``send_s``, which also counts the posting."""
        self._settle()
        t0 = time.perf_counter()
        outs = [torch.empty(shape, dtype=dtype, device=self.device)
                for shape, dtype, _, _ in recvs]
        sends = [(t.detach().contiguous(), dst, tag) for t, dst, tag in sends]
        if self.backend == "nccl":
            ops = ([dist.P2POp(dist.isend, t, dst, tag=tag) for t, dst, tag in sends]
                   + [dist.P2POp(dist.irecv, out, src, tag=tag)
                      for out, (_, _, src, tag) in zip(outs, recvs)])
            reqs = dist.batch_isend_irecv(ops) if ops else []
            bufs = outs
        else:
            if self.staged:
                sends = [(self._to_host(t, ("send", i)), dst, tag)
                         for i, (t, dst, tag) in enumerate(sends)]
                bufs = [self._buffer(out.shape, out.dtype, ("recv", i))
                        for i, out in enumerate(outs)]
            else:
                bufs = outs
            reqs = ([dist.isend(t, dst, tag=tag) for t, dst, tag in sends]
                    + [dist.irecv(buf, src, tag=tag)
                       for buf, (_, _, src, tag) in zip(bufs, recvs)])
        t1 = time.perf_counter()
        for req in reqs:
            req.wait()
        if self.staged:
            for buf, out in zip(bufs, outs):
                self._from_host(buf, out)
        t2 = time.perf_counter()
        self.send_s += t1 - t0
        if recvs:
            self.recv_wait_s += t2 - t1
        else:
            self.send_s += t2 - t1
        return outs

    def send(self, t: torch.Tensor, dst: int, tag: int):
        """Send ``t`` to rank ``dst``; returns when ``t`` may be reused."""
        self.send_recv(sends=[(t, dst, tag)])

    def recv(self, shape, dtype: torch.dtype, src: int, tag: int) -> torch.Tensor:
        """Receive a ``shape``/``dtype`` tensor from rank ``src`` onto this
        rank's device."""
        return self.send_recv(recvs=[(shape, dtype, src, tag)])[0]

    def all_reduce_mean_(self, tensors, group=None):
        """Each tensor, in place, becomes the mean over ``group``: the
        all-reduce SUM, then a division by the group's size (the reference's
        own arithmetic, ``intro_DP_GA.py:63-66``)."""
        self._all_reduce_(tensors, group, mean=True)

    def all_reduce_sum_(self, tensors, group=None):
        """Each tensor, in place, becomes its sum over ``group``."""
        self._all_reduce_(tensors, group, mean=False)

    def _all_reduce_(self, tensors, group, mean: bool):
        self._settle()
        t0 = time.perf_counter()
        n = dist.get_world_size(group)
        for t in tensors:
            if self.staged:
                buf = self._to_host(t)
                dist.all_reduce(buf, group=group)
                self._from_host(buf, t)
            else:
                dist.all_reduce(t, group=group)
            if mean:
                t.div_(n)
        self.allreduce_s += time.perf_counter() - t0

    def bucketed_all_reduce_mean_(self, leaves, group=None, plan: BucketPlan | None = None):
        """:meth:`all_reduce_mean_` of every leaf (see
        :mod:`~ddl25spring_tpu_torch.parallel.bucketing` for leaves), one
        all-reduce per flat bucket of ``plan``, or per tensor when ``plan`` is
        None.  The mean is elementwise, so both give the same values."""
        if plan is None:
            self.all_reduce_mean_([t for leaf in leaves for t in parts(leaf)], group)
            return
        bufs = plan.pack(leaves)
        self.all_reduce_mean_(bufs, group)
        plan.unpack_into(bufs, leaves)

    def start_all_reduce_mean_(self, t: torch.Tensor, group=None, slot=None):
        """Issue the all-reduce SUM of ``t`` without waiting for it (``slot``
        names its host buffer on the staged path, where the copy to the host
        waits for the card).  Returns ``finish()``, which waits, copies the
        sum back into ``t`` (staged) and divides it by the group's size: after
        it ``t`` holds the mean over ``group``, as :meth:`all_reduce_mean_`
        leaves it.  Both halves count in ``allreduce_s``."""
        t0 = time.perf_counter()
        buf = self._to_host(t, ("allreduce", slot)) if self.staged else t
        work = dist.all_reduce(buf, group=group, async_op=True)
        self.allreduce_s += time.perf_counter() - t0

        def finish():
            t1 = time.perf_counter()
            work.wait()
            if self.staged:
                self._from_host(buf, t)
            t.div_(dist.get_world_size(group))
            self.allreduce_s += time.perf_counter() - t1

        return finish

    def all_gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """``[n, *t.shape]``: slot ``j`` holds ``t`` of the group's rank ``j``."""
        return self.start_all_gather(t, group)()

    def start_all_gather(self, t: torch.Tensor, group, slot=None):
        """Issue :meth:`all_gather` of ``t`` without waiting for it (``slot``
        names its host buffers on the staged path, where the copy to the host
        waits for the card).  Returns ``finish()``, which waits and returns
        the ``[n, *t.shape]`` result on this rank's device.  Both halves
        count in ``collective_s``."""
        n = dist.get_world_size(group)
        self._settle()
        t0 = time.perf_counter()
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=self.device)
        if self.staged:
            buf = self._buffer(out.shape, out.dtype, ("gather", slot))
            work = dist.all_gather(list(buf.unbind(0)),
                                   self._to_host(t.contiguous(), ("gather in", slot)),
                                   group=group, async_op=True)
        else:
            work = dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group,
                                   async_op=True)
        self.collective_s += time.perf_counter() - t0

        def finish() -> torch.Tensor:
            t1 = time.perf_counter()
            work.wait()
            if self.staged:
                self._from_host(buf, out)
            self.collective_s += time.perf_counter() - t1
            return out

        return finish

    def reduce_scatter(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` is ``[n, ...]``: slot ``j`` of every rank's ``t`` is summed
        into the group's rank ``j``; returns this rank's sum, ``t.shape[1:]``
        (``lax.psum_scatter(scatter_dimension=0, tiled=True)`` of ``n`` rows).
        Staged, the whole ``t`` goes to the host and this rank's slot comes
        back."""
        self._settle()
        t0 = time.perf_counter()
        # flat: gloo takes the input as the outputs concatenated along dim 0
        flat = t.contiguous().view(-1)
        out = torch.empty(flat.numel() // t.shape[0], dtype=t.dtype, device=self.device)
        if self.staged:
            buf = self._buffer(out.shape, out.dtype, "scatter")
            dist.reduce_scatter_tensor(buf, self._to_host(flat), group=group)
            self._from_host(buf, out)
        else:
            dist.reduce_scatter_tensor(out, flat, group=group)
        self.collective_s += time.perf_counter() - t0
        return out.view(t.shape[1:])

    def all_to_all(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` is ``[n, ...]``: slot ``j`` goes to the group's rank ``j``, and
        slot ``j`` of the result is what rank ``j`` sent this rank."""
        self._settle()
        t0 = time.perf_counter()
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
        if self.staged:
            buf = self._buffer(t.shape, t.dtype, "a2a")
            dist.all_to_all_single(buf, self._to_host(t.contiguous()), group=group)
            self._from_host(buf, out)
        else:
            dist.all_to_all_single(out, t.contiguous(), group=group)
        self.collective_s += time.perf_counter() - t0
        return out

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


@dataclass(frozen=True)
class Axis:
    """One axis of the rank grid as a rank sees it (from
    :meth:`~ddl25spring_tpu_torch.utils.mesh.Mesh.axis`): its name, the
    :class:`Comm`, the process group of the rank's line along the axis, the
    global ranks of that line in index order, and the rank's index on it."""

    name: str
    comm: Comm
    group: object
    ranks: tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def shift(self, tensors, step: int = 1) -> list[torch.Tensor]:
        """Every index ``i`` sends ``tensors`` to index ``(i + step) % n`` and
        receives from ``(i - step) % n``, in one exchange; returns what it
        received.  Not differentiable: :func:`ring_pass` is."""
        n, i = self.size, self.index
        if n == 1:
            return list(tensors)
        dst, src = self.ranks[(i + step) % n], self.ranks[(i - step) % n]
        return self.comm.send_recv(
            sends=[(t, dst, j) for j, t in enumerate(tensors)],
            recvs=[(t.shape, t.dtype, src, j) for j, t in enumerate(tensors)])


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        ctx.diff = [x.is_floating_point() for x in xs]
        hops = [list(xs)]
        for _ in range(axis.size - 1):
            hops.append(axis.shift(hops[-1]))
        outs = [torch.stack(blocks) for blocks in zip(*hops)]
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, ctx.diff) if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g for g, d in zip(gs, ctx.diff) if d]
        # hop t's cotangent goes back to the index it came from, t hops
        # behind: accumulate from the last hop, one reverse shift per hop
        acc = [g[-1] for g in gs]
        for t in range(ctx.axis.size - 1, 0, -1):
            acc = [g[t - 1] + a for g, a in zip(gs, ctx.axis.shift(acc, step=-1))]
        it = iter(acc)
        return (None, *[next(it) if d else None for d in ctx.diff])


def ring_pass(axis: Axis, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """For each ``x``, ``[n, *x.shape]``: slot ``t`` holds the ``x`` of index
    ``(i - t) % n``, received after ``t`` hops of the ring (slot 0 is this
    rank's own).  The ``n - 1`` hops each move every ``x`` together, in one
    exchange (:meth:`Axis.shift`).  Differentiable in the floating-point
    ``x``; integer ones (positions) travel along without a cotangent.

    Every rank of the axis must use some output (slot 0 will do), so that
    autograd runs the backward's hops on every rank: a rank that uses none
    would leave the others waiting on it."""
    return _RingPass.apply(axis, *xs)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _all_to_all(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis, ctx.concat, ctx.split), None, None, None


def _all_to_all(x, axis, split, concat):
    n = axis.size
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split over {n} ranks")
    slots = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    got = axis.comm.all_to_all(slots.contiguous(), axis.group)
    return got.movedim(0, concat).flatten(concat, concat + 1)


def all_to_all(x: torch.Tensor, axis: Axis, split: int, concat: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat, tiled=True)``:
    dim ``split`` is cut into ``n`` slices, slice ``j`` goes to index ``j``,
    and the slices received are joined along dim ``concat`` in index order."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split, concat)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.axis.comm.all_reduce_sum_([g], ctx.axis.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = x.contiguous().clone()
        axis.comm.all_reduce_sum_([y], axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over the axis."""
    return x if axis.size == 1 else _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the axis forward; identity backward."""
    return x if axis.size == 1 else _ReduceOut.apply(x, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.index = axis.index
        return axis.comm.all_gather(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[n, *x.shape]``, slot ``j`` from index ``j``; for a value every rank of
    the axis then uses identically (its backward takes this rank's slot)."""
    return x[None] if axis.size == 1 else _AllGather.apply(x, axis)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, axis, pending):
        ctx.axis = axis
        if pending is not None:
            return pending()
        return axis.comm.all_gather(row.reshape(-1), axis.group)

    @staticmethod
    def backward(ctx, g):
        row = ctx.axis.comm.reduce_scatter(g.contiguous(), ctx.axis.group)
        return row.view(1, -1), None, None


def gather_rows(row: torch.Tensor, axis: Axis, pending=None) -> torch.Tensor:
    """``[n, K]`` from this rank's ``[1, K]`` ``row``: slot ``j`` is index
    ``j``'s row (``lax.all_gather(tiled=True)``).  The backward reduce-scatters
    the SUM of the ``[n, K]`` cotangent over the axis into this rank's row,
    the transpose JAX derives, so every rank's gradient of what it gathered
    reaches the rank that holds the row.  ``pending``, the ``finish`` of a
    :meth:`Comm.start_all_gather` of ``row`` issued earlier, supplies the
    result instead of a new gather."""
    return _GatherRows.apply(row, axis, pending)
