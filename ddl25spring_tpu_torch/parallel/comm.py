"""Point-to-point and all-reduce transport between ranks: the counterpart of
the collectives the JAX package leaves to XLA (``lax.ppermute`` between
stages, ``lax.pmean`` over the data axis).

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
and the seconds of its all-reduces (staging included).  A staged exchange
or all-reduce first waits for the card to finish the work queued before it,
outside the clock, so its seconds are transport only; a receive counts the
wait for the peer.  Under NCCL the calls return once the transfer
is queued on the stream, so its seconds are host time only.
"""

from __future__ import annotations

import time

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
               ("bytes_staged", "send_s", "recv_wait_s", "allreduce_s")}
        self.bytes_staged, self.send_s, self.recv_wait_s, self.allreduce_s = 0, 0.0, 0.0, 0.0
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

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()
