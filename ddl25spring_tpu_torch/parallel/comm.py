"""Point-to-point and all-reduce transport between ranks: the counterpart of
the collectives the JAX package leaves to XLA (``lax.ppermute`` between
stages, ``lax.pmean`` over the data axis).

Under NCCL (every rank on a card of its own) tensors go as they are, the
point-to-point ones through ``batch_isend_irecv``.  Under gloo, which takes
CPU tensors only, a CUDA tensor is staged through one pinned host buffer per
shape and dtype, reused from call to call: copy to the host, send or
all-reduce there, copy back to the card.  That staging is the transport of a
one-card run, not a way around the card; every byte it moves is counted.

A :class:`Comm` counts, until :meth:`Comm.take_stats` resets them, the bytes
it staged through the host, the seconds it spent in ``send`` and waiting in
``recv``, and the seconds of its all-reduces (staging included).  A staged
``send`` or all-reduce first waits for the card to finish the work queued
before it, outside the clock, so its seconds are transport only; a ``recv``
counts the wait for the peer.  Under NCCL the calls return once the transfer
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

    def _buffer(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        if key not in self._host:
            self._host[key] = torch.empty(key[0], dtype=dtype, pin_memory=True)
        return self._host[key]

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffer(t.shape, t.dtype)
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

    def send(self, t: torch.Tensor, dst: int, tag: int):
        """Send ``t`` to rank ``dst``; returns when ``t`` may be reused."""
        self._settle()
        t0 = time.perf_counter()
        t = t.detach().contiguous()
        if self.staged:
            dist.send(self._to_host(t), dst, tag=tag)
        elif self.backend == "nccl":
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, tag=tag)]):
                req.wait()
        else:
            dist.send(t, dst, tag=tag)
        self.send_s += time.perf_counter() - t0

    def recv(self, shape, dtype: torch.dtype, src: int, tag: int) -> torch.Tensor:
        """Receive a ``shape``/``dtype`` tensor from rank ``src`` onto this
        rank's device."""
        t0 = time.perf_counter()
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if self.staged:
            buf = self._buffer(shape, dtype)
            dist.recv(buf, src, tag=tag)
            self._from_host(buf, out)
        elif self.backend == "nccl":
            for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, out, src, tag=tag)]):
                req.wait()
        else:
            dist.recv(out, src, tag=tag)
        self.recv_wait_s += time.perf_counter() - t0
        return out

    def all_reduce_mean_(self, tensors, group=None):
        """Each tensor, in place, becomes the mean over ``group``: the
        all-reduce SUM, then a division by the group's size (the reference's
        own arithmetic, ``intro_DP_GA.py:63-66``)."""
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

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()
