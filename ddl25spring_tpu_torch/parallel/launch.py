"""Starting the ranks of a world: the counterpart of the JAX package's
single-controller launch (one process drives every device of the mesh).

:func:`spawn` runs ``fn(rdv, *args)`` in ``world`` new processes
(``torch.multiprocessing``, start method "forkserver": each rank is forked
from one server process that has imported :data:`PRELOAD`), one per rank,
and returns their results in rank order.  The ranks meet through a ``FileStore`` in a new
temporary directory, not a TCP port, so parallel runs on one host cannot
collide.  Every child is joined within ``timeout`` seconds and killed past
it; a rank that raises, dies or runs out of time makes :func:`spawn` raise,
with the traceback of every rank that failed, after the others are stopped.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) the
process is already one rank: :func:`spawn` runs ``fn`` once, here, with the
``env://`` rendezvous, and returns a list holding only this rank's result.

``fn`` must be importable by name (a module-level function), and what it
returns crosses back as a pickle: return numpy arrays and plain values.
"""

from __future__ import annotations

import atexit
import os
import pickle
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.multiprocessing as mp

from ddl25spring_tpu_torch.utils.mesh import Rendezvous

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# imported once by the fork server, not by every rank: torch itself, and
# torch._dynamo, which the first optimizer of a process imports (~5 s a rank
# on a CPU core between them).  Importing them initialises no CUDA, so each
# rank still starts its CUDA context fresh after the fork.
PRELOAD = ["torch", "torch._dynamo", __name__]


@atexit.register
def _stop_fork_server():
    """Stop the fork server, if this process started one, and wait for it.
    Left alone it outlives its parent by the moment it takes to notice, so a
    program that ends would leave a process behind.  ``_stop`` is the
    standard library's own way to stop it (its tests call it)."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _child(fn, rdv: Rendezvous, args, conn):
    # ranks share the host's cores; one thread each keeps them from
    # oversubscribing it
    torch.set_num_threads(1)
    try:
        payload = ("ok", fn(rdv, *args))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        payload = ("error", traceback.format_exc())
    conn.send_bytes(pickle.dumps(payload))
    conn.close()


def spawn(fn, world: int, *args, timeout: float = 120.0, tmpdir: str | None = None) -> list:
    """``[fn(rdv_0, *args), ..., fn(rdv_{world-1}, *args)]``, each in a process
    of its own with ``torch.set_num_threads(1)``; the ``FileStore`` goes in a
    new directory under ``tmpdir`` (default: the system's)."""
    if all(v in os.environ for v in TORCHRUN_VARS):
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise RuntimeError(f"torchrun started {os.environ['WORLD_SIZE']} ranks, "
                               f"this run needs {world}")
        rdv = Rendezvous(rank, world, int(os.environ["LOCAL_RANK"]),
                         int(os.environ.get("LOCAL_WORLD_SIZE", world)), "env://")
        out = [None] * world
        out[rank] = fn(rdv, *args)
        return out

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    root = tempfile.mkdtemp(prefix="ddl25-rdv-", dir=tmpdir)
    init = f"file://{os.path.join(root, 'store')}"
    procs, readers = [], []
    try:
        for rank in range(world):
            reader, writer = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_child, name=f"rank{rank}",
                            args=(fn, Rendezvous(rank, world, rank, world, init),
                                  args, writer))
            p.start()
            writer.close()
            procs.append(p)
            readers.append(reader)
        return _collect(procs, readers, timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)


def _collect(procs, readers, timeout: float, grace: float = 2.0) -> list:
    """Each rank's result as it arrives.  After the first failure the other
    ranks get ``grace`` seconds to report theirs (a rank that dies breaks its
    peers' connections, and the root cause may arrive second); then every
    failure is raised together, in rank order."""
    results = [None] * len(procs)
    failures: dict[int, str] = {}
    pending = set(range(len(procs)))
    deadline = time.monotonic() + timeout
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            if failures:
                break
            raise TimeoutError(f"ranks {sorted(pending)} did not finish within {timeout:.0f} s")
        watch = {readers[r]: r for r in pending}
        watch.update({procs[r].sentinel: r for r in pending})
        for obj in wait(list(watch), timeout=left):
            r = watch[obj]
            if r not in pending:
                continue
            pending.discard(r)
            try:
                status, payload = pickle.loads(readers[r].recv_bytes())
            except EOFError:
                procs[r].join(timeout=10)
                status, payload = "error", (f"exited with code {procs[r].exitcode} "
                                            "before reporting a result")
            if status == "ok":
                results[r] = payload
                continue
            if not failures:
                deadline = min(deadline, time.monotonic() + grace)
            failures[r] = payload
    if failures:
        raise RuntimeError("\n".join(f"rank {r} failed:\n{failures[r]}" for r in sorted(failures)))
    return results
