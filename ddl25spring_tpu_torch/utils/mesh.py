"""The rank grid, the device and backend of each rank, and its process groups:
the counterpart of the JAX package's ``utils/mesh.py`` (``make_mesh``).

The JAX package runs one SPMD program over a named mesh, ``(data, stage)``,
``(data, seq)`` or ``(data, model)``.  The port runs one process per rank, as
the reference course does (``lab/s01_b2_dp_pp.py:22-34``), on a 2-D grid
``data x X`` whose second axis ``X`` is named ``stage``, ``seq``, ``model``
or ``expert``.  Ranks are numbered row-major with ``data`` outermost, as
``make_mesh`` orders its devices: rank ``r = d * S + s`` is index ``s`` along
``X`` of replica ``d``, so replica 0 is ranks ``0..S-1``, replica 1 is
``S..2S-1``, and the DP group of index ``s`` is ``{d * S + s}`` over ``d``
(``[0, 3] / [1, 4] / [2, 5]`` at 2 x 3).  Along ``seq``, index ``s`` holds
the positions ``[s * L/S, (s+1) * L/S)`` of every sequence, as the JAX
``make_sp_loss`` assumes.

Every rank builds one process group per axis and index: the DP group of each
index along ``X`` and the ``X`` group of each replica
(:class:`~ddl25spring_tpu_torch.parallel.comm.Axis` wraps a rank's own).

Device: rank ``r`` computes on ``cuda:(local_rank % device_count)``, or on
the CPU when asked.  Backend, by a fixed rule that no error ever changes:
``nccl`` when every rank of the host has a CUDA device of its own
(``local_world <= device_count``), else ``gloo``.  On one card a 2 x 3 run is
six processes on ``cuda:0`` over gloo: NCCL refuses two ranks of one
communicator on one device, so gloo moves the bytes through pinned host
buffers (:mod:`ddl25spring_tpu_torch.parallel.comm`) while every rank
computes on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ddl25spring_tpu_torch.parallel.comm import Axis, Comm

AXES = ("stage", "seq", "model", "expert")


@dataclass(frozen=True)
class Rendezvous:
    """Where and as whom a rank joins its world (made by
    :func:`ddl25spring_tpu_torch.parallel.launch.spawn`)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    init_method: str        # "file://..." (spawned ranks) or "env://" (torchrun)


@dataclass(frozen=True)
class RankGrid:
    """``data`` replicas of ``size`` ranks along the second axis, named
    ``axis`` (``stage``: pipeline stages; ``seq``: sequence shards;
    ``model``: tensor-parallel shards; ``expert``: expert-parallel shards);
    rank ``r = d * size + s``."""

    data: int
    size: int
    axis: str = "stage"

    def __post_init__(self):
        if self.axis not in AXES:
            raise ValueError(f"grid axis {self.axis!r} is none of {AXES}")

    @property
    def world(self) -> int:
        return self.data * self.size

    def coords(self, rank: int) -> tuple[int, int]:
        """``(d, s)`` of ``rank``."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        return divmod(rank, self.size)

    def rank(self, d: int, s: int) -> int:
        return d * self.size + s

    def prev_rank(self, rank: int) -> int | None:
        """The rank of the stage before ``rank``'s in its pipeline, or None."""
        d, s = self.coords(rank)
        return self.rank(d, s - 1) if s > 0 else None

    def next_rank(self, rank: int) -> int | None:
        """The rank of the stage after ``rank``'s in its pipeline, or None."""
        d, s = self.coords(rank)
        return self.rank(d, s + 1) if s < self.size - 1 else None

    def dp_ranks(self, s: int) -> list[int]:
        """The DP group of stage ``s``: that stage in every pipeline."""
        return [self.rank(d, s) for d in range(self.data)]

    def axis_ranks(self, d: int) -> list[int]:
        """Replica ``d``'s ranks along the second axis, in index order."""
        return [self.rank(d, s) for s in range(self.size)]


def rank_device(local_rank: int, kind: str = "cuda") -> torch.device:
    """The device a rank's layout names: ``cuda:(local_rank % device_count)``,
    or the CPU for ``kind="cpu"``.  No CUDA device raises."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind {kind!r} is neither 'cuda' nor 'cpu'")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA rank was asked for but torch sees no CUDA device; "
                           "pass device='cpu' to run on the host")
    return torch.device("cuda", local_rank % n)


def cards_used(world: int, kind: str = "cuda") -> int:
    """How many devices a world of ``world`` ranks on this host computes on,
    by :func:`rank_device`'s rule; the CPU counts as one."""
    return 1 if kind == "cpu" else min(world, torch.cuda.device_count())


def select_backend(kind: str, local_world: int, device_count: int) -> str:
    """``nccl`` iff every rank of the host has a CUDA device of its own, else
    ``gloo``.  Every rank computes the same answer from the layout."""
    return "nccl" if kind == "cuda" and local_world <= device_count else "gloo"


@dataclass
class Mesh:
    """One rank's view of the grid: its coordinates, device, backend, the DP
    group of its index along the second axis, the group of its replica along
    that axis, and its :class:`Comm`.  :meth:`axis` is the named view of
    either group that the SP and TP code takes.  Close it (or use it as a
    context manager) to leave the world."""

    grid: RankGrid
    rank: int
    device: torch.device
    backend: str
    dp_group: object
    comm: Comm
    axis_group: object

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name``: ``"data"`` or the grid's second
        axis; any other name raises."""
        d, s = self.coords
        if name == "data":
            return Axis(name, self.comm, self.dp_group, tuple(self.grid.dp_ranks(s)), d)
        if name != self.grid.axis:
            raise ValueError(f"the grid's axes are ('data', {self.grid.axis!r}), not {name!r}")
        return Axis(name, self.comm, self.axis_group, tuple(self.grid.axis_ranks(d)), s)

    def regrid(self, data: int, stages: int | None = None, *, seq: int | None = None,
               model: int | None = None, expert: int | None = None) -> "Mesh":
        """The same world, device and :class:`Comm` as another grid, with its
        groups: a world of ranks can run several layouts one after the
        other.  Every rank must call it, in the same order."""
        return _grid_mesh(_grid(data, stages, seq, model, expert, self.grid.world), self.rank,
                          self.device, self.backend, self.comm)

    @property
    def coords(self) -> tuple[int, int]:
        return self.grid.coords(self.rank)

    @property
    def prev_rank(self) -> int | None:
        return self.grid.prev_rank(self.rank)

    @property
    def next_rank(self) -> int | None:
        return self.grid.next_rank(self.rank)

    def close(self, barrier: bool = True):
        """Leave the world; with ``barrier``, only once every rank got here, so
        no rank closes its sockets under a message still on its way."""
        if dist.is_initialized():
            if barrier:
                self.comm.barrier()
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(barrier=exc_type is None)


def _grid(data, stages, seq, model, expert, world) -> RankGrid:
    given = {k: v for k, v in (("stage", stages), ("seq", seq), ("model", model),
                               ("expert", expert)) if v is not None}
    if len(given) != 1:
        raise ValueError(f"name one second axis (stages=, seq=, model= or expert=), "
                         f"got {given}")
    (axis, size), = given.items()
    grid = RankGrid(data, size, axis)
    if grid.world != world:
        raise ValueError(f"a {data} x {size} grid needs {grid.world} ranks, "
                         f"the world has {world}")
    return grid


def _grid_mesh(grid: RankGrid, rank: int, dev, backend, comm) -> Mesh:
    # every rank creates every group, in the same order (a rank that skipped
    # one would deadlock the others)
    dp = [dist.new_group(grid.dp_ranks(s)) for s in range(grid.size)]
    along = [dist.new_group(grid.axis_ranks(d)) for d in range(grid.data)]
    d, s = grid.coords(rank)
    return Mesh(grid, rank, dev, backend, dp[s], comm, along[d])


def init_mesh(rdv: Rendezvous, data: int, stages: int | None = None, device: str = "cuda",
              *, seq: int | None = None, model: int | None = None,
              expert: int | None = None) -> Mesh:
    """Join the world of ``rdv`` as one rank of a ``data x stages`` grid, or
    of a ``data x seq``, ``data x model`` or ``data x expert`` one (name
    exactly one).

    ``device`` is ``"cuda"`` (the layout's card), ``"cpu"``, or an explicit
    device, which must be the one the layout names: a rank on another device
    raises.  Every rank creates every group of the grid, in the same order.
    A failed NCCL init raises; it never switches to gloo."""
    grid = _grid(data, stages, seq, model, expert, rdv.world)
    asked = torch.device(device)
    dev = rank_device(rdv.local_rank, asked.type)
    if asked.type == "cuda" and asked.index is not None and asked != dev:
        raise RuntimeError(f"rank {rdv.rank} was given {asked}, but its layout "
                           f"names {dev} (local rank {rdv.local_rank})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if torch.cuda.current_device() != dev.index:
            raise RuntimeError(f"rank {rdv.rank}: current device "
                               f"{torch.cuda.current_device()} is not {dev}")
    backend = select_backend(dev.type, rdv.local_world,
                             torch.cuda.device_count() if dev.type == "cuda" else 0)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=rdv.init_method, rank=rdv.rank,
                            world_size=rdv.world, **kw)
    mesh = _grid_mesh(grid, rdv.rank, dev, backend, Comm(backend, dev))
    if backend == "nccl":
        # build the communicator now, so a broken NCCL fails here, on every rank
        mesh.comm.barrier()
    return mesh
