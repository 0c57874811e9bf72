"""The rank grid, the device and backend of each rank, and its process groups:
the counterpart of the JAX package's ``utils/mesh.py`` (``make_mesh``).

The JAX package runs one SPMD program over a named mesh, ``(data, stage)``,
``(data, seq)``, ``(data, stage, model)``, ``(stage, seq, model)`` and so on.
The port runs one process per rank, as the reference course does
(``lab/s01_b2_dp_pp.py:22-34``), on a grid of named axes: ``data``
outermost, then a second axis ``X`` named ``stage``, ``seq``, ``model`` or
``expert``, then, for the pipeline compositions, more axes after it, in the
order ``stage, seq, model`` (``data x stage x model``, ``data x stage x
seq``, ``stage x seq x model`` with a data axis of 1).  Ranks are numbered
row-major, as ``make_mesh`` reshapes its devices: on ``data x X`` rank ``r
= d * S + s`` is index ``s`` along ``X`` of replica ``d``, so replica 0 is
ranks ``0..S-1`` and the DP group of index ``s`` is ``{d * S + s}`` over
``d`` (``[0, 3] / [1, 4] / [2, 5]`` at 2 x 3); on ``data x stage x model``
``r = (d * S + s) * T + t``.  Along ``seq``, index ``s`` holds the
positions ``[s * L/n, (s+1) * L/n)`` of every sequence, as the JAX
``make_sp_loss`` assumes.

Every rank builds one process group per axis and line: for each axis, the
ranks that differ only in that axis, every line of it, axes in grid order
(:class:`~ddl25spring_tpu_torch.parallel.comm.Axis` wraps a rank's own).
A group over several axes at once (``Mesh.axis(("data", "seq"))``) is
built on its first use, which every rank makes in the same order.

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

import itertools
import math
from dataclasses import dataclass, field

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
    ``model``: tensor-parallel shards; ``expert``: expert-parallel shards),
    then the ``inner`` axes, ``(name, size)`` pairs, innermost last; ranks
    row-major: ``r = d * size + s`` on two axes."""

    data: int
    size: int
    axis: str = "stage"
    inner: tuple[tuple[str, int], ...] = ()

    def __post_init__(self):
        if self.axis not in AXES:
            raise ValueError(f"grid axis {self.axis!r} is none of {AXES}")
        names = self.names
        if len(set(names)) != len(names) or any(
                AXES.index(a) >= AXES.index(b) for a, b in zip(names[1:], names[2:])):
            raise ValueError(f"grid axes {names} are not distinct names of {AXES} in "
                             "that order after 'data'")

    @property
    def names(self) -> tuple[str, ...]:
        return ("data", self.axis, *(name for name, _ in self.inner))

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.size, *(n for _, n in self.inner))

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def coords(self, rank: int) -> tuple[int, ...]:
        """``(d, s, ...)`` of ``rank``, one index per axis."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        out = []
        for n in reversed(self.shape):
            rank, i = divmod(rank, n)
            out.append(i)
        return tuple(reversed(out))

    def rank(self, *coords: int) -> int:
        r = 0
        for i, n in zip(coords, self.shape, strict=True):
            r = r * n + i
        return r

    def moved(self, rank: int, name: str, index: int) -> int:
        """The rank at ``rank``'s coordinates with axis ``name`` set to ``index``."""
        c = list(self.coords(rank))
        c[self.names.index(name)] = index
        return self.rank(*c)

    def line(self, rank: int, names) -> list[int]:
        """The ranks that differ from ``rank`` only along ``names`` (one axis
        name or several, in grid order), in index order: row-major over
        them."""
        names = (names,) if isinstance(names, str) else tuple(names)
        for name in names:
            if name not in self.names:
                raise ValueError(f"the grid's axes are {self.names}, not {name!r}")
        dims = [i for i, n in enumerate(self.names) if n in names]
        c = list(self.coords(rank))
        out = []
        for idx in itertools.product(*(range(self.shape[i]) for i in dims)):
            for i, j in zip(dims, idx):
                c[i] = j
            out.append(self.rank(*c))
        return out

    def lines(self, names) -> list[list[int]]:
        """Every line along ``names``, ordered by its first rank."""
        firsts = sorted({min(self.line(r, names)) for r in range(self.world)})
        return [self.line(r, names) for r in firsts]

    def _step(self, rank: int, by: int) -> int | None:
        c = self.coords(rank)
        s = c[1] + by
        return self.rank(c[0], s, *c[2:]) if 0 <= s < self.size else None

    def prev_rank(self, rank: int) -> int | None:
        """The rank of the stage before ``rank``'s in its pipeline, or None."""
        return self._step(rank, -1)

    def next_rank(self, rank: int) -> int | None:
        """The rank of the stage after ``rank``'s in its pipeline, or None."""
        return self._step(rank, 1)

    def dp_ranks(self, s: int) -> list[int]:
        """The DP group of stage ``s`` (index 0 of any inner axis): that stage
        in every pipeline."""
        return self.line(self.rank(0, s, *(0 for _ in self.inner)), "data")

    def axis_ranks(self, d: int) -> list[int]:
        """Replica ``d``'s ranks along the second axis (index 0 of any inner
        axis), in index order."""
        return self.line(self.rank(d, 0, *(0 for _ in self.inner)), self.axis)


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
    """One rank's view of the grid: its coordinates, device, backend, its
    :class:`Comm`, and the group of its line along each axis (``groups``,
    by axis name; a tuple of names for a group over several axes).
    :meth:`axis` is the named view of one of them that the parallel code
    takes.  Close it (or use it as a context manager) to leave the world."""

    grid: RankGrid
    rank: int
    device: torch.device
    backend: str
    comm: Comm
    groups: dict = field(default_factory=dict)

    @property
    def dp_group(self):
        """The group of this rank's line along ``data``."""
        return self.groups["data"]

    @property
    def axis_group(self):
        """The group of this rank's line along the second axis."""
        return self.groups[self.grid.axis]

    def axis(self, name) -> Axis:
        """This rank's view of axis ``name`` (``"data"`` or another axis of
        the grid; any other name raises), or of the axes ``name`` names
        together (a tuple, in grid order), whose group every rank builds on
        the first call, which they must all make in the same order."""
        key = name if isinstance(name, str) else tuple(name)
        ranks = tuple(self.grid.line(self.rank, key))
        if key not in self.groups:
            if isinstance(key, str):
                raise ValueError(f"the grid's axes are {self.grid.names}, not {name!r}")
            mine = None
            for line in self.grid.lines(key):
                g = dist.new_group(line)
                if self.rank in line:
                    mine = g
            self.groups[key] = mine
        label = key if isinstance(key, str) else ",".join(key)
        return Axis(label, self.comm, self.groups[key], ranks, ranks.index(self.rank))

    def regrid(self, data: int, stages: int | None = None, *, seq: int | None = None,
               model: int | None = None, expert: int | None = None) -> "Mesh":
        """The same world, device and :class:`Comm` as another grid, with its
        groups: a world of ranks can run several layouts one after the
        other.  Every rank must call it, in the same order."""
        return _grid_mesh(_grid(data, stages, seq, model, expert, self.grid.world), self.rank,
                          self.device, self.backend, self.comm)

    @property
    def coords(self) -> tuple[int, ...]:
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
    given = [(k, v) for k, v in (("stage", stages), ("seq", seq), ("model", model),
                                 ("expert", expert)) if v is not None]
    if not given or (len(given) > 1 and any(k == "expert" for k, _ in given)):
        raise ValueError(f"name a second axis (stages=, seq=, model= or expert=), and "
                         f"then only stages=, seq= or model= beside it; got {dict(given)}")
    (axis, size), *inner = given
    grid = RankGrid(data, size, axis, tuple(inner))
    if grid.world != world:
        raise ValueError(f"a {' x '.join(map(str, grid.shape))} grid needs {grid.world} "
                         f"ranks, the world has {world}")
    return grid


def _grid_mesh(grid: RankGrid, rank: int, dev, backend, comm) -> Mesh:
    # every rank creates every group, in the same order (a rank that skipped
    # one would deadlock the others)
    groups = {}
    for name in grid.names:
        for line in grid.lines(name):
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    return Mesh(grid, rank, dev, backend, comm, groups)


def init_mesh(rdv: Rendezvous, data: int, stages: int | None = None, device: str = "cuda",
              *, seq: int | None = None, model: int | None = None,
              expert: int | None = None) -> Mesh:
    """Join the world of ``rdv`` as one rank of a ``data x stages`` grid, or
    of a ``data x seq``, ``data x model`` or ``data x expert`` one; or, for
    the pipeline compositions, of ``data x stages x model``, ``data x stages
    x seq`` or ``stages x seq x model`` (``data=1``): the axes named, in
    that order after ``data``.

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
