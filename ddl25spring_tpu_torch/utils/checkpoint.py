"""Checkpoint and resume on ``torch.distributed.checkpoint`` (DCP): the
counterpart of the JAX package's ``utils/checkpoint.py``, whose storage is
orbax.

The idiom is restart-from-checkpoint: save the full train state (parameters,
optimizer state, step and data cursors) every N steps, and on relaunch
restore the latest step and continue.  :class:`Checkpointer` keeps orbax's
contract:

- **Commit by rename.**  A step is written into ``<dir>/<step>.tmp-dcp`` and
  committed by ONE rename to ``<dir>/<step>``, on one rank, after every
  rank's write has finished (``dcp.save`` returns on its coordinator only
  after the metadata is written).  So a digit-named directory is a durable
  step and an interrupted save is invisible
  (:func:`~ddl25spring_tpu_torch.ft.manifest.latest_durable_step`).
- **Async saves.**  ``save`` copies the state to the host before it returns
  (the saved state is the state *at the call*), and a background thread
  writes and commits it while training goes on; the next ``save``, a
  ``restore`` or ``close`` waits for it first.  ``async_save=False`` makes
  every save durable before ``save`` returns.
- **Keep the newest** ``max_to_keep`` steps; older ones are pruned.

A state is a nested ``dict``/``list``/``tuple`` (:mod:`~ddl25spring_tpu_torch.
utils.pytree`) of tensors, numpy arrays, Python scalars and ZeRO rows
(:class:`~ddl25spring_tpu_torch.ft.reshard.Rows`).  Its leaves are saved
under ``/``-joined path keys (``params/w1``).  In a world of several ranks
``dcp.save`` is collective: every rank calls ``save`` with its own state,
and DCP writes a tensor that several ranks hold under one key once
(pipeline stages carry their stage in their keys, ``stage{s}/...``, and DP
replicas hold the same ones).  ZeRO rows are saved as the global ``[n, k]``
/ ``[L, n, k]`` tensor, row ``i`` written by rank ``i`` (a ``DTensor``
sharded over the rows' axis), so a checkpoint of ``n`` ranks restores on
``m``.  The checkpoint's collectives run on a gloo group of their own, made
when the :class:`Checkpointer` is constructed (every rank must construct it,
in the same order as its other groups), so a background save never
interleaves with a train step's collectives on one group.

Restoring: a template (the state a fresh run would build) pins each leaf's
shape, dtype and device: a restored leaf comes back on the template's
device (the rule that replaces JAX's ``with_mesh_placement``), a template
:class:`~ddl25spring_tpu_torch.ft.reshard.Rows` takes this rank's row of the
saved global tensor, and a ``meta`` template leaf (shape and dtype without
storage) comes back on the host.

:mod:`ddl25spring_tpu_torch.ft` builds the operational loop on top: the save
cadence, the sentinel gate, the manifest, the crash-path barrier
(``ft/autosave.py``) and the cross-mesh refit (``ft/reshard.py``).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ddl25spring_tpu_torch.ft.manifest import latest_durable_step
from ddl25spring_tpu_torch.utils import pytree

log = logging.getLogger(__name__)

State = Any
STAGING = ".tmp-dcp"


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


class Checkpointer:
    """Saves and restores states under ``directory`` through DCP (see the
    module docstring for the contract).  In an initialized world of several
    ranks its collectives run on a new gloo group over the whole world (every
    rank must construct it); alone, one process saves by itself."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3,
                 async_save: bool = True):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self._pg = dist.new_group(backend="gloo") if world > 1 else None
        self.is_coordinator = self._pg is None or dist.get_rank(self._pg) == 0
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._meshes: dict = {}

    def agree(self, value: int) -> int:
        """The largest ``value`` any rank of the checkpoint's group passed
        (every rank must call it; alone: ``value``).  Waits for the save in
        flight first, so the group carries one collective at a time."""
        if self._pg is None:
            return value
        self._wait()
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._pg)
        return int(t.item())

    # ---- saving ---------------------------------------------------------

    def save(self, step: int, state: State, *, force: bool = False) -> None:
        """Save ``state`` as step ``step``: copied to the host now, written
        and committed in the background (or before returning, with
        ``async_save=False``).  Waits for the previous save first and raises
        its failure, if it failed.  A step already on disk is replaced.
        ``force`` is orbax's (save off the interval); every call saves."""
        del force
        self._wait()
        flat = self._snapshot(state)
        if not self._async:
            self._write(step, flat)
            return
        self._thread = threading.Thread(target=self._write_async, args=(step, flat),
                                        daemon=True, name=f"ckpt-save-{step}")
        self._thread.start()

    def _snapshot(self, state: State) -> dict:
        """``{key: host tensor}``: every leaf copied off the card (one wait
        for all of them), ZeRO rows as the ``DTensor`` of their global
        tensor."""
        from ddl25spring_tpu_torch.ft.reshard import Rows

        out, pending = {}, False
        for path, leaf in pytree.flatten_with_path(state):
            key = pytree.slashed(path)
            if isinstance(leaf, Rows):
                host, on_card = _host_copy(leaf.local)
                out[key] = self._global(leaf, host)
            elif torch.is_tensor(leaf):
                out[key], on_card = _host_copy(leaf)
            elif isinstance(leaf, np.ndarray | np.generic):
                out[key], on_card = torch.from_numpy(np.array(leaf, copy=True)), False
            elif isinstance(leaf, bool | int | float):
                out[key], on_card = torch.tensor(leaf), False
            else:
                raise TypeError(f"cannot checkpoint leaf {key} of type {type(leaf).__name__}")
            pending = pending or on_card
        if pending:
            torch.cuda.synchronize()
        return out

    def _global(self, rows, host: torch.Tensor):
        """Rows' host copy as the global tensor's shard: a ``DTensor`` over
        the rows' axis, row ``index`` at its offset (the host copy itself
        when one rank holds every row)."""
        if rows.n == 1:
            return host
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard

        group = rows.axis.group
        mesh = self._meshes.get(id(group))
        if mesh is None:
            mesh = self._meshes[id(group)] = DeviceMesh.from_group(group, "cpu")
        shape = rows.shape
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return DTensor.from_local(host, mesh, [Shard(rows.dim)], run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def _write_async(self, step: int, flat: dict) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # noqa: BLE001 -- surfaced by the next barrier
            self._error = e

    def _write(self, step: int, flat: dict) -> None:
        dcp = _dcp()
        staging = self._dir / f"{step}{STAGING}"
        if self.is_coordinator:
            shutil.rmtree(staging, ignore_errors=True)
        self._barrier()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*torch.distributed is disabled.*")
            dcp.save(flat, storage_writer=dcp.FileSystemWriter(str(staging)),
                     process_group=self._pg, no_dist=self._pg is None)
        if self.is_coordinator:
            final = self._dir / str(step)
            if final.exists():
                old = self._dir / f"{step}.old-dcp"
                os.replace(final, old)
                os.replace(staging, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(staging, final)
            _fsync_dir(self._dir)
            self._prune()
        self._barrier()

    def _barrier(self) -> None:
        if self._pg is not None:
            dist.barrier(group=self._pg)

    def _prune(self) -> None:
        if not self._max_to_keep:
            return
        steps = sorted(int(p.name) for p in self._dir.iterdir()
                       if p.is_dir() and p.name.isdigit())
        for s in steps[:-self._max_to_keep]:
            shutil.rmtree(self._dir / str(s), ignore_errors=True)

    # ---- waiting --------------------------------------------------------

    def _wait(self) -> None:
        """The unbounded barrier: the in-flight save's thread joined, and its
        failure raised."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait_until_finished(self, timeout_s: float | None = None) -> bool:
        """Barrier on any in-flight save; True when it drained.

        ``timeout_s`` bounds the wait: a wedged write that blocked process
        exit forever is what the stall watchdog exists to catch, and the
        shutdown path must not outlive it.  On timeout the save thread is
        left running (a daemon; it cannot be killed from here) and False is
        returned so the caller can report the truncation.  A save that
        FAILED is not drained either: False, and the failure logged."""
        if timeout_s is None:
            self._wait()
            return True
        done = threading.Event()
        failure: list[BaseException] = []

        def _wait():
            try:
                self._wait()
            except BaseException as e:  # noqa: BLE001 -- a FAILED save must
                # not be reported as drained: swallowing it would let the
                # caller mark a never-committed step durable
                failure.append(e)
            finally:
                done.set()

        t = threading.Thread(target=_wait, daemon=True, name="ckpt-wait-until-finished")
        t.start()
        if not done.wait(timeout_s):
            log.warning(
                "checkpoint barrier did not drain within %.1fs — a save thread is "
                "wedged; the last checkpoint may be incomplete (its staging dir stays "
                "invisible to latest_step)", timeout_s)
            return False
        if failure:
            log.warning("checkpoint barrier raised: %s — the in-flight save did not commit",
                        failure[0])
            return False
        return True

    # ---- reading --------------------------------------------------------

    def latest_step(self) -> int | None:
        """The newest committed step on disk (None: none yet)."""
        return latest_durable_step(self._dir)

    def steps(self) -> list[int]:
        """Steps on disk (the oldest pruned per ``max_to_keep``)."""
        self._wait()
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _saved_shapes(self, step: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{key: (shape, dtype)}`` of step ``step``'s saved tensors."""
        md = _dcp().FileSystemReader(str(self._dir / str(step))).read_metadata()
        return {k: (tuple(v.size), v.properties.dtype)
                for k, v in md.state_dict_metadata.items() if hasattr(v, "size")}

    def restore(self, step: int | None = None, template: State | None = None):
        """Restore ``step`` (default the latest).  ``template`` (the freshly
        built state, or its ``meta`` form) pins the restored leaves'
        structure, dtypes, shapes and devices; a leaf whose saved shape
        differs from its template's raises (the cross-mesh route reads
        through a template of the saved shapes and refits:
        :func:`~ddl25spring_tpu_torch.ft.reshard.reshard_state`).  Without a
        template: every saved tensor on the host, nested by its key.  In a
        world of several ranks every rank must call it."""
        self._wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        path = str(self._dir / str(step))
        saved = self._saved_shapes(step)
        if template is None:
            keys = list(saved)
        else:
            flat_t = pytree.flatten_with_path(template)
            keys = [pytree.slashed(p) for p, _ in flat_t]
            missing = [k for k in keys if k not in saved]
            if missing:
                raise KeyError(f"step {step} under {self._dir} holds no {missing}")
        bufs = {k: torch.empty(saved[k][0], dtype=saved[k][1]) for k in keys}
        dcp = _dcp()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*torch.distributed is disabled.*")
            dcp.load(bufs, storage_reader=dcp.FileSystemReader(path),
                     process_group=self._pg, no_dist=self._pg is None)
        if template is None:
            return _nest(bufs)
        return pytree.unflatten_like(
            template, [_as_template(bufs[k], leaf, k) for k, (_, leaf) in zip(keys, flat_t)])

    def restore_or_init(self, init_state: State) -> tuple[State, int]:
        """The relaunch entry: ``(state, next_step)`` from the latest
        checkpoint, or ``(init_state, 0)`` on a fresh start."""
        self._wait()
        step = self.latest_step()
        if step is None:
            return init_state, 0
        return self.restore(step, template=init_state), step + 1

    def close(self, timeout_s: float | None = None) -> bool:
        """Barrier (bounded when ``timeout_s`` is given).  False when it
        timed out or the last save failed: that save's staging directory
        then never commits."""
        return self.wait_until_finished(timeout_s)


def _host_copy(t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """A host copy of ``t`` (contiguous), and whether it waits for the card
    (a non-blocking copy into pinned memory)."""
    t = t.detach()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host, True
    return t.to("cpu", copy=True).contiguous(), False


def _fsync_dir(d: Path) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = value
    return out


def _as_template(loaded: torch.Tensor, template, key: str):
    """A restored host tensor in its template leaf's form: rows, a tensor on
    the template's device (the host for ``meta``), a numpy array or a
    Python scalar, cast to the template's dtype."""
    from ddl25spring_tpu_torch.ft.reshard import Rows

    shape = tuple(template.shape) if isinstance(template, Rows) or torch.is_tensor(template) \
        else np.shape(template)
    if tuple(loaded.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf {key} has shape {tuple(loaded.shape)}, its template "
                         f"{tuple(shape)}: restore through a template of the saved shapes and "
                         "refit (ft.reshard.reshard_state)")
    if isinstance(template, Rows):
        return template.placed(loaded.to(template.dtype))
    if torch.is_tensor(template):
        dev = template.device
        return loaded.to(template.dtype).to("cpu" if dev.type == "meta" else dev)
    if isinstance(template, np.ndarray | np.generic):
        return loaded.numpy().astype(np.asarray(template).dtype)
    return type(template)(loaded.item())


# ------------------------------------------------------ optimizer state


def optimizer_layout(optimizer: torch.optim.Optimizer, device, dtype=torch.float32) -> dict:
    """``{state name: (dtype, None | device)}`` of ``optimizer``'s
    per-parameter state: an entry shaped like its parameter has no device of
    its own (None), a scalar has one (Adam keeps ``step`` on the host unless
    ``capturable``).  Torch makes optimizer state at the first step, so this
    probes a copy of the optimizer (its type and defaults) stepping a zero
    ``[1, 3]`` parameter: nothing of ``optimizer`` moves."""
    probe_p = torch.zeros((1, 3), device=device, dtype=dtype, requires_grad=True)
    probe_p.grad = torch.zeros_like(probe_p)
    probe = type(optimizer)([probe_p], **optimizer.defaults)
    probe.step()
    return {k: (v.dtype, None if tuple(v.shape) == (1, 3) else v.device)
            for k, v in probe.state[probe_p].items() if torch.is_tensor(v)}


def optimizer_template(optimizer: torch.optim.Optimizer, named_params) -> dict:
    """``{name: {state name: zeros}}`` for each of ``named_params``
    (``(name, parameter)`` pairs): the state torch makes at a fresh
    optimizer's first step, before that step runs (Adam's ``step`` 0 and
    zero moments).  The restore template of :func:`optimizer_state`."""
    named_params = list(named_params)
    if not named_params:
        return {}
    p0 = named_params[0][1]
    layout = optimizer_layout(optimizer, p0.device, p0.dtype)
    return {name: {k: (torch.zeros_like(p, dtype=dt) if dev is None
                       else torch.zeros((), dtype=dt, device=dev))
                   for k, (dt, dev) in layout.items()}
            for name, p in named_params}


def optimizer_state(optimizer: torch.optim.Optimizer, named_params) -> dict:
    """``{name: {state name: tensor}}`` of ``optimizer``'s state for each of
    ``named_params``, keyed by the parameters' names (not their positions),
    so a checkpoint names what it holds; a parameter the optimizer has not
    stepped yet gets :func:`optimizer_template`'s zeros.  The tensors are
    the optimizer's own (a save copies them)."""
    named_params = list(named_params)
    fresh = None
    out = {}
    for name, p in named_params:
        st = optimizer.state.get(p)
        if not st:
            fresh = fresh or optimizer_template(optimizer, named_params)
            out[name] = fresh[name]
            continue
        out[name] = {k: v for k, v in st.items() if torch.is_tensor(v)}
    return out


@torch.no_grad()
def load_optimizer_state(optimizer: torch.optim.Optimizer, named_params, tree: dict) -> None:
    """Set ``optimizer``'s state for each of ``named_params`` from ``tree``
    (:func:`optimizer_state`'s layout, restored): copies, on the devices the
    restore put them (the template's: Adam's ``step`` stays on the host
    without ``capturable``).  Moves no parameter and advances nothing."""
    for name, p in named_params:
        optimizer.state[p] = {k: v.clone() for k, v in tree[name].items()}
