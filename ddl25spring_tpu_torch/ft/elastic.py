"""In-run elastic reshaping: survive the loss (or return) of ranks without a
restart (the counterpart of the JAX package's ``ft/elastic.py``, its
training half).

Dying and relaunching from the last durable checkpoint loses every step
since it and the whole process bring-up.  The cheap way: on a
:class:`~ddl25spring_tpu_torch.ft.chaos.DeviceLossError` or a
``capacity_change`` signal, the *running* processes reshape onto the new
layout and keep going, losing at most the step in flight.  Three moves, none
of them new machinery:

1. **Re-land the live state.**  Chaos fires after a step, so the driver holds
   the last completed step's state.  ZeRO's ``[n, k]`` / ``[L, n, k]`` rows
   (:func:`~ddl25spring_tpu_torch.parallel.zero.zero_state`) are gathered
   over the old data axis on the card and refit onto the new layout by
   :mod:`~ddl25spring_tpu_torch.ft.reshard`'s math, each rank keeping its
   row of the new ``[m, k']``: the exactness argument of the checkpoint
   restore, on live tensors.  The checkpoint is not touched; it stays the
   backstop for a real death.
2. **Re-lower the strategy.**  A rule table is the strategy as data, so the
   re-lower is :meth:`~ddl25spring_tpu_torch.parallel.rules.
   RulePartitioner.with_mesh` with the SAME table (:func:`relower`); a
   bespoke builder is called again on the new mesh with the rows
   :func:`~ddl25spring_tpu_torch.parallel.zero.zero_rows_from_state` makes
   and an optimizer built over them.
3. **Resume from memory.**  The data cursor and rng seed are live host state;
   a ``kind="reshape"`` flight event records the old and new layout, the
   wall clock and the steps lost, and
   :meth:`~ddl25spring_tpu_torch.ft.autosave.AutoSaver.note_reshape` drops
   the stale leaf shapes so the next checkpoint records the new layout.

In the port a reshape keeps the world of processes and changes its grid
(``Mesh.regrid``): ranks a smaller data axis leaves out run as further
replicas of it.  The serving half (the JAX ``serve/driver.
elastic_serve_run``) comes with the serving engine.
"""

from __future__ import annotations

import logging
from typing import Any

log = logging.getLogger(__name__)


def surviving_devices(devices, *, lose: int = 0, size: int | None = None):
    """The survivors after a capacity event: ``size`` of them when a target
    is given (``capacity_change@k:size``), else the first ``len - lose``
    (``device_loss``: the failed slice drops off the end; which ones survive
    is the scheduler's call, the math needs only how many).  Refuses an
    empty slice, or one larger than what is there, loudly."""
    n = len(devices)
    target = int(size) if size is not None else n - int(lose)
    if not 0 < target <= n:
        raise ValueError(
            f"cannot reshape to {target} devices (have {n}; lose={lose}, "
            f"size={size})"
        )
    return list(devices)[:target]


def reshape_state(state: Any, template: Any) -> Any:
    """Re-land a LIVE state onto a new layout's template:
    :func:`~ddl25spring_tpu_torch.ft.reshard.reshard_state` with live leaves
    (rows gathered over their old axis on the card), named apart because the
    caller is moving memory between layouts, not restoring a checkpoint.
    The template may be abstract (``zero_resume_template(abstract=True)``),
    so the survivors allocate no throwaway state.  Every rank of the old
    axis must call it (the gathers are collective)."""
    from ddl25spring_tpu_torch.ft import reshard

    return reshard.reshard_state(state, template)


def relower(strategy, mesh, *, model=None, loss_fn=None, optimizer=None, rows=None, **kw):
    """Re-lower a strategy onto a new mesh: the step-rebuild half of a
    reshape (JAX ``ft/elastic.py:85-118``).

    A :class:`~ddl25spring_tpu_torch.parallel.rules.RuleTable` or
    :class:`~ddl25spring_tpu_torch.parallel.rules.RulePartitioner`: the
    table IS the strategy; it is bound to the new mesh
    (``RulePartitioner.with_mesh``) and builds the train step through its
    one lowering path (``make_train_step(model, loss_fn, optimizer, rows,
    **kw)``; the rows and the optimizer over them are the new layout's).  A
    registered strategy NAME rebuilds through the ``describe()`` registry
    on the new mesh: the describe dict (the canonical workload's step, its
    inputs, ``meta`` and signature), :func:`~ddl25spring_tpu_torch.obs.
    comm_analytics.describe_strategy` with ``kw``."""
    from ddl25spring_tpu_torch.parallel.rules import RulePartitioner, RuleTable

    if isinstance(strategy, RulePartitioner):
        part = strategy.with_mesh(mesh)
    elif isinstance(strategy, RuleTable):
        part = RulePartitioner(mesh, strategy)
    else:
        from ddl25spring_tpu_torch.obs import comm_analytics

        return comm_analytics.describe_strategy(str(strategy), mesh, **kw)
    return part.make_train_step(model, loss_fn, optimizer, rows=rows, **kw)


def _mesh_cell(layout) -> dict | int:
    """``{axis: size}`` of a layout: an ``Axis`` (its own), a dict, or a
    plain count."""
    if isinstance(layout, dict):
        return {str(k): int(v) for k, v in layout.items()}
    if hasattr(layout, "size") and hasattr(layout, "name"):
        return {str(layout.name): int(layout.size)}
    return int(layout)


def record_reshape(
    *,
    old,
    new,
    wall_s: float,
    steps_lost: int,
    reason: str,
    scope: str = "train",
    **extra: Any,
) -> dict:
    """One ``kind="reshape"`` flight event, and the driver-facing event dict.
    ``old``/``new`` are the data axes of the layouts (``mesh.axis("data")``),
    ``{axis: size}`` dicts or plain counts; ``reason`` names the trigger (``device_loss`` /
    ``capacity_change`` / ``traffic_spike``).  The flight record is mirrored
    onto the run timeline (the timeline's flight tap)."""
    from ddl25spring_tpu_torch.obs.recorder import flight

    event = {
        "scope": scope,
        "reason": reason,
        "old": _mesh_cell(old),
        "new": _mesh_cell(new),
        "wall_s": round(float(wall_s), 6),
        "steps_lost": int(steps_lost),
        **extra,
    }
    flight.record(kind="reshape", **event)
    log.warning(
        "elastic: %s reshape %s -> %s (%s) in %.3fs, %d step(s) lost",
        scope, event["old"], event["new"], reason, wall_s, steps_lost,
    )
    return event
