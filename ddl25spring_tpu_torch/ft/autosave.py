"""Resilient checkpointing: sentinel-gated async autosave and auto-resume
(the counterpart of the JAX package's ``ft/autosave.py``).

:mod:`~ddl25spring_tpu_torch.utils.checkpoint` is the storage primitive (DCP,
commit by rename).  This module is the loop around it, which turns "there is
a Checkpointer" into "a preempted run loses at most ``save_every`` steps":

- **Full resume state.**  :func:`resume_bundle` carries the parameters, the
  optimizer state, the data cursor (which batch comes next) and the rng
  seed together, so a resumed run replays the batches a run that never
  died would have seen (the kill-and-resume equivalence is bitwise for
  that reason).
- **Async, off the step path.**  :meth:`AutoSaver.maybe_save` enqueues a
  save every ``save_every`` steps; writing it overlaps the following steps
  (the state is copied to the host before the call returns).
- **Poisoned-checkpoint prevention.**  A checkpoint of a NaN'd state is
  worse than none: auto-resume would restore the poison forever.  The gate
  refuses to persist a step when (a) its loss is non-finite, or (b) the
  numerics sentinels recorded a violation since the last save decision
  (:func:`~ddl25spring_tpu_torch.obs.sentinels.violation_count`, after
  :func:`~ddl25spring_tpu_torch.obs.sentinels.flush` folds the facts the
  card has produced).  The gate reads the loss (a tensor is accepted) and
  flushes only when the cadence fires, so a step that saves nothing waits
  for nothing.  In a world of several ranks the decision is one max over
  the checkpoint's group (a sentinel records on its group's rank 0 only,
  and a pipeline's loss lives on its last stage), so every rank saves or
  skips together.  Skipped saves are flight-recorded
  (``kind="save_skipped"``).
- **Atomic manifest.**  ``manifest.json`` (temp file + rename) names the
  last *requested* and last *durable* step, the saved leaf shapes (what
  the cross-mesh restore builds its template from) and the run facts a
  post-mortem wants beside them.  Durability follows the checkpoint's own
  semantics: ``save(k)`` waits for the previous save, so that step is
  durable the moment ``save(k)`` returns.  One rank writes it.
- **Crash-path barrier.**  Construction registers :meth:`AutoSaver.close`
  on the flight recorder's shutdown chain (excepthook, SIGTERM, atexit), so
  a preempted run drains its in-flight save instead of truncating it,
  bounded by ``close_timeout_s``.
- **Auto-resume, cross-mesh included.**  :meth:`AutoSaver.restore_or_init`
  is the relaunch entry: a fresh directory gives ``(init, 0)``; the same
  mesh a template restore; a *different* mesh (the manifest's leaf shapes
  differ from the template's) a restore through a template of the saved
  shapes, every row refit by :mod:`~ddl25spring_tpu_torch.ft.reshard`.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ddl25spring_tpu_torch.analysis.host_sanitizer import wrap_lock

# manifest I/O lives in ft/manifest.py (pure stdlib: a retry driver and a
# post-mortem report read it without torch.distributed.checkpoint); it is
# re-exported here because AutoSaver is its writer
from ddl25spring_tpu_torch.ft.manifest import (  # noqa: F401 — re-export
    MANIFEST_BASENAME,
    latest_durable_step,
    read_manifest,
    write_manifest,
)
from ddl25spring_tpu_torch.obs import sentinels
from ddl25spring_tpu_torch.obs.recorder import flight
from ddl25spring_tpu_torch.utils import pytree
from ddl25spring_tpu_torch.utils.checkpoint import Checkpointer

log = logging.getLogger(__name__)

GATE_REASONS = (None, "nonfinite_loss", "sentinel_violation")


def resume_bundle(
    params: Any,
    opt_state: Any,
    *,
    data_cursor: int = 0,
    rng_seed: int | None = None,
    **extra: Any,
) -> dict:
    """The FULL resume state: model, optimizer, and where the input pipeline
    and the rng were.  Scalar cursors ride as int64 arrays, so they
    round-trip exactly."""
    out = {
        "params": params,
        "opt_state": opt_state,
        "data_cursor": np.asarray(data_cursor, np.int64),
    }
    if rng_seed is not None:
        out["rng_seed"] = np.asarray(rng_seed, np.int64)
    out.update(extra)
    return out


def _leaf_shape(leaf) -> list:
    """``[shape, dtype name]`` of one state leaf, as the manifest records it
    (the global shape of ZeRO rows; ``float32``, not ``torch.float32``)."""
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        dtype = str(leaf.dtype).removeprefix("torch.")
        return [list(leaf.shape), dtype]
    return [list(np.shape(leaf)), str(np.result_type(leaf))]


def _abstract(shape, dtype: str) -> torch.Tensor:
    """A template leaf of a saved shape and dtype without storage."""
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype), device="meta")


# --------------------------------------------------------------- AutoSaver


class AutoSaver:
    """Periodic, sentinel-gated, crash-barriered checkpointing.

    ``maybe_save(step, state, loss=...)`` after every completed step;
    ``restore_or_init(init_state)`` at (re)launch.  ``state`` is any state
    (:func:`resume_bundle` builds the canonical one).  In a world of several
    ranks every rank constructs it and calls it alike (the checkpoint is
    collective).  See the module docstring for the contract.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        save_every: int = 0,
        *,
        max_to_keep: int = 3,
        async_save: bool = True,
        close_timeout_s: float = 60.0,
        meta: dict | None = None,
    ):
        self._dir = Path(directory).absolute()
        self.ckpt = Checkpointer(self._dir, max_to_keep=max_to_keep, async_save=async_save)
        self._async = bool(async_save)
        self.save_every = int(save_every)
        self.close_timeout_s = float(close_timeout_s)
        self._meta = dict(meta or {})
        self._last_requested: int | None = None
        self._last_durable: int | None = latest_durable_step(self._dir)
        self._leaf_shapes: list | None = None
        # a resumed process that dies before ITS first save still owes the
        # manifest the previous lineage's facts -- above all leaf_shapes,
        # which the cross-mesh restore needs; a close() that set them to
        # null would break the next resume
        self._prior_manifest = read_manifest(self._dir) or {}
        self._seen_violations = sentinels.violation_count()
        # guards the closed flip and the durable-step record: close() runs
        # from the train loop AND the flight shutdown chain.  REENTRANT on
        # purpose: the chain runs inside the SIGTERM/excepthook handlers,
        # which can land while the main thread is inside close() holding it
        self._state_lock = wrap_lock("autosave._state_lock", threading.RLock())
        self._closed = False
        self.saves = 0
        self.skipped = 0
        self._hook_name = flight.register_shutdown(self.close, name=f"autosave:{self._dir}")

    # ---- saving ---------------------------------------------------------

    def _gate(self, loss) -> str | None:
        """Why the pending state must NOT be persisted (None = clean).
        Consumes the sentinel-violation delta either way: one poisoned step
        blocks one save decision, and under ``skip`` (whose fallback already
        put the pre-step state back) the next clean interval saves again."""
        # fold the facts the card has produced: the violation of the step
        # being judged may not have been read yet
        sentinels.flush()
        cur = sentinels.violation_count()
        fresh = cur - self._seen_violations
        self._seen_violations = cur
        if loss is not None and not math.isfinite(float(loss)):
            reason = "nonfinite_loss"
        elif fresh > 0:
            reason = "sentinel_violation"
        else:
            reason = None
        # every rank must save or skip together: the worst reason wins
        return GATE_REASONS[self.ckpt.agree(GATE_REASONS.index(reason))]

    def maybe_save(
        self,
        step: int,
        state: Any,
        *,
        loss=None,
        force: bool = False,
    ) -> bool:
        """Save after step ``step`` when the cadence says so and the gate
        clears; True when a save was enqueued.  ``loss``: a float, a tensor
        (read only when the cadence fires) or None."""
        if self._closed:
            return False
        if not force and (self.save_every <= 0 or (step + 1) % self.save_every):
            return False
        reason = self._gate(loss)
        if reason is not None:
            self.skipped += 1
            lval = None if loss is None else float(loss)
            flight.record(
                kind="save_skipped", step=step, reason=reason,
                **({"loss": lval} if lval is not None else {}),
            )
            log.warning(
                "autosave: step %d NOT persisted (%s) — poisoned-checkpoint "
                "prevention", step, reason,
            )
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state: Any) -> None:
        """Unconditional async save, with the manifest and flight
        bookkeeping."""
        self.ckpt.save(step, state, force=True)
        # the checkpoint waited for the PREVIOUS save before starting this
        # one: that step is durable now (a synchronous save is durable the
        # moment it returns)
        prev, self._last_requested = self._last_requested, step
        if not self._async:
            self._mark_durable(step)
        elif prev is not None:
            self._mark_durable(prev)
        self.saves += 1
        if self._leaf_shapes is None:
            self._leaf_shapes = [_leaf_shape(leaf) for leaf in pytree.leaves(state)]
        flight.record(kind="save", step=step)
        if self.ckpt.is_coordinator:
            self._write_manifest()

    def _mark_durable(self, step: int) -> None:
        with self._state_lock:
            if self._last_durable is None or step > self._last_durable:
                self._last_durable = step
        flight.annotate(ckpt_last_durable_step=self._last_durable, ckpt_dir=str(self._dir))

    def _write_manifest(self) -> None:
        # a field this process has no fresh value for falls back to the
        # prior lineage's manifest; the save counters accumulate over the
        # lineage so the recovery report counts the whole story
        prior = self._prior_manifest
        write_manifest(self._dir, {
            "record": "ckpt_manifest",
            "last_requested_step": (
                self._last_requested
                if self._last_requested is not None
                else prior.get("last_requested_step")
            ),
            "last_durable_step": self._last_durable,
            "save_every": self.save_every,
            "saves": int(prior.get("saves") or 0) + self.saves,
            "save_skipped": int(prior.get("save_skipped") or 0) + self.skipped,
            "leaf_shapes": self._leaf_shapes or prior.get("leaf_shapes"),
            "written_at_unix": time.time(),
            **({"meta": self._meta} if self._meta else {}),
        })

    def note_reshape(self, **facts) -> None:
        """The elastic-reshape notification (:mod:`~ddl25spring_tpu_torch.
        ft.elastic`): after an in-run reshape the live state's leaf shapes
        are the NEW mesh's, the recorded ``leaf_shapes`` (old mesh) stale,
        and a later cross-mesh resume keys its template on them.  Dropping
        the cache makes the next save record the truth; ``facts`` (old and
        new mesh sizes...) land in the manifest's meta."""
        self._leaf_shapes = None
        # the prior manifest's leaf_shapes describe the OLD layout too: a
        # close() before the next save must not bring them back under a
        # state that no longer has those shapes
        self._prior_manifest = dict(self._prior_manifest)
        self._prior_manifest.pop("leaf_shapes", None)
        if facts:
            self._meta = {**self._meta, "reshape": facts}

    # ---- restoring ------------------------------------------------------

    def restore_or_init(self, init_state: Any) -> tuple[Any, int]:
        """The relaunch entry: ``(state, next_step)`` from the latest durable
        checkpoint, or ``(init_state, 0)`` on a fresh start.

        ``init_state`` is the state a cold run would build: the restore
        TEMPLATE, whose leaves' dtypes, shapes and devices (and rows) pin
        where the restored data lands.  When the saved leaf shapes (the
        manifest's) differ from the template's -- the world is another size
        -- the state is read through a template of the SAVED shapes and
        every ``[n, k]`` row layout refit onto the template's ``[m, k']``
        (:func:`~ddl25spring_tpu_torch.ft.reshard.reshard_state`)."""
        step = self.ckpt.latest_step()
        if step is None:
            return init_state, 0
        man = read_manifest(self._dir)
        saved_shapes = (man or {}).get("leaf_shapes")
        tmpl_leaves = pytree.leaves(init_state)
        cross_mesh = (
            saved_shapes is not None
            and len(saved_shapes) == len(tmpl_leaves)
            and any(
                tuple(sh) != tuple(_leaf_shape(leaf)[0])
                for (sh, _), leaf in zip(saved_shapes, tmpl_leaves)
            )
        )
        if cross_mesh:
            from ddl25spring_tpu_torch.ft import reshard

            abstract = pytree.unflatten_like(
                init_state, [_abstract(sh, dt) for sh, dt in saved_shapes])
            raw = self.ckpt.restore(step, template=abstract)
            state = reshard.reshard_state(raw, init_state)
        else:
            state = self.ckpt.restore(step, template=init_state)
        self._last_requested = step  # resaving continues from here
        self._mark_durable(step)
        flight.record(kind="restore", step=step, cross_mesh=bool(cross_mesh))
        flight.annotate(resumed_from_step=step)
        log.warning(
            "autosave: resumed from step %d (%s) — next step %d",
            step, "cross-mesh reshard" if cross_mesh else "same mesh", step + 1,
        )
        return state, step + 1

    # ---- lifecycle ------------------------------------------------------

    def close(self, timeout_s: float | None = None) -> bool:
        """Barrier the in-flight save (bounded), finalize the manifest.
        Idempotent: it runs on the flight recorder's shutdown chain, where
        SIGTERM and atexit may both arrive."""
        with self._state_lock:
            if self._closed:
                return True
            self._closed = True
        flight.unregister_shutdown(self._hook_name)
        drained = self.ckpt.close(
            timeout_s if timeout_s is not None else self.close_timeout_s
        )
        if drained and self._last_requested is not None:
            self._mark_durable(self._last_requested)
        elif not drained:
            log.warning(
                "autosave: close barrier timed out — last durable step stays %s "
                "(requested %s)", self._last_durable, self._last_requested,
            )
        if self.ckpt.is_coordinator:
            self._write_manifest()
        return drained
