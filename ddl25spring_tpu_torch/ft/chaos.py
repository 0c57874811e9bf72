"""Deterministic chaos injection: faults at exact step numbers (the
counterpart of the JAX package's ``ft/chaos.py``, same grammar, same
refusals, same journal).

Every recovery claim of this package -- "a SIGTERM'd run resumes from its
last durable checkpoint", "a NaN step is never persisted" -- can only be
checked if the failure itself is reproducible.  This module is that
reproducer: a fault injector armed from one env spec
(``DDL25_CHAOS=sigterm@12``) that fires *at an exact train-step index*, so a
kill-and-resume test is a deterministic program, not a race.

Spec grammar (``DDL25_CHAOS``, or any string handed to :func:`parse_chaos`)::

    <kind>@<step>[:<arg>][,<kind>@<step>[:<arg>]...]

    sigterm@12      SIGTERM to this process after step 12 completes: the
                    preemption path (the flight recorder's handler runs its
                    shutdown hooks, which drain the checkpoint, dumps and
                    exits 143)
    kill@7          SIGKILL after step 7: no handler, no cleanup, an
                    in-flight save dies mid-write
    nan_grad@5      the batch FED TO step 5 has every float tensor filled
                    with NaN, so the loss and the gradients go non-finite
                    inside the step, where the numerics sentinels see it
    device_loss@9   raise :class:`DeviceLossError` after step 9 (the
                    hardware-churn path; an elastic driver claims it with
                    :meth:`ChaosInjector.take` and reshapes instead)
    traffic_spike@8[:B]
                    SIGNAL kind (never kills): an elastic serving driver
                    polls it with :meth:`ChaosInjector.take` and injects a
                    burst of ``B`` extra arrivals at iteration 8
    capacity_change@5[:N]
                    SIGNAL kind: the capacity becomes ``N`` (ranks for
                    training, replicas for serving) at step 5; a driver
                    with no reshape path leaves it armed with a warning

Timing contract: the kill-type faults (sigterm, kill, device_loss) fire in
:meth:`ChaosInjector.on_step`, *after* step ``k`` returns and *before* the
step-``k`` checkpoint decision, so the state of step ``k`` is never durable
at death.  ``nan_grad`` is pre-step: :meth:`ChaosInjector.poison_batch`
rewrites the batch step ``k`` consumes.  The signal kinds have no default
action; elastic drivers consume them through :meth:`take`, which journals
like a fired kill before the driver acts.

One-shot across relaunches: a resumed process replays the armed step index,
so a fault that fired again would preempt the run forever.  Fired faults are
journaled under ``state_dir`` (written *before* the fault executes: a
SIGKILL must not lose the record) and skipped by any later injector reading
the same directory.  A run of several ranks arms the same spec on every
rank, so each rank fires at the same step and none is left waiting in a
collective; each rank journals into a file of its own
(``chaos_fired.rank<r>.jsonl``; one process alone keeps the JAX package's
``chaos_fired.jsonl``), so no two processes append to one file.

Host-only: nothing here enters a train step.  The sole device-visible effect
is the NaN batch, ordinary data to the step.
"""

from __future__ import annotations

import json
import logging
import os
import signal
from dataclasses import dataclass

log = logging.getLogger(__name__)

KINDS = (
    "sigterm", "kill", "nan_grad", "device_loss",
    "traffic_spike", "capacity_change",
)
# kinds with no default action: on_step never executes them; elastic
# drivers poll them through ChaosInjector.take (same journal semantics)
SIGNAL_KINDS = ("traffic_spike", "capacity_change")
# kinds that take the optional ``:<arg>`` suffix (burst size / target
# capacity); every other kind refuses one at parse time
ARG_KINDS = ("traffic_spike", "capacity_change")
CHAOS_ENV = "DDL25_CHAOS"
FIRED_BASENAME = "chaos_fired.jsonl"


def fired_basename(rank: int | None) -> str:
    """The journal's file name: JAX's ``chaos_fired.jsonl`` for one process
    alone (``rank`` None), ``chaos_fired.rank<r>.jsonl`` for rank ``r`` of
    several."""
    return FIRED_BASENAME if rank is None else f"chaos_fired.rank{rank}.jsonl"


def _world_rank() -> int | None:
    """This process's rank when it is one of several in an initialized
    ``torch.distributed`` world, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank()
    return None


class DeviceLossError(RuntimeError):
    """Simulated device loss (``device_loss@k``).  The message carries the
    ``device loss`` marker a retry driver classifies as
    ``device_unreachable``, as a real disappearance of the card."""


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    # the optional ``:<arg>`` payload (traffic_spike burst size /
    # capacity_change target size); None when the spec omitted it
    arg: int | None = None

    @property
    def key(self) -> str:
        base = f"{self.kind}@{self.step}"
        return base if self.arg is None else f"{base}:{self.arg}"


def parse_chaos(spec: str | None) -> tuple[Fault, ...]:
    """Parse a chaos spec string into faults.  Empty/None -> no faults; a
    malformed entry raises at once (a mistyped fault that silently never
    fires is a test that proves nothing)."""
    if not spec:
        return ()
    faults = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, sep, step_s = entry.partition("@")
        if not sep or not step_s:
            raise ValueError(
                f"chaos entry {entry!r} is not <kind>@<step>[:<arg>] "
                f"(spec {spec!r})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"chaos kind {kind!r} is not one of {sorted(KINDS)} "
                f"(spec {spec!r})"
            )
        step_s, asep, arg_s = step_s.partition(":")
        arg: int | None = None
        if asep:
            if kind not in ARG_KINDS:
                raise ValueError(
                    f"chaos kind {kind!r} takes no :<arg> suffix "
                    f"(entry {entry!r}); arg kinds: {sorted(ARG_KINDS)}"
                )
            try:
                arg = int(arg_s)
            except ValueError:
                raise ValueError(
                    f"chaos arg {arg_s!r} is not an integer "
                    f"(entry {entry!r})"
                ) from None
            if arg < 1:
                raise ValueError(
                    f"chaos arg must be >= 1, got {arg} (entry {entry!r})"
                )
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"chaos step {step_s!r} is not an integer (spec {spec!r})"
            ) from None
        if step < 0:
            raise ValueError(f"chaos step must be >= 0, got {step}")
        faults.append(Fault(kind, step, arg))
    return tuple(faults)


class ChaosInjector:
    """Arm faults from a spec; fire them at exact step indices.

    Wiring contract (``ft.demo`` and the LLaMA lab follow it)::

        chaos = ChaosInjector.from_env(state_dir=ckpt_dir)
        for i in range(start, steps):
            batch = chaos.poison_batch(data_at(i), i)   # nan_grad
            loss = step(batch)
            chaos.on_step(i)                            # kill-type
            saver.maybe_save(i, ...)

    Every fired fault is journaled (one-shot across relaunches) and recorded
    into the flight ring (``kind="chaos"``), so a post-mortem names the
    injection beside the death it caused.  ``rank``: whose journal this
    injector keeps (None: this process's rank in a world of several, read
    from ``torch.distributed``, else the one-process journal).
    """

    _AUTO = object()

    def __init__(
        self,
        faults: tuple[Fault, ...] | list[Fault] = (),
        state_dir: str | os.PathLike | None = None,
        rank=_AUTO,
    ):
        self.faults = tuple(faults)
        if rank is ChaosInjector._AUTO:
            rank = _world_rank()
        self._state_path = (
            os.path.join(str(state_dir), fired_basename(rank))
            if state_dir is not None else None
        )
        self._fired: set[str] = set()
        if self._state_path and os.path.exists(self._state_path):
            with open(self._state_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._fired.add(json.loads(line)["fault"])
                    except (ValueError, KeyError, TypeError):
                        # a torn trailing line (the process died MID-
                        # journal, the very event this package simulates)
                        # must not crash-loop every relaunch; at worst the
                        # half-recorded fault fires once more
                        log.warning(
                            "chaos: skipping torn journal line in %s",
                            self._state_path,
                        )

    @classmethod
    def from_env(
        cls, state_dir: str | os.PathLike | None = None, rank=_AUTO
    ) -> "ChaosInjector":
        """The driver entry: arm from ``DDL25_CHAOS`` through the sanctioned
        env boundary (``utils.config.env_str``)."""
        from ddl25spring_tpu_torch.utils.config import env_str

        return cls(parse_chaos(env_str(CHAOS_ENV)), state_dir, rank)

    def __bool__(self) -> bool:
        return bool(self.faults)

    @property
    def spec(self) -> str:
        return ",".join(f.key for f in self.faults)

    def pending(self, kind: str | None = None) -> tuple[Fault, ...]:
        """Armed faults that have not fired yet (optionally one kind)."""
        return tuple(
            f for f in self.faults
            if f.key not in self._fired and (kind is None or f.kind == kind)
        )

    def _mark_fired(self, fault: Fault) -> None:
        # journal BEFORE executing: a SIGKILL two lines later must not erase
        # the memory that this fault already fired.  The flight record is
        # mirrored onto the run timeline by the timeline's flight tap
        self._fired.add(fault.key)
        if self._state_path:
            os.makedirs(os.path.dirname(self._state_path), exist_ok=True)
            with open(self._state_path, "a") as f:
                f.write(json.dumps({"fault": fault.key}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        from ddl25spring_tpu_torch.obs.recorder import flight

        flight.record(
            kind="chaos", fault=fault.kind, step=fault.step,
            **({"arg": fault.arg} if fault.arg is not None else {}),
        )

    # ---- pre-step: data poisoning ---------------------------------------

    def poison_batch(self, batch, step: int):
        """``batch`` with every float tensor (or numpy array) NaN-filled when
        a ``nan_grad`` fault is armed for ``step``; unchanged otherwise.  An
        integer-only batch (LLaMA's tokens, raw uint8 images) cannot carry a
        NaN: the fault is skipped with a warning instead of claiming an
        injection that never happened, and stays armed."""
        hits = [f for f in self.pending("nan_grad") if f.step == step]
        if not hits:
            return batch
        import numpy as np
        import torch

        from ddl25spring_tpu_torch.utils.pytree import tree_map

        poisoned = [False]

        def poison(leaf):
            if torch.is_tensor(leaf) and leaf.is_floating_point():
                poisoned[0] = True
                return torch.full_like(leaf, float("nan"))
            if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
                poisoned[0] = True
                return np.full_like(leaf, np.nan)
            return leaf

        out = tree_map(poison, batch)
        for f in hits:
            if poisoned[0]:
                self._mark_fired(f)
                log.warning(
                    "chaos: nan_grad@%d — float batch leaves poisoned", step
                )
            else:
                log.warning(
                    "chaos: nan_grad@%d armed but the batch has no float "
                    "leaves (uint8 input path?); fault skipped", step,
                )
        return out if poisoned[0] else batch

    # ---- post-step: signal kinds (polled, never executed) ---------------

    def take(
        self, step: int, kinds: tuple[str, ...] = SIGNAL_KINDS
    ) -> tuple[Fault, ...]:
        """Consume the armed faults of ``kinds`` for ``step`` WITHOUT their
        default action: the elastic driver's entry (``traffic_spike``,
        ``capacity_change``, and ``device_loss`` when the driver reshapes
        instead of dying).  Each taken fault is journaled and
        flight-recorded like a fired kill, BEFORE the caller acts on it, so
        a death mid-reshape never fires the signal again on replay."""
        taken = tuple(
            f for f in self.pending()
            if f.step == step and f.kind in kinds
        )
        for f in taken:
            self._mark_fired(f)
            log.warning("chaos: %s taken (signal)", f.key)
        return taken

    # ---- post-step: kill-type faults ------------------------------------

    def on_step(self, step: int, skip: tuple[str, ...] = ()) -> None:
        """Fire any armed kill-type fault for ``step`` (called after the
        step returns; see the module's timing contract).  Signal kinds are
        skipped: they are for drivers that poll :meth:`take`; a driver with
        no reshape path leaves them armed, and a warning says so.  ``skip``
        names kinds the CALLER owns through :meth:`take` (an elastic driver
        claims ``device_loss`` so raise-and-die never preempts its
        reshape)."""
        for f in self.pending():
            if f.step != step or f.kind == "nan_grad" or f.kind in skip:
                continue
            if f.kind in SIGNAL_KINDS:
                log.warning(
                    "chaos: %s armed but this driver has no reshape path "
                    "(signal kinds need an elastic driver); left armed, "
                    "not executed", f.key,
                )
                continue
            self._mark_fired(f)
            if f.kind == "sigterm":
                log.warning("chaos: sigterm@%d — SIGTERM to self", step)
                os.kill(os.getpid(), signal.SIGTERM)
                # with a handler installed (the flight recorder) this call
                # does not return; without one the default action kills at
                # the next bytecode boundary
            elif f.kind == "kill":
                log.warning("chaos: kill@%d — SIGKILL to self", step)
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "device_loss":
                raise DeviceLossError(
                    f"chaos: simulated device loss after step {step} — "
                    "device unreachable"
                )
