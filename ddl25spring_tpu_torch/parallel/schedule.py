"""Pipeline schedules as per-rank action lists, and the proof that a world
running them cannot deadlock: the model-free half of
:mod:`~ddl25spring_tpu_torch.parallel.pipeline`.

The JAX package runs every schedule as the ticks of one SPMD scan over
``ppermute`` hops (``parallel/pipeline.py``: ``_slot_map``,
``make_interleaved_pipeline_loss``, ``make_1f1b_value_and_grad``).  The port
runs one process per rank, so what a schedule is here is the ORDER in which
each rank runs its forwards and backwards: :func:`actions` gives rank ``s``
its list of ``("F" | "B", v, m)`` (chunk ``v`` of this rank, microbatch
``m``).  With ``V`` chunks per rank, chunk ``v`` of rank ``s`` is the global
chunk ``g = v * S + s`` (Megatron's interleaving, ``split_blocks_interleaved``):
its input comes from global chunk ``g - 1`` and its output goes to ``g + 1``,
so the hop from rank ``S - 1`` wraps to rank 0 for chunk ``v + 1``, and the
gradients go the other way.

- ``gpipe``: every F in microbatch order, then every B in reverse.
- ``1f1b``, ``1f1b-stash`` (PipeDream-flush): ``min(M, S - 1 - s)`` warm-up
  forwards, then one F and one B in turn, then the remaining Bs.
- ``interleaved``: every F in Megatron's slot order (:func:`slot`), then
  every B in the reverse order (the scan transpose's drain).
- ``interleaved-1f1b`` (Megatron's interleaved 1F1B):
  ``min(M * V, 2 (S - 1 - s) + (V - 1) S)`` warm-up forward slots, then one
  F and one B in turn, the backward stream taking the same slots on the
  reversed chunks, then the remaining Bs.

The two 1F1B variants differ in what a forward keeps, not in order (see
:mod:`~ddl25spring_tpu_torch.parallel.pipeline`).

**Transport.**  :func:`comm_plan` turns an action list into the exchanges a
rank makes: before each action it posts, as ONE batch, the send of the
previous action's output (or input gradient) and the receive of this
action's input (or output gradient), and waits for both (Megatron's
``send_forward_recv_backward`` / ``send_backward_recv_forward``).  In the
steady state of 1F1B, stage ``s`` sends activation ``m`` down while stage
``s + 1`` sends gradient ``m'`` up; two blocking sends there wait for each
other for ever when the transport does not buffer them.  Each message
carries a tag unique per ``(producing global chunk, microbatch,
direction)`` (:func:`tag`).

:func:`simulate` runs the plans of a whole pipeline as a discrete-event
model of rendezvous transport, the strictest kind: a send completes only
once its receive is posted, and a batch only once each of its operations
completed.  A world that completes under it completes under any transport
that buffers more.  :func:`check_deadlock_free` raises on a world that does
not; the train steps call it before their first step.
"""

from __future__ import annotations

from dataclasses import dataclass

SCHEDULES = ("gpipe", "1f1b", "1f1b-stash", "interleaved", "interleaved-1f1b")
INTERLEAVED = ("interleaved", "interleaved-1f1b")
REMAT = ("1f1b", "interleaved-1f1b")  # forward under no_grad; backward recomputes


def check_schedule(schedule: str):
    """Raise ``ValueError`` unless ``schedule`` is one of :data:`SCHEDULES`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")


def check_layout(schedule: str, S: int, V: int, M: int):
    """The guards of the JAX ``make_pipeline_train_step`` (and
    ``make_interleaved_pipeline_loss``): a known schedule; ``V > 1`` only on
    an interleaved schedule; ``interleaved-1f1b`` with ``V >= 2``;
    ``M % S == 0`` under interleaving."""
    check_schedule(schedule)
    if V < 1 or S < 1 or M < 1:
        raise ValueError(f"stages {S}, chunks {V} and microbatches {M} must be >= 1")
    if V > 1 and schedule not in INTERLEAVED:
        raise ValueError(f"num_chunks={V} needs schedule='interleaved' or "
                         f"'interleaved-1f1b' (got {schedule!r})")
    if schedule == "interleaved-1f1b" and V < 2:
        raise ValueError("interleaved-1f1b needs num_chunks >= 2")
    if schedule in INTERLEAVED and M % S:
        raise ValueError(f"{M} microbatches not divisible by {S} stages: the "
                         "interleaved schedule runs groups of S microbatches")


def slot(k: int, S: int, V: int) -> tuple[int, int]:
    """Megatron's slot grouping (the JAX ``_slot_map``): forward slot ``k`` is
    chunk ``v`` of microbatch ``m``, with ``g, j = divmod(k, V S)``,
    ``v, r = divmod(j, S)``, ``m = g S + r``: each rank runs chunk 0 for a
    group of S microbatches, then chunk 1 for the same group, and so on."""
    g, j = divmod(k, V * S)
    v, r = divmod(j, S)
    return v, g * S + r


def warmup(schedule: str, S: int, V: int, M: int, s: int) -> int:
    """The forwards stage ``s`` runs before its first backward."""
    if schedule in ("1f1b", "1f1b-stash"):
        return min(M, S - 1 - s)
    if schedule == "interleaved-1f1b":
        return min(M * V, 2 * (S - 1 - s) + (V - 1) * S)
    return M * V


def actions(schedule: str, S: int, V: int, M: int, s: int) -> list[tuple[str, int, int]]:
    """Rank ``s``'s ordered actions ``("F" | "B", v, m)`` under ``schedule``,
    ``S`` stages, ``V`` chunks per rank and ``M`` microbatches."""
    check_layout(schedule, S, V, M)
    if not 0 <= s < S:
        raise ValueError(f"stage {s} outside 0..{S - 1}")
    fwd = [("F", *slot(k, S, V)) for k in range(M * V)]
    if schedule in ("gpipe", "interleaved"):
        return fwd + [("B", v, m) for _, v, m in reversed(fwd)]
    # the 1F1B family: the backward stream takes the forward slots in order on
    # the reversed chunks (at V = 1 simply microbatch order)
    bwd = [("B", V - 1 - v, m) for _, v, m in fwd]
    w = warmup(schedule, S, V, M, s)
    out = fwd[:w]
    for i in range(M * V - w):
        out += [fwd[w + i], bwd[i]]
    return out + bwd[M * V - w:]


def in_flight(acts) -> int:
    """The most forwards whose backward had not run yet, at any point of
    ``acts``: what the stash of a rank holds at its fullest."""
    live = peak = 0
    for kind, _, _ in acts:
        live += 1 if kind == "F" else -1
        peak = max(peak, live)
    return peak


def tag(direction: str, g: int, m: int, S: int, V: int, M: int) -> int:
    """The tag of the message that global chunk ``g`` produces for
    microbatch ``m``: its output (``"F"``) or its input's gradient (``"B"``)."""
    return ((direction == "B") * S * V + g) * M + m


def untag(t: int, S: int, V: int, M: int) -> tuple[str, int, int]:
    """The inverse of :func:`tag`: ``(direction, g, m)``."""
    dg, m = divmod(t, M)
    d, g = divmod(dg, S * V)
    return ("B" if d else "F"), g, m


@dataclass(frozen=True)
class Op:
    """One point-to-point operation of a rank: ``kind`` "send" or "recv",
    the peer's stage, and the tag."""

    kind: str
    peer: int
    tag: int


def action_ops(action, S: int, V: int, M: int, s: int) -> tuple[Op | None, Op | None]:
    """``(recv, send)`` of one action on stage ``s``: what it receives before
    it computes and sends after (None where it injects, takes the loss, or
    is the first chunk's backward)."""
    kind, v, m = action
    g, last = v * S + s, S * V - 1
    if kind == "F":
        recv = Op("recv", (g - 1) % S, tag("F", g - 1, m, S, V, M)) if g > 0 else None
        send = Op("send", (g + 1) % S, tag("F", g, m, S, V, M)) if g < last else None
    else:
        recv = Op("recv", (g + 1) % S, tag("B", g + 1, m, S, V, M)) if g < last else None
        send = Op("send", (g - 1) % S, tag("B", g, m, S, V, M)) if g > 0 else None
    return recv, send


def units(schedule: str, S: int, V: int, M: int, s: int) -> list[list[tuple[str, int, int]]]:
    """Rank ``s``'s actions grouped into the units that run between two
    exchanges: one action each, but for the steady state of
    ``interleaved-1f1b``, where a forward and the backward after it form one
    unit (Megatron's ``send_forward_backward_recv_forward_backward``: with
    more than one group of microbatches, one exchange per action deadlocks
    there, which :func:`simulate` shows)."""
    acts = actions(schedule, S, V, M, s)
    if schedule != "interleaved-1f1b":
        return [[a] for a in acts]
    w = warmup(schedule, S, V, M, s)
    n = M * V - w
    return ([[a] for a in acts[:w]] + [acts[w + 2 * i:w + 2 * i + 2] for i in range(n)]
            + [[a] for a in acts[w + 2 * n:]])


def comm_plan(schedule: str, S: int, V: int, M: int, s: int,
              forward_only: bool = False) -> list[tuple[list[Op], list]]:
    """Stage ``s``'s steps ``(ops, unit)``: post ``ops`` as one batch, wait
    for all of them, then run the actions of ``unit``; the last step sends
    what the last unit produced and runs nothing.  Each batch holds the
    sends of the unit before and the receives of the unit after, so a send
    and a receive between the same two neighbours are posted together.  A
    hop to this stage itself (one stage holding every chunk) is a local
    hand-off and posts nothing.

    ``forward_only``: the forwards of ``schedule`` alone, in its order (the
    loss without gradients)."""
    if forward_only:
        grouped = [[a] for a in actions(schedule, S, V, M, s) if a[0] == "F"]
    else:
        grouped = units(schedule, S, V, M, s)
    plan, pending = [], []
    for unit in grouped:
        recvs, sends = [], []
        for a in unit:
            recv, send = action_ops(a, S, V, M, s)
            recvs += [recv] if recv is not None and recv.peer != s else []
            sends += [send] if send is not None and send.peer != s else []
        plan.append((pending + recvs, unit))
        pending = sends
    plan.append((pending, []))
    return plan


def simulate(plans) -> tuple[bool, list[int]]:
    """Run one pipeline's plans (``plans[s]`` from :func:`comm_plan`) under
    rendezvous transport.  Returns ``(completed, stuck)``: whether every
    stage got through every step, and the index of the step each stage was
    left waiting in (its plan's length when it finished).

    A rank waits in its current batch until each operation in it is matched:
    a send on stage ``a`` to ``b`` with tag ``t`` matches a receive on ``b``
    from ``a`` with tag ``t`` in ``b``'s current batch.  Matching only ever
    enables more matches, so the order of the sweep does not change the
    outcome."""
    S = len(plans)
    plans = [[ops for ops, _ in plan] for plan in plans]
    at = [0] * S
    open_ops = [list(p[0]) if p else [] for p in plans]
    while True:
        moved = False
        for a in range(S):
            for op in list(open_ops[a]):
                if op.kind != "send" or at[op.peer] >= len(plans[op.peer]):
                    continue
                want = Op("recv", a, op.tag)
                if want in open_ops[op.peer]:
                    open_ops[a].remove(op)
                    open_ops[op.peer].remove(want)
                    moved = True
        for a in range(S):
            while at[a] < len(plans[a]) and not open_ops[a]:
                at[a] += 1
                open_ops[a] = list(plans[a][at[a]]) if at[a] < len(plans[a]) else []
                moved = True
        if all(at[a] == len(plans[a]) for a in range(S)):
            return True, at
        if not moved:
            return False, at


def check_deadlock_free(schedule: str, S: int, V: int, M: int):
    """Raise ``RuntimeError`` unless the plans of every stage under
    ``schedule`` complete in :func:`simulate`."""
    done, at = simulate([comm_plan(schedule, S, V, M, s) for s in range(S)])
    if not done:
        raise RuntimeError(f"schedule {schedule!r} (S={S}, V={V}, M={M}) deadlocks: "
                           f"the stages wait in steps {at}")
