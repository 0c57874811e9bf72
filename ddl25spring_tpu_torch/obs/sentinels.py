"""In-step numerics sentinels: health checks of every train step, on the card.

A diverging run fails silently (a NaN loss propagates until the weights are
garbage) or late (someone notices the loss curve).  The guard computes the
step's health facts on the card — the loss, the global gradient norm, a
non-finite flag per parameter leaf for the gradients and for the updates,
the update-to-parameter ratio — and folds them into the
:mod:`~ddl25spring_tpu_torch.obs.recorder` flight ring, so the last N steps
are always reconstructible from artifacts.  The names, records and
policies are the JAX package's (``obs/sentinels.py`` there): the same
poisoned leaf yields the same ``grads['blocks']['wq']`` string in both.

Gating: every builder resolves the flag and the policy when it BUILDS the
step (:func:`resolve`; ``DDL25_SENTINELS=1`` / :func:`enable` /
:func:`scoped`, read through ``utils.config``).  A step built with the
sentinel off runs exactly the operations of an unguarded one (an op log
under a ``TorchDispatchMode`` pins it in ``tests/test_torch_health.py``).

How the facts reach the host without a sync per step:

- the guard packs them into one small float32 tensor on the card
  (``[loss, |g|², |u|², |p|², ok, flags...]``): the norms come from
  ``torch._foreach_norm`` over the leaves' tensors, a few multi-tensor
  launches for the whole model (a leaf is non-finite exactly when its
  norm is), and the updates are the parameters less a snapshot taken
  before ``optimizer.step()``;
- on a multi-rank step the vector is summed over the step's group in one
  all-reduce (each leaf's squared norm weighted by 1 / the number of
  ranks that hold a copy of it, the loss likewise), so every rank reaches
  the same ``ok``; only the group's rank 0 records, the others beat the
  flight clock;
- the vector is copied ``non_blocking`` into a pinned host slot behind a
  CUDA event, and folded into the ring and the counters once the event is
  done: at the next guarded step, at ``flight.snapshot()``/``dump()``, or
  at :func:`flush`.  On the CPU it folds at once;
- inside a CUDA graph (:func:`~ddl25spring_tpu_torch.parallel.pipeline.
  fuse_train_steps`) each step writes its vector into row ``i`` of a
  static ``[k, n]`` buffer the graph fills; the fused steps fold the ``k``
  rows after each replay, in step order.

Violation policy (``DDL25_SENTINEL_POLICY`` = ``log`` | ``halt`` |
``skip``, or per-builder override):

- ``log``: record the violation in the flight ring + counters and warn.
- ``halt``: dump the flight ring and raise :class:`SentinelViolation`
  with the offending step's context — strategy, step index, metric,
  non-finite leaves, dump path.  The raise comes when the step's facts
  are folded: at the latest at the next guarded step (before its
  ``optimizer.step()``), or at :func:`flush`.  The record always names
  the exact step; trust the dump, not the traceback's timing.
- ``skip``: additionally *suppress the update on the card*: the
  parameters and the optimizer state written by a poisoned step are
  replaced by the snapshot taken before it, bitwise, with no host sync
  (each tensor's bits times ``ok`` plus the snapshot's bits times ``1 -
  ok``, as integers: three multi-tensor launches per dtype, capturable).
  Optimizer state that the poisoned step created (torch makes it at the
  first step) is replaced by zeros, which for Adam and SGD with momentum
  is the state of an optimizer that never stepped.  State kept on the
  host (Adam's ``step`` counter without ``capturable=True``) is restored
  when the step's facts fold, which a guarded step with such state waits
  for before its next ``optimizer.step()``.

Kept divergences from the JAX guard: a leaf whose squared norm overflows
float32 is flagged non-finite (JAX flags it only through the global
norm); the updates are ``new - old`` (JAX's are optax's, before they are
added), which differ by the rounding of the addition.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
from collections import deque

import torch

from ddl25spring_tpu_torch.obs.counters import counters as _counters
from ddl25spring_tpu_torch.obs.recorder import flight
from ddl25spring_tpu_torch.parallel.bucketing import parts
from ddl25spring_tpu_torch.utils.config import env_choice, env_flag

log = logging.getLogger(__name__)

POLICIES = ("log", "halt", "skip")
HEAD = ("loss", "grad_norm2", "update_norm2", "param_norm2", "ok")

_enabled: bool = env_flag("DDL25_SENTINELS")
_policy: str = env_choice("DDL25_SENTINEL_POLICY", POLICIES, "log")
_lock = threading.Lock()
_steps: dict[str, int] = {}  # host-side per-strategy step counter
_last_violation: dict | None = None
_violation_total: int = 0  # cumulative; a checkpoint gate polls it
_pending: deque = deque()  # staged facts, in step order
_fold_lock = threading.RLock()
_folding = threading.local()


class SentinelViolation(FloatingPointError):
    """A numerics sentinel tripped under the ``halt`` policy.

    Subclasses ``FloatingPointError`` so generic float-error handling
    still catches it, but the message (and ``.context``) carry the
    flight-record context a bare FloatingPointError loses: strategy,
    step index, the violating metric, the non-finite gradient leaves,
    and the flight-dump path.
    """

    def __init__(self, message: str, context: dict | None = None):
        super().__init__(message)
        self.context = dict(context or {})


def enabled() -> bool:
    """Are sentinels on?  Read by the builders when they build a step."""
    return _enabled


def enable(on: bool = True) -> None:
    """Flip the sentinel flag (affects steps built afterwards, exactly like
    :func:`ddl25spring_tpu_torch.obs.state.enable`)."""
    global _enabled
    _enabled = bool(on)


def policy() -> str:
    return _policy


def set_policy(mode: str) -> None:
    global _policy
    if mode not in POLICIES:
        raise ValueError(f"policy {mode!r} is not one of {POLICIES}")
    _policy = mode


@contextlib.contextmanager
def scoped(on: bool = True, policy: str | None = None):
    """Temporarily set the sentinel flag (and optionally the policy) —
    the test-harness entry, mirroring ``obs.scoped``."""
    global _enabled, _policy
    prev, prev_pol = _enabled, _policy
    _enabled = bool(on)
    if policy is not None:
        set_policy(policy)
    try:
        yield
    finally:
        _enabled, _policy = prev, prev_pol


def resolve(
    enabled: bool | None = None, policy: str | None = None
) -> tuple[bool, str]:
    """BUILD-time resolution of the sentinel gate + policy: ``enabled`` is
    the step builder's tri-state (None = follow the module flag now;
    True/False hard-enable/-disable), ``policy`` its override of the
    module policy.  Builders call this when the step is built and keep
    the answer, so a ``scoped()`` block around the builder decides, and
    one around the calls of the step does nothing."""
    on = _enabled if enabled is None else bool(enabled)
    mode = _policy if policy is None else policy
    if mode not in POLICIES:
        raise ValueError(f"policy {mode!r} is not one of {POLICIES}")
    return on, mode


def last_violation() -> dict | None:
    """The most recent violation record (host side), or None."""
    with _lock:
        return dict(_last_violation) if _last_violation else None


def violation_count() -> int:
    """Cumulative violations observed in this process (all strategies)."""
    with _lock:
        return _violation_total


def reset() -> None:
    """Clear host-side step counters, last violation and the facts not yet
    folded (test harness)."""
    global _last_violation, _violation_total
    with _lock:
        _steps.clear()
        _last_violation = None
        _violation_total = 0
        _pending.clear()


def keystr(path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` prints it: ``['blocks']['wq']``
    for dict keys, ``[0]`` for sequence indices."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in path)


# --------------------------------------------------------------- the guard


_consts: dict = {}


def _const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once: a CUDA graph cannot
    capture the copy of a Python list to the card, and every capture is
    preceded by eager steps that make these."""
    key = (tuple(values), dtype, str(device))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def _leaf_sq(trees: list, n: int, device) -> torch.Tensor:
    """``[len(trees), n]``: each tree's leaves' sums of squares (a leaf's, the
    sum of its tensors' squared norms), from one ``_foreach_norm`` over every
    tensor of every tree."""
    flat = [t for tree in trees for ts in tree for t in ts]
    idx = [j * n + i for j, tree in enumerate(trees) for i, ts in enumerate(tree) for _ in ts]
    out = torch.zeros(len(trees) * n, dtype=torch.float32, device=device)
    if flat:
        norms = torch.stack(torch._foreach_norm(flat)).float()
        out.index_add_(0, _const(idx, torch.long, device), norms * norms)
    return out.view(len(trees), n)


def _int_dtype(t: torch.Tensor) -> torch.dtype:
    return {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]


def int_views(results: list, fallback: list) -> dict:
    """``{integer dtype: (results' views, fallback's views)}``: each pair of
    tensors seen as integers of its width, grouped for :func:`select_views_`."""
    groups: dict = {}
    for new, old in zip(results, fallback, strict=True):
        it = _int_dtype(new)
        g = groups.setdefault(it, ([], []))
        g[0].append(new.view(it))
        g[1].append(old.view(it))
    return groups


def select_views_(groups: dict, ok: torch.Tensor) -> None:
    """``new = new if ok else old`` over :func:`int_views` groups, bitwise, in
    place, with no host sync: the bits times ``ok`` plus the fallback's bits
    times ``1 - ok``, three multi-tensor launches per width.  The fallback is
    consumed (zeroed where ``ok``)."""
    for it, (new, old) in groups.items():
        k = ok.to(it)
        torch._foreach_mul_(new, k)
        torch._foreach_mul_(old, 1 - k)
        torch._foreach_add_(new, old)


def guard(
    strategy: str,
    results,
    *,
    names=(),
    loss=None,
    grads=None,
    params=None,
    updates=None,
    fallback=None,
    weights=None,
    loss_weight: float = 1.0,
    group=None,
    comm=None,
    record: bool = True,
    has_loss: bool | None = None,
    sink=None,
    device=None,
    views=None,
    leaf_names=None,
    enabled: bool | None = None,
    policy: str | None = None,
):
    """The generic sentinel step, the counterpart of the JAX ``guard``:
    call it after the update, with the gate and policy resolved when the
    step was built (see :func:`resolve`).

    ``names`` are the global leaf paths (tuples, in the JAX pytree's
    flatten order); ``grads``, ``params`` and ``updates`` list, for each of
    them, this rank's tensors of that leaf (empty where the rank holds none
    of it), or are None (not measured).  ``weights[i]`` scales leaf ``i``'s
    squared norms before the sum over ``group`` (1 / the ranks holding a
    copy of it; None: all 1), ``loss_weight`` the loss.  ``results`` are the
    tensors the step just wrote (parameters and optimizer state on the
    card) and ``fallback`` what they held before: the ``skip`` policy writes
    the fallback back, bitwise, when the step is poisoned.  ``comm`` and
    ``group``: the all-reduce of the facts (None: this rank's alone).
    ``record``: whether this rank records (the group's rank 0) or only
    beats the flight clock; ``has_loss`` (default: ``loss`` given) whether
    the summed facts carry a loss (a pipeline's first stage records the
    last stage's).  ``sink(facts, meta)`` takes the facts instead of the
    default staging (the fused steps' window).  ``views`` (:func:`int_views`
    of ``results`` and ``fallback``) and ``leaf_names`` may come made: a
    step's guard keeps them from step to step.

    Disabled, this returns ``results`` **unchanged** — the same object,
    no operation run (the zero-cost contract).  Returns ``results``."""
    on = _enabled if enabled is None else bool(enabled)
    if not on:
        return results
    mode = _policy if policy is None else policy
    if mode not in POLICIES:
        raise ValueError(f"policy {mode!r} is not one of {POLICIES}")
    n = len(names)
    trees = [("grads", grads), ("updates", updates)]
    if device is None:
        device = next(t.device for tree in (grads, updates, params, [[loss]]) if tree
                      for ts in tree for t in ts if isinstance(t, torch.Tensor))
    with torch.no_grad(), torch.profiler.record_function("sentinels.guard"):
        present = [t for t in (grads, updates, params) if t is not None]
        sq = _leaf_sq(present, n, device)
        sums = (sq if weights is None else sq * _const(weights, torch.float32, device)).sum(1)
        head, j = [], 0
        for tree in (grads, updates, params):
            if tree is None:  # not measured: the host reads a negative as absent
                head.append(_const([-1.0], torch.float32, device))
            else:
                head.append(sums[j:j + 1])
                j += 1
        lv = (loss.detach().float().reshape(1) * loss_weight if loss is not None
              else _const([0.0], torch.float32, device))
        n_flagged = (grads is not None) + (updates is not None)
        flags = (~torch.isfinite(sq[:n_flagged])).float().reshape(-1)
        facts = torch.cat([lv, *head, _const([0.0], torch.float32, device), flags])
        if group is not None:
            comm.all_reduce_sum_([facts], group)
        # the loss and the norms finite (an unmeasured -1 is), no leaf flagged
        ok = torch.isfinite(facts[:3]).all() & (facts[len(HEAD):] == 0).all()
        facts[4] = ok.float()
        if mode == "skip" and (views is not None or fallback is not None):
            select_views_(views if views is not None else int_views(results, fallback), ok)
    if leaf_names is None:
        leaf_names = tuple(prefix + keystr(p) for prefix, tree in trees if tree is not None
                           for p in names)
    meta = {"strategy": strategy, "leaf_names": leaf_names, "mode": mode,
            "has_loss": loss is not None if has_loss is None else has_loss, "record": record}
    (sink or stage)(facts, meta)
    return results


def stage(facts: torch.Tensor, meta: dict, fixes=None) -> None:
    """Queue the facts of one step (``[n]``) or of a replayed window of
    fused steps (``[k, n]``, one step a row) for folding: at once on the
    CPU; on the card behind a copy into a pinned host slot and an event.
    ``fixes()`` runs at the fold of a step poisoned under ``skip``
    (host-side optimizer state)."""
    if facts.device.type != "cuda":
        _fold(facts, meta, fixes)
        return
    host = torch.empty(facts.shape, dtype=facts.dtype, pin_memory=True)
    host.copy_(facts, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with _lock:
        _pending.append((host, event, meta, fixes))


def flush(block: bool = True) -> None:
    """Fold the staged facts into the flight ring and the counters, in step
    order: with ``block``, all of them (waiting for the card); without,
    those whose copies have landed.  Raises :class:`SentinelViolation` for
    a folded violation under ``halt``.  Re-entered from the halt's own
    flight dump, it returns at once."""
    if getattr(_folding, "on", False):
        return
    with _fold_lock:
        _folding.on = True
        try:
            while True:
                with _lock:
                    if not _pending:
                        return
                    host, event, meta, fixes = _pending[0]
                    if not block and not event.query():
                        return
                    _pending.popleft()
                event.synchronize()
                _fold(host, meta, fixes)
        finally:
            _folding.on = False


def _fold(facts: torch.Tensor, meta: dict, fixes) -> None:
    for row in facts.reshape(-1, facts.shape[-1]).tolist():
        _on_step(row, fixes=fixes, **meta)


def _on_step(facts, *, strategy, leaf_names, mode, has_loss, record, fixes=None):
    """Host side of the guard: fold one step's facts into the flight ring +
    counters; enforce the policy on violation."""
    global _last_violation, _violation_total
    loss, gnorm2, unorm2, pnorm2, ok = facts[:len(HEAD)]
    flags = facts[len(HEAD):]
    violation = not ok
    if violation and mode == "skip" and fixes is not None:
        fixes()
    with _lock:
        step = _steps.get(strategy, 0)
        _steps[strategy] = step + 1
    if not record:
        # every rank of the group reached the same facts; the group's
        # rank 0 records them, the others count as liveness
        flight.beat()
        if violation and mode == "halt":
            raise SentinelViolation(
                f"sentinel violation in strategy={strategy!r} step={step} "
                "(recorded by the group's rank 0)",
                context={"strategy": strategy, "step": step})
        return

    gnorm = math.sqrt(gnorm2) if gnorm2 >= 0 else None
    ratio = (
        math.sqrt(unorm2) / (math.sqrt(pnorm2) + 1e-20)
        if unorm2 >= 0 and pnorm2 >= 0 else None
    )
    bad_leaves = [nm for nm, f in zip(leaf_names, flags) if f > 0]

    if has_loss:
        _counters.add(f"{strategy}.sentinel.loss", loss)
    if gnorm is not None and math.isfinite(gnorm):
        _counters.add(f"{strategy}.sentinel.grad_norm", gnorm)
    if ratio is not None and math.isfinite(ratio):
        _counters.add(f"{strategy}.sentinel.update_ratio", ratio)

    rec = {
        "strategy": strategy,
        "step": step,
        "policy": mode,
        "violation": violation,
        **({"loss": loss} if has_loss else {}),
        **({"grad_norm": gnorm} if gnorm is not None else {}),
        **({"update_ratio": ratio} if ratio is not None else {}),
        **({"nonfinite_leaves": bad_leaves} if bad_leaves else {}),
    }
    if not violation:
        flight.record(kind="step", **rec)
        return

    # name the single most specific metric that tripped — the halt
    # message and the dump must identify it without post-processing
    # (leaf names arrive prefixed "grads..."/"updates...")
    if bad_leaves:
        metric = bad_leaves[0]
    elif has_loss and not math.isfinite(loss):
        metric = "loss"
    else:
        metric = "grad_norm"
    rec["violating_metric"] = metric
    flight.record(kind="violation", **rec)
    _counters.add("sentinel.violations", 1.0)
    with _lock:
        _last_violation = dict(rec)
        _violation_total += 1

    msg = (
        f"sentinel violation in strategy={strategy!r} step={step}: "
        f"{metric} went non-finite"
        + (f" (loss={loss})" if has_loss else "")
        + (f"; non-finite leaves: {bad_leaves}" if bad_leaves else "")
    )
    if mode == "halt":
        path = None
        try:
            path = flight.dump(reason="sentinel_halt")
        except Exception as e:  # noqa: BLE001 — the dump must not
            # mask the violation itself
            log.warning("flight dump failed during halt: %s", e)
        raise SentinelViolation(
            msg + (f"; flight record dumped to {path}" if path else ""),
            context=dict(rec, flight_dump=path),
        )
    if mode == "skip":
        log.warning("%s; policy=skip — update suppressed on device", msg)
    else:
        log.warning("%s; policy=log — continuing", msg)


# ------------------------------------------------------ the builders' guard


def named_leaves(model: torch.nn.Module) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` of ``model``'s parameters, as the optimizer's leaves:
    the JAX pytree's paths (:func:`~ddl25spring_tpu_torch.parallel.rules.
    leaf_paths`) of its ``param_tree()`` (a stacked LLaMA leaf is one
    leaf), else flax's names for its parameters (the bridged ResNet), else
    torch's."""
    from ddl25spring_tpu_torch.models.flax_bridge import flax_path
    from ddl25spring_tpu_torch.parallel.dp import param_leaves
    from ddl25spring_tpu_torch.parallel.rules import leaf_paths

    if hasattr(model, "param_tree"):
        return [(tuple(p.split("/")), leaf)
                for p, leaf in zip(leaf_paths(model), param_leaves(model), strict=True)]
    out = []
    for name, p in model.named_parameters():
        try:
            path = flax_path(name)
        except (IndexError, KeyError):  # not a flax-bridged module: torch's names
            path = tuple(name.split("."))
        out.append((path, p))
    return out


def global_names(paths, group=None) -> list[tuple]:
    """The sorted union of every rank's leaf paths over ``group`` (ranks that
    hold different parts of one model, as pipeline stages do), from one
    ``all_gather_object`` when the step is built; ``paths`` sorted alone
    without a group."""
    import torch.distributed as dist

    mine = sorted(set(map(tuple, paths)))
    if group is None and not dist.is_initialized():
        return mine
    everyone: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(everyone, mine, group=group)
    return sorted({tuple(p) for ps in everyone for p in ps})


class Guard:
    """The sentinel of one built train step, around its ``optimizer.step()``:
    :meth:`begin` before it, :meth:`end` after it (and after the step's own
    reductions), as the JAX guard sits after ``tx.update``.

    ``leaves``: this rank's ``(path, leaf)`` pairs (the parameters the
    optimizer steps); ``names``: the global leaf paths (default: these
    paths, sorted); ``weights``: ``{path: weight}`` for the sum over
    ``group`` (default 1); ``loss_weight``: the loss's; ``record``: whether
    this rank records.  The rest as :func:`guard`."""

    def __init__(self, strategy: str, leaves, optimizer: torch.optim.Optimizer, *,
                 policy: str, names=None, weights=None, loss_weight: float = 1.0,
                 group=None, comm=None, record: bool = True):
        self.strategy, self.optimizer, self.mode = strategy, optimizer, policy
        paths = [tuple(p) for p, _ in leaves]
        self.names = sorted(paths) if names is None else [tuple(p) for p in names]
        pos = {p: i for i, p in enumerate(self.names)}
        self.leaf_parts: list[list[torch.Tensor]] = [[] for _ in self.names]
        for path, leaf in leaves:
            self.leaf_parts[pos[tuple(path)]].extend(parts(leaf))
        self.params = [t for ts in self.leaf_parts for t in ts]
        self.weights = (None if weights is None
                        else [float(weights.get(p, 1.0)) for p in self.names])
        self.loss_weight, self.group, self.comm, self.record = loss_weight, group, comm, record
        if group is not None and comm is None:
            raise ValueError("a guard reduced over a group needs the rank's Comm")
        self.device = self.params[0].device
        self.leaf_names = tuple(prefix + keystr(p) for prefix in ("grads", "updates")
                                for p in self.names)
        self._snap: list[torch.Tensor] | None = None
        self._state_key = None
        self._fresh: set = set()
        self._host: list = []
        self._window = None
        self._muted = False
        self._blocks = policy == "halt"

    # ---- around the optimizer's step --------------------------------------

    @torch.no_grad()
    def begin(self) -> None:
        """Fold what is due, and snapshot the parameters (and, under
        ``skip``, the optimizer state) before ``optimizer.step()``."""
        if self._window is None:
            flush(block=self._blocks)
        dst, src = [], []
        if self._snap is None:
            self._snap = [p.detach().clone() for p in self.params]
        else:
            dst, src = list(self._snap), list(self.params)
        if self.mode == "skip":
            self._fresh = {id(p) for p in self.params if not self.optimizer.state.get(p)}
            live, saved, host = self._state()
            self._host = [(t, t.clone()) for t in host]
            dst += saved
            src += live
            # a step that makes state: what existed before it, by tensor
            self._saved_by_id = ({id(v): b for v, b in zip(live, saved)} if self._fresh
                                 else {})
        if dst:
            torch._foreach_copy_(dst, src)

    def _state(self):
        """The optimizer state's tensors: ``(on the card, their snapshot
        buffers, on the host)``, and the select's integer views of the
        parameters and the card's state beside their snapshots, kept while
        each parameter keeps its state dict and its entries (torch's
        optimizers update their state tensors in place)."""
        states = [self.optimizer.state.get(p) for p in self.params]
        key = tuple((id(st), len(st)) if st else None for st in states)
        if self._state_key != key:
            tensors = [(id(p), v) for p, st in zip(self.params, states) if st
                       for v in st.values() if isinstance(v, torch.Tensor)]
            live = [v for _, v in tensors if v.device == self.device]
            host = [v for _, v in tensors if v.device != self.device]
            saved = [torch.empty_like(v) for v in live]
            self._state_cache = (live, saved, host)
            self._views = int_views(self.params + live, self._snap + saved)
            self._state_owner = [pid for pid, v in tensors if v.device == self.device]
            self._state_key = key
        return self._state_cache

    def _by_leaf(self, flat: list) -> list[list[torch.Tensor]]:
        """``flat`` (one tensor per parameter, in :attr:`params`' order) cut
        into the leaves' lists."""
        out, i = [], 0
        for ts in self.leaf_parts:
            out.append(flat[i:i + len(ts)])
            i += len(ts)
        return out

    @torch.no_grad()
    def updates(self) -> list[list[torch.Tensor]]:
        """Each leaf's update, the parameters now less the snapshot: call it
        before anything but the optimizer writes the parameters (weight
        averaging does)."""
        return self._by_leaf(torch._foreach_sub(self.params, self._snap))

    def end(self, loss, updates=None) -> None:
        """After the step: the facts (``updates`` from :meth:`updates` when
        the step changed the parameters after the optimizer), their sum
        over the group, the ``skip`` select and the record."""
        if updates is None:
            updates = self.updates()
        views = None
        if self.mode == "skip":
            live, saved, host = self._state()
            if self._fresh:
                # the state this step made: its fallback is a fresh state's
                # zeros (the host's, restored when the facts fold)
                self._host += [(t, torch.zeros_like(t)) for t in host
                               if not any(t is h for h, _ in self._host)]
                fallback = [torch.zeros_like(v) if pid in self._fresh
                            else self._saved_by_id[id(v)]
                            for pid, v in zip(self._state_owner, live)]
                views = int_views(self.params + live, self._snap + fallback)
            else:
                views = self._views
        # the snapshot is the select's fallback, and the select consumes it:
        # guard takes the old parameters' norms before it selects
        grads = [[p.grad for p in ts if p.grad is not None] for ts in self.leaf_parts]
        guard(self.strategy, None, names=self.names, loss=loss, grads=grads,
              params=self._by_leaf(self._snap), updates=updates, views=views,
              weights=self.weights, loss_weight=self.loss_weight, group=self.group,
              comm=self.comm, record=self.record, has_loss=True, sink=self._sink,
              device=self.device, leaf_names=self.leaf_names, enabled=True,
              policy=self.mode)

    # ---- where the facts go ---------------------------------------------

    def _sink(self, facts, meta) -> None:
        if self._muted:
            return
        if self._window is not None:
            if self._host:
                raise RuntimeError(
                    "a guarded step inside a CUDA graph keeps optimizer state on the host "
                    "(Adam's step counter): build the optimizer with capturable=True")
            rows, i = self._window
            rows[i].copy_(facts)
            self._window = (rows, i + 1)
            self._meta = meta
            return
        host = list(self._host)
        fixes = None
        if host:
            self._blocks = True

            def fixes():
                for t, saved in host:
                    t.copy_(saved)

        stage(facts, meta, fixes)

    @contextlib.contextmanager
    def muted(self):
        """Steps run inside record nothing (a capture's warm-up, which the
        fused steps undo)."""
        self._muted = True
        try:
            yield
        finally:
            self._muted = False

    @contextlib.contextmanager
    def capture(self, k: int):
        """The ``k`` steps run inside write their facts into the rows of a
        static ``[k, n]`` buffer (a CUDA graph's capture); after each replay
        :meth:`window_done` stages them."""
        self.rows = torch.zeros(k, len(HEAD) + 2 * len(self.names), device=self.device)
        self._window = (self.rows, 0)
        try:
            yield
        except BaseException:
            self._window = None
            raise
        _, i = self._window
        self._window = None
        if i != k:
            raise RuntimeError(f"the guard saw {i} steps in a capture of {k}")

    def window_done(self) -> None:
        """Stage the facts of the window a replay just wrote."""
        stage(self.rows, self._meta)


# a snapshot or dump of the flight ring folds what the card has finished
flight.add_flusher(flush)
