"""The training strategies' ``describe()`` registry and their collective
signatures: the counterpart of the registry half of the JAX package's
``obs/xla_analytics.py`` (``STRATEGIES``, ``strategy_mesh``,
``describe_strategy``, ``collective_totals``, ``check_signature``).

JAX reads each strategy's collectives off its compiled HLO.  The port has
no compiled program to read: it issues every collective itself, through
:class:`~ddl25spring_tpu_torch.parallel.comm.Comm`, which records them while
asked (``Comm.start_recording``: kind, result bytes, dtype, group size,
ranks).  So a strategy's inventory here is what one step of its train step
issued on this rank: :func:`run_strategy` builds the step from the
strategy's ``describe(mesh, ...)`` (in ``parallel/``), runs it once with
recording on, names the mesh axes of each record from its ranks (JAX's
``_axes_of_groups``), and judges the step against the describe's
``expected`` signature with :func:`check_signature`, JAX's schema:
``forbidden``, ``scalar_bytes``, and per kind ``count``,
``min_count``/``max_count``, ``min_bytes``/``max_bytes`` and ``axes``.

Two keys of that schema read the device, not the inventory:

- ``memory.max_peak_hbm_bytes``: the strategy's ``budget_bytes`` in
  :data:`STRATEGIES` (the describes declare none; :func:`run_strategy` adds
  it to their ``expected``), against, on the card, the step's
  ``torch.cuda.max_memory_allocated`` above what was allocated before the
  describe built its state; on the CPU it is not judged, and the report
  says so (``not_judged``);
- ``donation``: not applicable.  A torch optimizer updates the parameters
  and its state in place, so there is no fresh output buffer to alias; the
  report says so too.

Nothing passes silently: a key that is not judged is named in the report's
``not_judged`` list.  The eight ``serve-*`` programs of the JAX registry
(:data:`SERVE_STRATEGIES`) are not described here yet: they raise
``NotImplementedError`` (ROADMAP A12b).  JAX's HLO parsers, its roofline
projection and ``compile_strategy`` have no counterpart.
"""

from __future__ import annotations

import importlib
import math
from typing import Any

# name -> (module of describe(), the JAX axes, the default mesh sizes, the
# describe's kwargs, the peak-memory budget of one step on the card).  The
# names, axes, meshes and budgets are the JAX registry's
# (obs/xla_analytics.py:808-965).
_MIB = 1024 * 1024
STRATEGIES: dict[str, dict[str, Any]] = {
    "dp": {"module": "ddl25spring_tpu_torch.parallel.dp", "axes": ("data",),
           "default_mesh": (4,), "budget_bytes": 4 * _MIB},
    "dp-overlap": {"module": "ddl25spring_tpu_torch.parallel.dp", "axes": ("data",),
                   "default_mesh": (4,), "kwargs": {"overlap": True},
                   "budget_bytes": 4 * _MIB},
    "zero1": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
              "default_mesh": (4,), "kwargs": {"stage": 1}, "budget_bytes": 4 * _MIB},
    "zero2": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
              "default_mesh": (4,), "kwargs": {"stage": 2}, "budget_bytes": 4 * _MIB},
    "zero3": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
              "default_mesh": (4,), "kwargs": {"stage": 3}, "budget_bytes": 4 * _MIB},
    "zero3-prefetch": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
                       "default_mesh": (4,), "kwargs": {"stage": 3, "prefetch": True},
                       "budget_bytes": 24 * _MIB},
    "zero1-overlap": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
                      "default_mesh": (4,), "kwargs": {"stage": 1, "overlap": True},
                      "budget_bytes": 4 * _MIB},
    "zero2-overlap": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
                      "default_mesh": (4,), "kwargs": {"stage": 2, "overlap": True},
                      "budget_bytes": 4 * _MIB},
    "zero3-overlap": {"module": "ddl25spring_tpu_torch.parallel.zero", "axes": ("data",),
                      "default_mesh": (4,), "kwargs": {"stage": 3, "overlap": True},
                      "budget_bytes": 4 * _MIB},
    "pipeline": {"module": "ddl25spring_tpu_torch.parallel.pipeline",
                 "axes": ("data", "stage"), "default_mesh": (1, 2),
                 "budget_bytes": 8 * _MIB},
    "het_pipeline": {"module": "ddl25spring_tpu_torch.parallel.het_pipeline",
                     "axes": ("data", "stage"), "default_mesh": (1, 2),
                     "budget_bytes": 8 * _MIB},
    "tp": {"module": "ddl25spring_tpu_torch.parallel.tp", "axes": ("data", "model"),
           "default_mesh": (1, 2), "budget_bytes": 2 * _MIB},
    "sp": {"module": "ddl25spring_tpu_torch.parallel.sp", "axes": ("data", "seq"),
           "default_mesh": (1, 2), "budget_bytes": 2 * _MIB},
    "ep": {"module": "ddl25spring_tpu_torch.parallel.ep", "axes": ("expert",),
           "default_mesh": (4,), "budget_bytes": 4 * _MIB},
    "dp-rules": {"module": "ddl25spring_tpu_torch.parallel.rules", "axes": ("data",),
                 "default_mesh": (4,), "kwargs": {"table": "dp"}, "budget_bytes": 4 * _MIB},
    "zero3-rules": {"module": "ddl25spring_tpu_torch.parallel.rules", "axes": ("data",),
                    "default_mesh": (4,), "kwargs": {"table": "zero3"},
                    "budget_bytes": 4 * _MIB},
}

#: the JAX registry's serving programs, not described in the port yet
SERVE_STRATEGIES = (
    "serve-decode", "serve-prefill", "serve-prefill-cached", "serve-decode-tp",
    "serve-prefill-tp", "serve-decode-zero3stream", "serve-draft", "serve-verify",
)

#: the ranks a world needs to run every training strategy on its default mesh
WORLD = max(math.prod(info["default_mesh"]) for info in STRATEGIES.values())

NOT_APPLICABLE_DONATION = ("donation: not applicable: a torch optimizer updates the "
                           "parameters and its state in place, so no output buffer "
                           "could alias an input")


def _known(name: str):
    if name in SERVE_STRATEGIES:
        raise NotImplementedError(
            f"strategy {name!r}: the serving programs' describe() is not ported yet "
            "(ROADMAP A12b)")
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(STRATEGIES)}")
    return STRATEGIES[name]


def budget_bytes(name: str) -> int | None:
    """The peak-memory budget of one step of training strategy ``name``;
    None for any other name (the serving programs, the bench)."""
    info = STRATEGIES.get(name)
    return None if info is None else int(info["budget_bytes"])


def mesh_sizes(name: str, sizes: tuple[int, ...] | None = None) -> dict[str, int]:
    """``{axis: size}`` of the strategy's mesh: ``sizes`` positionally onto
    its axes (extra trailing sizes fold into the last axis, missing leading
    ones are 1), the default mesh when None: JAX's ``strategy_mesh`` rule."""
    axes = _known(name)["axes"]
    sizes = tuple(sizes or STRATEGIES[name]["default_mesh"])
    if len(sizes) > len(axes):
        sizes = sizes[: len(axes) - 1] + (math.prod(sizes[len(axes) - 1:]),)
    elif len(sizes) < len(axes):
        sizes = (1,) * (len(axes) - len(sizes)) + sizes
    return dict(zip(axes, sizes))


def strategy_mesh(name: str, world_mesh, sizes: tuple[int, ...] | None = None):
    """The strategy's grid on the first ranks of ``world_mesh``'s world (a
    :class:`~ddl25spring_tpu_torch.utils.mesh.Mesh`): ``data x X`` with ``X``
    the strategy's second axis (``stage``, ``seq``, ``model``, ``expert``; a
    data-only strategy's is a ``stage`` axis of 1).  Every rank of the world
    must call it; the ranks outside the grid get None."""
    shape = mesh_sizes(name, sizes)
    data = shape.get("data", 1)
    other = {k: v for k, v in shape.items() if k != "data"}
    if not other:
        return world_mesh.sub(data, 1)
    ((axis, size),) = other.items()
    return world_mesh.sub(data, **{"stages" if axis == "stage" else axis: size})


def describe_strategy(name: str, mesh, **overrides: Any) -> dict[str, Any]:
    """The strategy's ``describe(mesh, **kwargs)``: ``{"fn", "args",
    "lowered", "meta", "expected"}``, ``fn(*args)`` one train step on this
    rank of ``mesh``."""
    info = _known(name)
    mod = importlib.import_module(info["module"])
    return mod.describe(mesh, **dict(info.get("kwargs", {}), **overrides))


def axes_of(ranks, grid) -> list[str]:
    """The grid axes along which ``ranks`` differ (JAX's
    ``_axes_of_groups``/``_axes_of_pairs``): a group over one line of the
    ``data`` axis is ``["data"]``."""
    coords = [grid.coords(r) for r in ranks]
    return [name for d, name in enumerate(grid.names)
            if len({c[d] for c in coords}) > 1]


def wire_bytes(kind: str, result_bytes: int, group_size: int | None) -> int:
    """Bytes one execution moves per rank (ring accounting), from the result
    bytes: JAX's ``_wire_bytes``."""
    n = group_size or 0
    frac = (n - 1) / n if n > 1 else 1
    if kind == "all-reduce":
        return int(2 * result_bytes * frac)
    if kind in ("all-gather", "all-to-all"):
        return int(result_bytes * frac)
    if kind == "reduce-scatter":
        return int(result_bytes * (n - 1 if n > 1 else 1))
    return int(result_bytes)


def inventory(records: list[dict], grid) -> list[dict]:
    """Records of :meth:`~ddl25spring_tpu_torch.parallel.comm.Comm.
    stop_recording` as op records: each with its ``axes`` on ``grid`` and its
    ``wire_bytes``."""
    out = []
    for r in records:
        op = dict(r, axes=axes_of(r["ranks"], grid))
        op["wire_bytes"] = wire_bytes(op["kind"], op["result_bytes"], op["group_size"])
        out.append(op)
    return out


def collective_totals(ops: list[dict]) -> dict[str, dict[str, int]]:
    """Per kind: executions, result bytes and wire bytes over every
    execution, and op sites: JAX's ``collective_totals``."""
    tot: dict[str, dict[str, int]] = {}
    for op in ops:
        t = tot.setdefault(op["kind"], {"count": 0, "result_bytes": 0, "wire_bytes": 0,
                                        "sites": 0})
        t["sites"] += 1
        t["count"] += op["count"]
        t["result_bytes"] += op["result_bytes"] * op["count"]
        t["wire_bytes"] += op["wire_bytes"] * op["count"]
    return tot


def totals_by_axis(ops: list[dict]) -> dict[str, dict[str, int]]:
    """Per mesh axis (axes joined with ``,``; ``-`` for none): executions,
    result and wire bytes."""
    tot: dict[str, dict[str, int]] = {}
    for op in ops:
        key = ",".join(op["axes"]) or "-"
        t = tot.setdefault(key, {"count": 0, "result_bytes": 0, "wire_bytes": 0})
        t["count"] += op["count"]
        t["result_bytes"] += op["result_bytes"] * op["count"]
        t["wire_bytes"] += op["wire_bytes"] * op["count"]
    return tot


def check_signature(report: dict[str, Any], expected: dict[str, Any]) -> list[str]:
    """The violations of ``expected`` (JAX's schema, see the module
    docstring) by one step's ``report``; empty when the signature holds.
    ``memory`` is judged when ``report["memory"]["peak_bytes"]`` is a number
    (the card), ``donation`` never: :func:`run_strategy` names both in
    ``not_judged`` when it does not judge them."""
    viols: list[str] = []
    want_mem = expected.get("memory")
    peak = (report.get("memory") or {}).get("peak_bytes")
    if want_mem and "max_peak_hbm_bytes" in want_mem and peak is not None \
            and peak > want_mem["max_peak_hbm_bytes"]:
        viols.append(f"memory: peak {peak} B exceeds the "
                     f"{want_mem['max_peak_hbm_bytes']} B budget")
    ops = report["collectives"]["ops"]
    totals = report["collectives"]["totals"]
    scalar = int(expected.get("scalar_bytes", 0))
    for kind in expected.get("forbidden", ()):
        bad = [o for o in ops if o["kind"] == kind and o["result_bytes"] > scalar]
        if bad:
            viols.append(f"forbidden collective {kind}: {len(bad)} op(s), e.g. "
                         f"{bad[0]['result_bytes']} B over {bad[0]['axes']}")
    for kind, want in expected.items():
        if kind in ("forbidden", "scalar_bytes", "memory", "donation") or \
                not isinstance(want, dict):
            continue
        kops = [o for o in ops if o["kind"] == kind]
        count = sum(o["count"] for o in kops)
        tbytes = totals.get(kind, {}).get("result_bytes", 0)
        if "count" in want and count != want["count"]:
            viols.append(f"{kind}: expected exactly {want['count']} executions, "
                         f"measured {count}")
        if "min_count" in want and count < want["min_count"]:
            viols.append(f"{kind}: expected >= {want['min_count']} executions, "
                         f"measured {count}")
        if "max_count" in want and count > want["max_count"]:
            viols.append(f"{kind}: expected <= {want['max_count']} executions, "
                         f"measured {count}")
        if "min_bytes" in want and tbytes < want["min_bytes"]:
            viols.append(f"{kind}: expected >= {want['min_bytes']} total payload bytes, "
                         f"measured {tbytes}")
        if "max_bytes" in want and tbytes > want["max_bytes"]:
            viols.append(f"{kind}: expected <= {want['max_bytes']} total payload bytes, "
                         f"measured {tbytes}")
        if "axes" in want:
            allowed = set(want["axes"])
            for o in kops:
                if o["result_bytes"] > scalar and not set(o["axes"]) <= allowed:
                    viols.append(f"{kind}: an op groups over {o['axes']}, expected a "
                                 f"subset of {sorted(allowed)}")
    return viols


def run_strategy(name: str, mesh, **overrides: Any) -> dict[str, Any]:
    """One step of strategy ``name`` on this rank of ``mesh`` (from
    :func:`strategy_mesh`), recorded and judged.  Every rank of the mesh must
    call it.  Returns ``{"strategy", "rank", "mesh", "lowered", "meta",
    "expected", "collectives": {"ops", "totals", "by_axis"}, "memory",
    "signature_violations", "not_judged"}``."""
    import torch

    dev = mesh.device
    on_card = dev.type == "cuda"
    if on_card:
        # the first product of a thread on a stream takes a cuBLAS workspace
        # (32 MiB on Hopper) for the process's life: take this thread's and
        # the autograd thread's before the baseline, not inside the step
        w = torch.ones(8, 8, device=dev, requires_grad=True)
        (w @ w).sum().backward()
        del w
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
    d = describe_strategy(name, mesh, **overrides)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.comm.start_recording()
    try:
        d["fn"](*d["args"])
    finally:
        records = mesh.comm.stop_recording()
    not_judged = [NOT_APPLICABLE_DONATION]
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    else:
        peak = None
        not_judged.insert(0, "memory: not judged on the CPU: the budget is judged against "
                             "torch.cuda.max_memory_allocated over the step on the card")
    ops = inventory(records, mesh.grid)
    # the budget lives in STRATEGIES only: the describes declare no memory
    budget = budget_bytes(name)
    expected = dict(d.get("expected", {}))
    if budget is not None:
        expected["memory"] = {"max_peak_hbm_bytes": budget}
    report = {
        "strategy": name,
        "rank": mesh.rank,
        "mesh": dict(zip(mesh.grid.names, mesh.grid.shape)),
        "lowered": d.get("lowered", "train_step"),
        "meta": d.get("meta", {}),
        "expected": expected,
        "collectives": {"ops": ops, "totals": collective_totals(ops),
                        "by_axis": totals_by_axis(ops)},
        "memory": {"peak_bytes": peak, "budget_bytes": budget},
        "not_judged": not_judged,
    }
    report["signature_violations"] = check_signature(report, report["expected"])
    return report


def run_training_strategies(world_mesh, names=None, variants=None) -> dict[str, dict | None]:
    """:func:`run_strategy` for each of ``names`` (default: every training
    strategy) on its default mesh inside ``world_mesh``'s world, one after the
    other, then each of ``variants`` (``{label: (name, overrides)}``: a
    strategy's describe with other keyword arguments, e.g. ``("zero3",
    {"workload": "llama"})``); this rank's reports by name or label (None
    where the grid leaves this rank out).  Every rank of the world must call
    it."""
    jobs = [(name, name, {}) for name in (STRATEGIES if names is None else names)]
    jobs += [(label, name, kw) for label, (name, kw) in (variants or {}).items()]
    out = {}
    for label, name, kw in jobs:
        mesh = strategy_mesh(name, world_mesh)
        out[label] = run_strategy(name, mesh, **kw) if mesh is not None else None
        world_mesh.comm.barrier()
    return out


def _world_rank(rdv, names, variants, device):
    from ddl25spring_tpu_torch.utils.mesh import init_mesh

    with init_mesh(rdv, rdv.world, 1, device) as mesh:
        return run_training_strategies(mesh, names, variants)


def run_in_world(names=None, device: str = "cuda", variants=None,
                 timeout: float = 600.0) -> list[dict]:
    """:func:`run_training_strategies` in one spawned world of :data:`WORLD`
    ranks on ``device`` (the card unless ``"cpu"`` is asked for): each rank's
    reports, in rank order."""
    from ddl25spring_tpu_torch.parallel.launch import spawn

    return spawn(_world_rank, WORLD, None if names is None else list(names), variants,
                 device, timeout=timeout)


def format_report(r: dict[str, Any]) -> str:
    """One line: the strategy, its kinds (executions, result bytes, axes),
    the peak against the budget, and the verdict."""
    kinds = []
    for kind, t in sorted(r["collectives"]["totals"].items()):
        axes = sorted({a for o in r["collectives"]["ops"] if o["kind"] == kind
                       for a in o["axes"]})
        kinds.append(f"{kind} x{t['count']} {t['result_bytes']} B [{','.join(axes) or '-'}]")
    mem = r["memory"]
    peak = ("peak not judged (CPU)" if mem["peak_bytes"] is None
            else f"peak {mem['peak_bytes']} B of {mem['budget_bytes']} B")
    verdict = "ok" if not r["signature_violations"] else \
        "VIOLATED: " + "; ".join(r["signature_violations"])
    mesh = "x".join(str(v) for v in r["mesh"].values())
    return f"{r['strategy']:<15} mesh {mesh} rank {r['rank']}: " + \
        ("; ".join(kinds) or "no collectives") + f"; {peak}; {verdict}"
