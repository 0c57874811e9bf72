"""The runtime memory observatory of the port: the counterpart of the JAX
package's ``obs/memscope.py``, measuring what the static accounting promised.

- :func:`live_total_bytes` -- the live tensor bytes of a device: on the
  card ``torch.cuda.memory_allocated`` (the caching allocator's in-use
  blocks, a captured graph's included: a host-side counter, no sync); on
  the CPU, whose allocator keeps no count, a walk of the live tensors the
  garbage collector tracks, each storage counted once (~0.1 s a walk, so a
  CPU loop samples one tick in :data:`CPU_EVERY`).
- :func:`live_array_summary` -- the live tensors by device, with the
  largest named by shape and dtype; every flight dump carries it, so an
  OOM-shaped death names its offenders from ``flight.json`` alone.
- :func:`host_rss_bytes` -- the resident set size from ``/proc/self/statm``:
  the host-side leak axis.
- :class:`MemScope` -- the per-loop sampler: bounded :class:`Series` of live
  bytes and RSS, exact high-water marks, timeline ``mem_sample`` events and
  a windowed monotone-growth detector (:class:`GrowthDetector`) that fires
  a flight ``kind="mem"`` violation naming the growing resource.
- :func:`pool_snapshot` / :func:`pool_leak_check` -- the KV page pool's
  occupancy, cache-held vs table-held split, refcount histogram and
  fragmentation, and the drain-time leak detector.
- :func:`mem_record` / :func:`write_run_mem` -- the ``record: "mem"`` row
  (keyed strategy / mesh / host like the perf rows) and ``mem.json``, read
  by the report's Memory section and gated by ``tools/mem_report.py``.

**Budget against measured:** ``budget_bytes`` is the accounted persistent
footprint -- for serving the engine's static bill of parameters and pools
plus the whole cuBLAS workspaces (:func:`blas_workspace_bytes`) its warm-up
made, against the high-water above what the process held before the
engine; for training the live bytes of the first sampled step -- and the
measured high-water must sit within ``budget_bytes * (1 + tolerance)``.  Everything here observes from the host: with
``DDL25_MEMSCOPE=0`` (or obs off) nothing is sampled, and with it on a loop
launches the kernels it launches without it.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import random
import re
import time
from collections import deque
from typing import Any, Callable, Iterable

import numpy as np

from ddl25spring_tpu_torch.obs import state
from ddl25spring_tpu_torch.utils.config import env_flag, env_float

MEM_BASENAME = "mem.json"
SERIES_CAP = 512

#: default budget band: the measured high-water live bytes may exceed the
#: accounted budget by this fraction before the gate fails
DEFAULT_TOLERANCE = 0.5

#: a CPU loop's sampling cadence (one tick in N): its reading walks every
#: live tensor, where the card's is one counter read
CPU_EVERY = 8

#: sampler gate -- ``DDL25_MEMSCOPE=0`` turns every sampler into a no-op
#: even when obs is on
_flag_enabled = env_flag("DDL25_MEMSCOPE", True)


def enabled() -> bool:
    """True when memory sampling is on: obs enabled AND the
    ``DDL25_MEMSCOPE`` flag not zeroed."""
    return _flag_enabled and state.enabled()


def set_flag(on: bool) -> None:
    global _flag_enabled
    _flag_enabled = bool(on)


@contextlib.contextmanager
def scoped(on: bool):
    """Temporarily force the memscope flag (tests; composes with
    ``obs.state.scoped``)."""
    global _flag_enabled
    prev = _flag_enabled
    _flag_enabled = bool(on)
    try:
        yield
    finally:
        _flag_enabled = prev


def tolerance() -> float:
    """The budget band's width (``DDL25_MEM_TOL`` overrides)."""
    return env_float("DDL25_MEM_TOL", DEFAULT_TOLERANCE)


def default_every(device) -> int:
    """The sampling cadence of a loop on ``device``: every tick on the card,
    one in :data:`CPU_EVERY` on the CPU."""
    return 1 if _resolve(device).type == "cuda" else CPU_EVERY


# ------------------------------------------------------------- host side


def host_rss_bytes() -> int | None:
    """Resident set size of this process from ``/proc/self/statm``
    (field 2, in pages) -- None where procfs is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, IndexError, ValueError):
        return None


# ----------------------------------------------------------- device side


def _resolve(device):
    import torch

    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _subclasses(cls) -> set:
    """``cls`` and every subclass of it now defined."""
    out = {cls}
    for sub in cls.__subclasses__():
        out |= _subclasses(sub)
    return out


def live_tensors(device_type: str | None = None) -> list[tuple[int, Any]]:
    """``(storage bytes, tensor)`` for every live tensor the garbage
    collector tracks (on ``device_type`` when given), one entry per
    storage: views of one buffer count once.  Tensors without a storage
    (sparse, meta, already freed) are left out; never raises."""
    import torch

    out: list[tuple[int, Any]] = []
    seen: set[tuple[str, int]] = set()
    objs = gc.get_objects()
    # the filter runs in C: a type lookup in the set of tensor classes
    kinds = _subclasses(torch.Tensor)
    for o in itertools.compress(objs, map(kinds.__contains__, map(type, objs))):
        try:
            dev = o.device
            if device_type is not None and dev.type != device_type:
                continue
            st = o.untyped_storage()
            key = (str(dev), st.data_ptr())
            nbytes = st.nbytes()
        except (RuntimeError, NotImplementedError):
            continue
        if key[1] == 0 or key in seen:
            continue
        seen.add(key)
        out.append((int(nbytes), o))
    return out


def live_total_bytes(device=None) -> int:
    """Live tensor bytes on ``device`` (default: the card when there is one,
    else the CPU): ``torch.cuda.memory_allocated`` on a card, the storages
    of the CPU's live tensors (:func:`live_tensors`) elsewhere."""
    import torch

    dev = _resolve(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return int(torch.cuda.memory_allocated(index))
    return sum(n for n, _ in live_tensors(dev.type))


def blas_workspace_bytes(device=None) -> int:
    """The cuBLAS workspace PyTorch keeps for each (handle, stream) pair
    that runs a product on ``device``, for the life of the process: the sum
    of ``CUBLAS_WORKSPACE_CONFIG``'s ``:KiB:count`` pairs, else PyTorch's
    default (32 MiB on a Hopper card, 8 MiB + 128 KiB before it).  0 on the
    CPU.  A new stream's first product grows ``memory_allocated`` by exactly
    this (33,554,432 B on an H100)."""
    import torch

    dev = _resolve(device)
    if dev.type != "cuda":
        return 0
    pairs = re.findall(r":(\d+):(\d+)", os.environ.get("CUBLAS_WORKSPACE_CONFIG", ""))
    if pairs:
        return sum(int(kib) * int(n) for kib, n in pairs) * 1024
    major, _ = torch.cuda.get_device_capability(dev)
    return 4096 * 8 * 1024 if major >= 9 else 4096 * 1024 * 2 + 16 * 1024 * 8


def live_array_summary(top: int = 10) -> dict[str, Any]:
    """The live-tensor picture: count, total bytes, per-device buckets and
    the ``top`` largest storages with a tensor's shape and dtype -- what
    every flight dump folds in."""
    sized = live_tensors()
    by_device: dict[str, dict[str, int]] = {}
    total = 0
    for nb, t in sized:
        total += nb
        b = by_device.setdefault(str(t.device), {"count": 0, "bytes": 0})
        b["count"] += 1
        b["bytes"] += nb
    sized.sort(key=lambda e: -e[0])
    largest = [{"shape": list(t.shape), "dtype": str(t.dtype), "bytes": nb,
                "device": str(t.device)} for nb, t in sized[:top]]
    return {"count": len(sized), "total_bytes": total, "by_device": by_device,
            "largest": largest}


# ------------------------------------------------------- bounded series


class Series:
    """Algorithm-R reservoir + exact count/max/min/total over the whole
    stream (the serve engine's ``Reservoir`` contract, kept local: obs/ does
    not import serve/).  Below ``cap`` it is the insertion-ordered list."""

    __slots__ = ("cap", "count", "max", "min", "total", "_xs", "_rng", "_seed")

    def __init__(self, cap: int = SERIES_CAP, seed: int = 0):
        self.cap = int(cap)
        self._seed = int(seed)
        self._xs: list = []
        self._rng = random.Random(self._seed)
        self.count = 0
        self.max: float | None = None
        self.min: float | None = None
        self.total = 0.0

    def append(self, x) -> None:
        self.count += 1
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            self.total += x
            if self.max is None or x > self.max:
                self.max = x
            if self.min is None or x < self.min:
                self.min = x
        if len(self._xs) < self.cap:
            self._xs.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._xs[j] = x

    def clear(self) -> None:
        self._xs.clear()
        self._rng = random.Random(self._seed)
        self.count = 0
        self.max = None
        self.min = None
        self.total = 0.0

    def __iter__(self):
        return iter(self._xs)

    def __len__(self) -> int:
        return len(self._xs)

    def summary(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sampled": len(self._xs),
            "cap": self.cap,
            "max": self.max,
            "min": self.min,
            "mean": round(self.total / self.count, 3) if self.count else None,
        }


# ------------------------------------------------- monotone-growth leak


class GrowthDetector:
    """Windowed monotone-growth detector for host-side resources: a watched
    series that rises on EVERY observation across a full window of
    ``window`` samples, by at least ``min_growth_bytes`` in all, fires once
    per source (latched) as a dict naming it.  A plateau or a dip inside the
    window, or growth under the byte floor, stays quiet."""

    def __init__(self, window: int = 8, min_growth_bytes: int = 1 << 20):
        if window < 2:
            raise ValueError(f"window={window} must be >= 2")
        self.window = int(window)
        self.min_growth_bytes = int(min_growth_bytes)
        self._hist: dict[str, deque] = {}
        self.fired: dict[str, dict[str, Any]] = {}

    def observe(self, source: str, value: float,
                step: int | None = None) -> dict[str, Any] | None:
        """Feed one sample; returns the violation the first time ``source``
        completes a strictly increasing window, else None."""
        h = self._hist.setdefault(source, deque(maxlen=self.window))
        h.append(float(value))
        if source in self.fired or len(h) < self.window:
            return None
        xs = list(h)
        growth = xs[-1] - xs[0]
        if not all(b > a for a, b in zip(xs, xs[1:])) or growth < self.min_growth_bytes:
            return None
        v = {
            "kind": "mem",
            "source": source,
            "growth_bytes": int(growth),
            "window": self.window,
            "first_bytes": int(xs[0]),
            "last_bytes": int(xs[-1]),
            **({"step": int(step)} if step is not None else {}),
        }
        self.fired[source] = v
        return v


# ------------------------------------------------------------ the scope


class MemScope:
    """One loop's memory sampler: bounded series of live bytes and host
    RSS, exact high-water marks, watched host resources through a
    :class:`GrowthDetector`, and timeline ``mem_sample`` events.

    Construction is cheap, and :meth:`sample` is a no-op unless
    :func:`enabled`.  ``every`` thins the cadence (one tick in N);
    ``device`` is whose live bytes are read (default: the card when there
    is one, else the CPU)."""

    def __init__(self, label: str = "train", *, every: int = 1, cap: int = SERIES_CAP,
                 window: int = 8, min_growth_bytes: int = 1 << 20, device=None):
        self.label = label
        self.every = max(1, int(every))
        self.device = _resolve(device)
        self.live_bytes = Series(cap)
        self.rss_bytes = Series(cap)
        self.live_bytes_peak = 0
        self.rss_bytes_peak = 0
        self.live_bytes_baseline: int | None = None
        self.detector = GrowthDetector(window=window, min_growth_bytes=min_growth_bytes)
        self.violations: list[dict[str, Any]] = []
        self._watches: dict[str, Callable[[], float]] = {}
        self._n = 0

    def watch(self, name: str, fn: Callable[[], float]) -> None:
        """Register a host resource (callable -> byte count) for the growth
        detector; ``host_rss`` is always watched."""
        self._watches[name] = fn

    def set_baseline(self, value: int | None = None) -> int | None:
        """Set the live-bytes floor (the budget anchor): ``value``, or the
        reading now."""
        if not enabled():
            return None
        self.live_bytes_baseline = live_total_bytes(self.device) if value is None else int(value)
        return self.live_bytes_baseline

    def reset(self) -> None:
        """Forget everything (the serve engine's warm-up reset)."""
        self.live_bytes.clear()
        self.rss_bytes.clear()
        self.live_bytes_peak = 0
        self.rss_bytes_peak = 0
        self.live_bytes_baseline = None
        self.detector = GrowthDetector(window=self.detector.window,
                                       min_growth_bytes=self.detector.min_growth_bytes)
        self.violations = []
        self._n = 0

    def sample(self, step: int | None = None, *, vt: float | None = None,
               engine: str | None = None, replica: int | None = None,
               **extra: Any) -> dict[str, Any] | None:
        """Take one sample (one call in ``every``): live bytes and RSS into
        the series and peaks, the watched resources through the growth
        detector (a violation goes to the flight ring as ``kind="mem"``),
        and a timeline ``mem_sample`` event carrying ``extra``.  Returns the
        sample, or None off cadence or disabled."""
        if not enabled():
            return None
        self._n += 1
        if (self._n - 1) % self.every:
            return None
        live = live_total_bytes(self.device)
        rss = host_rss_bytes()
        if self.live_bytes_baseline is None:
            # the first sample is the training budget's anchor: it sees the
            # steady-state placement the first step made
            self.live_bytes_baseline = live
        self.live_bytes.append(live)
        self.live_bytes_peak = max(self.live_bytes_peak, live)
        if rss is not None:
            self.rss_bytes.append(rss)
            self.rss_bytes_peak = max(self.rss_bytes_peak, rss)
        for name, fn in [("host_rss", lambda: rss if rss is not None else 0.0),
                         *self._watches.items()]:
            try:
                value = float(fn())
            except Exception:  # noqa: BLE001 -- a probe must not kill the loop
                continue
            v = self.detector.observe(name, value, step)
            if v is not None:
                v["scope"] = self.label
                self.violations.append(v)
                from ddl25spring_tpu_torch.obs.recorder import flight

                flight.record(**v)
        sample = {
            "live_bytes": live,
            **({"rss_bytes": rss} if rss is not None else {}),
            **({"step": step} if step is not None else {}),
            **extra,
        }
        from ddl25spring_tpu_torch.obs.timeline import timeline

        timeline.emit("mem_sample", vt=vt, engine=engine or self.label, replica=replica,
                      **sample)
        return sample

    def cell(self) -> dict[str, Any]:
        """The scope's summary (rides ``telemetry.mem`` and the mem record)."""
        return {
            "label": self.label,
            "samples": self.live_bytes.count,
            "every": self.every,
            "live_bytes_peak": self.live_bytes_peak,
            "rss_bytes_peak": self.rss_bytes_peak,
            "live_bytes_baseline": self.live_bytes_baseline,
            "live_bytes": self.live_bytes.summary(),
            "rss_bytes": self.rss_bytes.summary(),
            "growth_violations": list(self.violations),
        }


# -------------------------------------------------- KV page-pool optics


def _host(t) -> np.ndarray:
    """A pool tensor (or array) as a host numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _free_runs(free: Iterable[bool]) -> list[int]:
    runs: list[int] = []
    n = 0
    for f in free:
        if f:
            n += 1
        elif n:
            runs.append(n)
            n = 0
    if n:
        runs.append(n)
    return runs


def pool_snapshot(pool: dict[str, Any], cache_held: int = 0) -> dict[str, Any]:
    """Host-side KV pool telemetry from the ``free`` / ``refcount`` masks:
    occupancy, the cache-held vs table-held split, a refcount histogram, and
    ``fragmentation`` = ``1 - largest_free_run / free_pages`` (0 = one
    contiguous free region)."""
    free = _host(pool["free"]).astype(bool)
    ref = _host(pool["refcount"]).astype(int)
    n_pages = int(free.shape[0])
    used = int((~free).sum())
    free_n = n_pages - used
    runs = _free_runs(free.tolist())
    vals, counts = np.unique(ref[ref > 0], return_counts=True)
    return {
        "n_pages": n_pages,
        "used_pages": used,
        "free_pages": free_n,
        "occupancy": round(used / n_pages, 4) if n_pages else 0.0,
        "cache_held_pages": int(cache_held),
        "table_held_pages": max(used - int(cache_held), 0),
        "refcount_hist": {str(int(v)): int(c) for v, c in zip(vals, counts)},
        "free_runs": {
            "count": len(runs),
            "max": max(runs) if runs else 0,
            "mean": round(sum(runs) / len(runs), 2) if runs else 0.0,
        },
        "fragmentation": round(1.0 - max(runs) / free_n, 4) if free_n else 0.0,
    }


def pool_leak_check(pool: dict[str, Any], *, cache_held_pages: int = 0,
                    slot_rids: list | None = None) -> dict[str, Any]:
    """The drain-time leak detector: an idle pool must hold EXACTLY its
    cache-held pages.  Any residue is enumerated page by page and attributed
    — a page still seated in a page-table row is named by that row's last
    rid (``slot_rids``); a page referenced by nothing visible is an orphan.
    ``ok=False`` is a leak."""
    free = _host(pool["free"]).astype(bool)
    ref = _host(pool["refcount"]).astype(int)
    table = _host(pool["page_table"]).astype(int)
    used = int((~free).sum())
    residue = used - int(cache_held_pages)
    out: dict[str, Any] = {
        "ok": residue <= 0,
        "used_pages": used,
        "cache_held_pages": int(cache_held_pages),
        "leaked_pages": max(residue, 0),
        "leaks": [],
    }
    if residue <= 0:
        return out
    holders: dict[int, list[int]] = {}
    for slot in range(table.shape[0]):
        for page in table[slot]:
            if page >= 0:
                holders.setdefault(int(page), []).append(slot)
    leaks = []
    for page in np.nonzero(~free)[0]:
        page = int(page)
        rows = holders.get(page)
        if rows is not None:
            for slot in rows:
                rid = (slot_rids[slot]
                       if slot_rids is not None and slot < len(slot_rids) else None)
                leaks.append({
                    "page": page,
                    "refcount": int(ref[page]),
                    "held_by": "page_table",
                    "slot": slot,
                    **({"rid": rid} if rid is not None else {}),
                })
        else:
            leaks.append({
                "page": page,
                "refcount": int(ref[page]),
                "held_by": "orphan_refcount",
            })
    # cache-held pages legitimately sit outside any table; keep only the
    # orphans beyond what the cache accounts for
    orphans = [x for x in leaks if x["held_by"] == "orphan_refcount"]
    tabled = [x for x in leaks if x["held_by"] == "page_table"]
    out["leaks"] = tabled + orphans[: max(len(orphans) - int(cache_held_pages), 0)]
    return out


# --------------------------------------------------------- the envelope


def describe_budget_bytes(strategy: str) -> int | None:
    """The compile-time peak-memory budget a registered strategy declares.
    The port has no ``describe()`` registry yet (ROADMAP A12), so every
    workload gates on its static accounting instead: always None."""
    return None


def budget_cell(measured_peak_bytes: int, budget_bytes: int | None, *,
                tol: float | None = None,
                source: str = "static_accounting") -> dict[str, Any]:
    """The budget-vs-measured verdict: ``within_band`` iff the high-water
    sits at or under ``budget_bytes * (1 + tol)``."""
    tol = tolerance() if tol is None else tol
    if not budget_bytes:
        return {"available": False, "source": source}
    ratio = measured_peak_bytes / budget_bytes
    return {
        "available": True,
        "source": source,
        "budget_bytes": int(budget_bytes),
        "measured_peak_bytes": int(measured_peak_bytes),
        "ratio": round(ratio, 4),
        "tolerance": tol,
        "within_band": ratio <= 1.0 + tol,
    }


def mem_record(*, strategy: str, mesh: dict[str, int] | None, scope_cell: dict[str, Any],
               budget: dict[str, Any], pool: dict[str, Any] | None = None,
               leaks: list[dict[str, Any]] | None = None,
               reshape_steps: list[dict[str, Any]] | None = None,
               extra: dict[str, Any] | None = None, device=None) -> dict[str, Any]:
    """One ``record: "mem"`` ledger row / ``mem.json`` document, with the
    perf rows' identity (strategy, mesh, host of ``device``, git sha), so
    ``mem_report`` groups trends as ``perf_report`` does."""
    import torch

    from ddl25spring_tpu_torch.obs.logger import git_sha
    from ddl25spring_tpu_torch.obs.perfscope import host_fingerprint

    return {
        "record": "mem",
        "schema": 1,
        "ts": time.time(),
        "strategy": strategy,
        "mesh": dict(mesh or {}),
        "host": host_fingerprint(device),
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "memscope": scope_cell,
        "budget": budget,
        **({"pool": pool} if pool is not None else {}),
        "leaks": list(leaks or []),
        "leaked_pages": sum(x.get("leaked_pages", 0) for x in (leaks or [])),
        "growth_violations": len(scope_cell.get("growth_violations") or []),
        **({"reshape_steps": reshape_steps} if reshape_steps is not None else {}),
        **(extra or {}),
    }


def mem_cell(record: dict[str, Any]) -> dict[str, Any]:
    """The ``telemetry.mem`` BENCH cell: peaks, the budget verdict, the leak
    and growth counters, folded from one :func:`mem_record`."""
    scope = record.get("memscope") or {}
    cell: dict[str, Any] = {
        "enabled": True,
        "samples": scope.get("samples"),
        "live_bytes_peak": scope.get("live_bytes_peak"),
        "rss_bytes_peak": scope.get("rss_bytes_peak"),
        "budget": record.get("budget"),
        "leaked_pages": record.get("leaked_pages", 0),
        "growth_violations": record.get("growth_violations", 0),
    }
    pool = record.get("pool")
    if pool is not None:
        cell["pool"] = {k: pool.get(k) for k in (
            "n_pages", "used_pages", "occupancy", "cache_held_pages", "table_held_pages",
            "fragmentation")}
    steps = record.get("reshape_steps")
    if steps:
        cell["reshape_steps"] = len(steps)
        cell["reshape_step_down_bytes"] = sum(s.get("step_down_bytes", 0) for s in steps)
    return cell


def write_run_mem(record: dict[str, Any], run_dir: str) -> str:
    """``<run_dir>/mem.json``, atomically (temp file + rename)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, MEM_BASENAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, default=str)
    os.replace(tmp, path)
    return path
