"""KV page-pool optics of the serving engine: the part of the JAX package's
``obs/memscope.py`` the engine's drain-time reads need (``:450-577``), with
its sampler gate.

- :func:`pool_snapshot` — occupancy, the cache-held vs table-held split, a
  refcount histogram and the free-run fragmentation, from the pool's
  ``free`` / ``refcount`` masks (small host transfers);
- :func:`pool_leak_check` — the drain-time leak detector: an idle pool must
  hold exactly its cache-held pages; residue is attributed page by page.

- :func:`live_total_bytes` -- the device allocator's live bytes (the
  step-down reading of ``elastic_serve_run`` when a replica retires).

The live-bytes sampler (``MemScope``), the budget band and the ``mem``
record and cell come with the rest of the observability port (ROADMAP
A11b); until then :func:`enabled` gates a sampler that samples nothing.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterable

import numpy as np

from ddl25spring_tpu_torch.obs import state
from ddl25spring_tpu_torch.utils.config import env_flag

#: sampler gate — ``DDL25_MEMSCOPE=0`` turns every sampler into a no-op
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


#: why a CPU reading of :func:`live_total_bytes` is absent
LIVE_BYTES_ABSENT = ("the CPU allocator keeps no count of live tensor bytes "
                     "(torch.cuda.memory_allocated exists on the card only)")


def live_total_bytes(device=None) -> int | None:
    """Bytes of live tensors on ``device`` (default the current card):
    ``torch.cuda.memory_allocated`` -- the caching allocator's in-use
    blocks, a captured graph's included.  None on the CPU
    (:data:`LIVE_BYTES_ABSENT`)."""
    import torch

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(dev))


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
