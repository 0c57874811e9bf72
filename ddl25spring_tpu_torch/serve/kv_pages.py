"""Paged KV cache: a fixed page pool + per-sequence page tables — the
counterpart of the JAX package's ``serve/kv_pages.py``, function for
function.

- **page pool** ``k/v: [n_pages + 1, L, page_len, H, hd]`` — one shared
  arena of fixed-size pages, all layers of a page row together.  The LAST
  row is a trash page: masked writes (inactive slots, padded prefill rows)
  land there instead of corrupting live pages.
- **page tables** ``[max_slots, pages_per_seq]`` int32 — slot s's page
  ``j`` holds its positions ``[j*page_len, (j+1)*page_len)``; ``-1`` marks
  an unassigned entry.
- **reference counts** ``refcount [n_pages]`` int32 with ``free ==
  (refcount == 0)`` at all times: allocation sets a page's count to 1,
  :func:`release_slots` decrements, sharing (:func:`adopt_prefix`,
  :func:`ref_pages`) increments.

Every function is static-shaped and reads nothing back to the host, so the
serving engine can capture it in a CUDA graph: a refusal comes back as the
``ok`` tensor, and the caller reads it once per program call.

How JAX's masked scatters translate.  JAX drops an out-of-range scatter
index (``mode="drop"``) and clamps a gather index; torch does neither (CUDA
asserts on an index out of range).  Here every masked row is routed
EXPLICITLY: a count or table update goes to one extra padding row that is
sliced off afterwards (:func:`_drop_add`, :func:`_drop_set`), gathers clamp
their indices, and K/V writes go to the trash page.  Reference counts are
accumulated (``index_put_(accumulate=True)``), so two releases of one shared
page in one call decrement it twice; a plain set is used only where no live
index can repeat (the trash row may be written several times, and nothing
reads it).  First-fit takes free pages in ascending id order through a
STABLE argsort, as JAX's ``jnp.argsort(~free, stable=True)``, so both
packages hand out the same page ids.

Functions return a new pool dict whose accounting tensors are new; the K/V
pages are written IN PLACE (the counterpart of JAX's donated pool), so the
input pool's ``k``/``v`` are the output's.
"""

from __future__ import annotations

import torch

from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.models.decode import resolve_heads
from ddl25spring_tpu_torch.utils.config import LlamaConfig

Pool = dict[str, torch.Tensor]

__all__ = [
    "resolve_heads", "init_page_pool", "pool_geometry", "reserve_pages",
    "write_page_ids", "append_layer_kv",
    "release_slots", "activate_slots", "used_pages",
    "adopt_prefix", "ref_pages", "unref_pages", "truncate_to",
]


def init_page_pool(
    cfg: LlamaConfig,
    *,
    n_pages: int,
    page_len: int,
    max_slots: int,
    pages_per_seq: int,
    num_heads: int | None = None,
    device=None,
) -> Pool:
    """Build an empty pool on ``device``.  ``k``/``v`` carry ``n_pages + 1``
    rows — row ``n_pages`` is the trash page masked writes target; it is
    never entered into a page table and never counted as capacity."""
    if n_pages < 1 or page_len < 1 or max_slots < 1 or pages_per_seq < 1:
        raise ValueError(
            f"n_pages={n_pages}, page_len={page_len}, "
            f"max_slots={max_slots}, pages_per_seq={pages_per_seq}: "
            "every pool dimension must be >= 1"
        )
    heads = resolve_heads(cfg, num_heads)
    shape = (n_pages + 1, cfg.n_layers, page_len, heads, cfg.head_dim)
    dtype = llama._dtype(cfg)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "page_table": torch.full((max_slots, pages_per_seq), -1, **i32),
        "seq_len": torch.zeros((max_slots,), **i32),
        "active": torch.zeros((max_slots,), dtype=torch.bool, device=device),
        "free": torch.ones((n_pages,), dtype=torch.bool, device=device),
        "refcount": torch.zeros((n_pages,), **i32),
    }


def pool_geometry(pool: Pool) -> dict[str, int]:
    """Static shape facts host code sizes its accounting from."""
    n_pages = int(pool["free"].shape[0])
    max_slots, pages_per_seq = (int(d) for d in pool["page_table"].shape)
    page_len = int(pool["k"].shape[2])
    return {
        "n_pages": n_pages,
        "page_len": page_len,
        "max_slots": max_slots,
        "pages_per_seq": pages_per_seq,
        "max_seq_len": pages_per_seq * page_len,
    }


# ---------------------------------------------- masked updates, made explicit


def _route(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` where ``keep`` and inside ``[0, n)``, else ``n`` (the padding
    row), as int64 — JAX's out-of-range sentinel of a dropped update."""
    idx = idx.long()
    return torch.where(keep & (idx >= 0) & (idx < n), idx, n)


def _drop_add(counts: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
              delta: int) -> torch.Tensor:
    """``counts.at[where(keep, idx, n)].add(delta, mode="drop")``: a new
    tensor; rows not kept land on a padding row that is sliced off, and
    repeated indices accumulate."""
    n = counts.shape[0]
    pad = torch.cat([counts, counts.new_zeros(1)])
    idx = _route(idx, keep, n).reshape(-1)
    pad.index_put_((idx,), torch.full(idx.shape, delta, dtype=counts.dtype,
                                      device=counts.device), accumulate=True)
    return pad[:n]


def _drop_set(values: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
              new: torch.Tensor, cols: torch.Tensor | None = None) -> torch.Tensor:
    """``values.at[where(keep, rows, n)(, cols)].set(new, mode="drop")`` over
    the leading axis: a new tensor; rows not kept write a padding row that
    is sliced off.  A kept index must not repeat."""
    n = values.shape[0]
    pad = torch.cat([values, values[:1].clone()])
    rows = _route(rows, keep, n)
    new = new.to(values.dtype)
    if cols is None:
        pad.index_put_((rows.reshape(-1),), new.reshape(-1))
    else:
        rows, cols = torch.broadcast_tensors(rows, cols.long())
        pad.index_put_((rows.reshape(-1), cols.reshape(-1)),
                       new.expand(rows.shape).reshape(-1))
    return pad[:n]


def _first_fit(free: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """The page each row of ``need`` takes: free ids first, ascending (a
    stable argsort over the used mask); row i the rank-th free page."""
    n = free.shape[0]
    order = torch.argsort((~free).to(torch.int32), stable=True)
    rank = torch.cumsum(need.to(torch.int32), 0) - 1
    return order[rank.clamp(0, n - 1)]


def _counted(pool: Pool, refcount: torch.Tensor, **rest) -> Pool:
    return {**pool, "free": refcount == 0, "refcount": refcount, **rest}


# ------------------------------------------------------------ the pool ops


def reserve_pages(pool: Pool, slots: torch.Tensor, pos: torch.Tensor,
                  need: torch.Tensor):
    """Batched first-fit allocation: every row ``i`` with ``need[i]`` set
    gets the next free page, entered into ``page_table[slots[i]]`` at the
    entry position ``pos[i]`` calls for (``pos // page_len``).

    Returns ``(pool, ok)`` — ``ok`` (a bool tensor) is False when the pool
    cannot cover the request or a needed row's position falls past the
    table, in which case NOTHING is allocated (a page consumed while its
    table write is dropped would leak forever)."""
    free = pool["free"]
    S, P = pool["page_table"].shape
    page_len = pool["k"].shape[2]

    need = need.bool()
    entry = pos.long() // page_len
    ok = (need.sum() <= free.sum()) & torch.all((entry < P) | ~need)
    pages = _first_fit(free, need)
    take = need & ok

    refcount = _drop_add(pool["refcount"], pages, take, 1)
    table = _drop_set(pool["page_table"], slots, take, pages, cols=entry.clamp(0, P - 1))
    return _counted(pool, refcount, page_table=table), ok


def write_page_ids(pool: Pool, slots: torch.Tensor, pos: torch.Tensor,
                   valid: torch.Tensor):
    """``(pages, offsets)`` for writing position ``pos`` of each slot: invalid
    rows (inactive slot, padded prefill row, position past the table) are
    routed to the trash page."""
    n_pages = pool["free"].shape[0]
    S, P = pool["page_table"].shape
    page_len = pool["k"].shape[2]
    entry = pos.long() // page_len
    rows = slots.long().clamp(0, S - 1)
    pages = pool["page_table"][rows, entry.clamp(0, P - 1)].long()
    good = valid.bool() & (pages >= 0) & (entry < P)
    return torch.where(good, pages, n_pages), pos.long() % page_len


def append_layer_kv(k_pages, v_pages, layer: int, pages, offs, k, v):
    """Write one layer's single-token k/v ``[B, H, hd]`` into the pool at
    ``(pages[b], layer, offs[b])``, in place.  Trash-routed rows may collide
    there; the trash page is never read, so which of them lands is
    irrelevant.  A live ``(page, offset)`` is written by at most one row: a
    slot writes only its own page, and a shared page is full."""
    k_pages.select(1, layer).index_put_((pages, offs), k.to(k_pages.dtype))
    v_pages.select(1, layer).index_put_((pages, offs), v.to(v_pages.dtype))
    return k_pages, v_pages


def release_slots(pool: Pool, slot_mask: torch.Tensor) -> Pool:
    """Drop every masked slot's references and reset its table.  A DECREMENT,
    not a free: a page returns to the free set only when its count reaches
    0.  Two released slots sharing a page decrement it twice."""
    mask = slot_mask.bool()
    rows = pool["page_table"]
    freed = mask[:, None] & (rows >= 0)
    refcount = _drop_add(pool["refcount"], rows, freed, -1).clamp_min(0)
    return _counted(
        pool, refcount,
        page_table=torch.where(mask[:, None], -1, rows),
        seq_len=torch.where(mask, 0, pool["seq_len"]),
        active=pool["active"] & ~mask,
    )


def adopt_prefix(pool: Pool, slots: torch.Tensor, adopt_pages: torch.Tensor,
                 cow_src: torch.Tensor):
    """Enter a matched prefix into newly-admitted sequences' page tables (the
    radix cache's sharing op, run before the suffix prefill).  Per batch row
    ``b``:

    - ``adopt_pages[b, e] >= 0`` — share that resident page by reference at
      table entry ``e`` (``refcount += 1``);
    - ``cow_src[b] >= 0`` — the matched prefix ends inside this partially
      filled page: allocate a fresh first-fit page, copy the source page's
      k/v rows bit for bit, and seat the COPY at the row's next table entry.
      Two rows copying one source each get their own copy.

    ``slots[b] < 0`` marks a padding row.  Returns ``(pool, ok)`` —
    all-or-nothing like :func:`reserve_pages`: when the copies do not fit
    the free set, NOTHING is adopted."""
    n_pages = pool["free"].shape[0]
    S, P = pool["page_table"].shape

    row_ok = slots >= 0
    valid = (adopt_pages >= 0) & row_ok[:, None]
    need = (cow_src >= 0) & row_ok
    cow_entry = valid.sum(1)  # first entry past the adopted run

    free = pool["free"]
    ok = (need.sum() <= free.sum()) & torch.all(~need | (cow_entry < P))
    fresh = _first_fit(free, need)
    valid = valid & ok
    take = need & ok

    refcount = _drop_add(pool["refcount"], adopt_pages, valid, 1)
    refcount = _drop_add(refcount, fresh, take, 1)
    entries = torch.arange(P, device=slots.device)[None, :].expand(adopt_pages.shape)
    table = _drop_set(pool["page_table"], slots[:, None].expand(adopt_pages.shape), valid,
                      adopt_pages, cols=entries)
    table = _drop_set(table, slots, take, fresh, cols=cow_entry.clamp(0, P - 1))

    # bit-for-bit page copy; rows not taken read and write the trash row
    src = torch.where(take, cow_src.long(), n_pages)
    dst = torch.where(take, fresh, n_pages)
    for name in ("k", "v"):
        pool[name].index_copy_(0, dst, pool[name].index_select(0, src))
    return _counted(pool, refcount, page_table=table), ok


def truncate_to(pool: Pool, new_lens: torch.Tensor, mask: torch.Tensor) -> Pool:
    """Roll back each masked slot's KV frontier to ``new_lens[slot]`` written
    positions (speculative decoding's rejection path): table entries whose
    pages start at or past the new frontier drop one reference each (a
    shared page survives, as in :func:`release_slots`) and ``seq_len`` clamps
    to ``min(seq_len, new_len)``.  The page holding the frontier is kept;
    its stale tail is overwritten before any read can reach it (the write
    frontier is monotone).  A ``new_len`` at or above a slot's frontier is a
    no-op for that slot."""
    P = pool["page_table"].shape[1]
    page_len = pool["k"].shape[2]
    mask = mask.bool()
    new_lens = new_lens.clamp_min(0)

    rows = pool["page_table"]
    entry_start = torch.arange(P, dtype=torch.int32, device=rows.device)[None, :] * page_len
    drop = mask[:, None] & (entry_start >= new_lens[:, None]) & (rows >= 0)
    refcount = _drop_add(pool["refcount"], rows, drop, -1).clamp_min(0)
    seq_len = torch.where(mask, torch.minimum(pool["seq_len"], new_lens.to(torch.int32)),
                          pool["seq_len"])
    return _counted(pool, refcount, page_table=torch.where(drop, -1, rows),
                    seq_len=seq_len)


def ref_pages(pool: Pool, pages: torch.Tensor) -> Pool:
    """Add one reference to each listed resident page (``-1`` = pad) — how
    the prefix cache claims the prompt pages it just indexed."""
    return _counted(pool, _drop_add(pool["refcount"], pages, pages >= 0, 1))


def unref_pages(pool: Pool, pages: torch.Tensor) -> Pool:
    """Drop one reference from each listed page (``-1`` = pad) — LRU
    eviction's device half.  A page still in a live table survives."""
    refcount = _drop_add(pool["refcount"], pages, pages >= 0, -1).clamp_min(0)
    return _counted(pool, refcount)


def activate_slots(pool: Pool, slots: torch.Tensor, valid: torch.Tensor) -> Pool:
    """Mark ``slots`` (rows where ``valid``) active with ``seq_len`` 0 — the
    prefill program's first act.  Assumes the engine hands out only released
    slots (their tables are already ``-1``)."""
    valid = valid.bool()
    ones = torch.ones(slots.shape, dtype=torch.bool, device=slots.device)
    return {
        **pool,
        "active": _drop_set(pool["active"], slots, valid, ones),
        "seq_len": _drop_set(pool["seq_len"], slots, valid, torch.zeros_like(slots)),
    }


def used_pages(pool: Pool) -> torch.Tensor:
    """Pages currently allocated (trash excluded) — the occupancy the serving
    telemetry tracks."""
    return (~pool["free"]).sum()
