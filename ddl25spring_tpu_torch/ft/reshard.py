"""Cross-mesh restore: re-land ZeRO rows on a mesh of another size (the
counterpart of the JAX package's ``ft/reshard.py``).

A ZeRO state is mesh-shaped: every parameter (and Adam moment) leaf lives in
the padded ``[n, k]`` row layout of :mod:`~ddl25spring_tpu_torch.parallel.
zero`, rank ``i`` holding row ``i``.  When the world changes size (8 ranks
die, 4 come back, or an elastic run reshapes), the ``[n, k]`` state must
re-land on ``[m, k']`` without a round-trip through training code.  The
padding discipline of ``zero_shard_params`` makes that exact:

- the flat ``[n, k]`` buffer is the true parameter vector (length ``s``)
  zero-padded to ``n*k``, row-major: all padding sits at the TAIL;
- the target has ``k' = ceil(s/m)``, so ``m*k' >= s``: copying the leading
  ``min(n*k, m*k')`` elements and zero-filling the rest keeps every true
  element without knowing ``s``;
- a nonzero element that WOULD be dropped is real data under a wrong
  template: :func:`reshard_leaf` refuses loudly instead of truncating.

The same rule refits the layer-stacked ``[L, n, k]`` leaves of the LLaMA
ZeRO-3 layout per layer, and passes scalars and matching leaves through, so
one function serves ZeRO-1/2 and ZeRO-3 alike.

A sharded leaf of a live state is :class:`Rows`: this rank's row (a ``[1,
k]`` or ``[L, 1, k]`` tensor) of the global ``[n, k]`` / ``[L, n, k]``, and
the axis the ``n`` ranks hold it over.  The checkpoint saves the global
tensor (:mod:`~ddl25spring_tpu_torch.utils.checkpoint`, row ``i`` written by
rank ``i``), so the manifest's ``leaf_shapes`` are the JAX package's; a
restore on ``m`` ranks reads the saved ``[n, k]``, refits it to ``[m, k']``
and takes its own row.

Two sources, one rule: numpy leaves (read off disk, or the JAX package's
arrays in the parity tests) refit on the host, and torch leaves refit on
their device with torch ops (the live twin: a :class:`Rows` source is first
gathered over its axis on the device).  The only host read the device path
makes is the dropped TAIL of a shrinking leaf (a few padding elements),
because the nonzero-truncation refusal is part of the contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ddl25spring_tpu_torch.utils import pytree

# The checkpoint layout contract, as data: which dimension of a saved
# sharded leaf carries the per-rank rows -- rank 2 = the padded ``[n, k]``
# layout (rows on dim 0), rank 3 = the layer-stacked ``[L, n, k]`` layout
# (rows on dim 1).  :func:`reshard_leaf`'s refit is exact ONLY under this
# contract (a row-major flatten puts all padding at the tail).
SAVED_SHARD_DIMS: dict[int, int] = {2: 0, 3: 1}


@dataclass
class Rows:
    """This rank's rows of one sharded leaf: ``local`` is index ``index`` of
    the ``n`` rows along :data:`SAVED_SHARD_DIMS`'s dimension (size 1
    there) of the global ``[n, k]`` or ``[L, n, k]`` tensor.  ``axis`` is
    the :class:`~ddl25spring_tpu_torch.parallel.comm.Axis` whose ``n``
    ranks hold the rows, in index order (None on one rank, or for a
    template); ``device`` is where the rows land (``local``'s own, unless
    ``local`` is a ``meta`` tensor: a template without storage)."""

    local: torch.Tensor
    n: int
    index: int
    axis: Any = field(default=None, repr=False)
    device: torch.device | None = None

    def __post_init__(self):
        if self.local.dim() not in SAVED_SHARD_DIMS:
            raise ValueError(f"rows of rank {self.local.dim()}: a sharded leaf is [1, k] or "
                             "[L, 1, k]")
        if self.local.shape[self.dim] != 1:
            raise ValueError(f"rows {tuple(self.local.shape)} hold more than one row on dim "
                             f"{self.dim}")
        if self.device is None:
            self.device = self.local.device

    @property
    def dim(self) -> int:
        return SAVED_SHARD_DIMS[self.local.dim()]

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape: ``[n, k]`` or ``[L, n, k]``."""
        s = list(self.local.shape)
        s[self.dim] = self.n
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def full(self) -> torch.Tensor:
        """The global tensor on this rank's device: one all-gather of every
        rank's rows over ``axis`` (every rank of it must call this)."""
        if self.n == 1:
            return self.local
        if self.axis is None:
            raise ValueError("rows without an axis cannot be gathered")
        flat = self.local.detach().reshape(-1).contiguous()
        full = self.axis.comm.all_gather(flat, self.axis.group)      # [n, numel]
        if self.dim == 0:
            return full.reshape(self.shape)
        L, _, k = self.local.shape
        return full.reshape(self.n, L, k).transpose(0, 1).contiguous()

    def placed(self, full: torch.Tensor) -> "Rows":
        """This template's own row of the global ``full``, on its device."""
        row = full.narrow(self.dim, self.index, 1).to(self.device, copy=True)
        return Rows(row, self.n, self.index, self.axis)


def _refusal(name, have, want, n_dropped, per_layer=False) -> ValueError:
    what = "elements/layer" if per_layer else "elements"
    return ValueError(
        f"cross-mesh refit of {name}: {have} -> {want} {what} would drop "
        f"{n_dropped} nonzero values — the template's shard layout is smaller "
        "than the saved parameter (mismatched model?)")


def _refit_flat(flat: np.ndarray, target_len: int, name: str) -> np.ndarray:
    """Zero-pad or zero-truncate a flattened shard buffer to ``target_len``.
    Truncation is only legal over the zero padding tail; a nonzero casualty
    means the template does not describe the same parameter: refuse."""
    if flat.size == target_len:
        return flat
    if flat.size > target_len:
        dropped = flat[target_len:]
        if np.any(dropped != 0):
            raise _refusal(name, flat.size, target_len, int(np.count_nonzero(dropped)))
        return flat[:target_len]
    out = np.zeros(target_len, dtype=flat.dtype)
    out[: flat.size] = flat
    return out


def _refit_flat_live(flat: torch.Tensor, target_len: int, name: str) -> torch.Tensor:
    """The device twin of :func:`_refit_flat`: zero-pad or zero-truncate a
    flattened tensor on its device.  Truncation host-reads the DROPPED tail
    only (padding, when the layouts agree), judged and worded as the copy
    path does."""
    if flat.numel() == target_len:
        return flat
    if flat.numel() > target_len:
        dropped = flat[target_len:].detach().cpu()   # the tail, not the leaf
        if bool((dropped != 0).any()):
            raise _refusal(name, flat.numel(), target_len, int(torch.count_nonzero(dropped)))
        return flat[:target_len]
    return F.pad(flat, (0, target_len - flat.numel()))


def _shape_dtype(template) -> tuple[tuple[int, ...], Any]:
    if isinstance(template, Rows) or torch.is_tensor(template):
        return tuple(template.shape), template.dtype
    arr = np.asarray(template)
    return tuple(arr.shape), arr.dtype


def reshard_leaf(saved, template, name: str = "<leaf>"):
    """Refit one saved leaf onto one template leaf's shape, dtype and
    placement.

    - same shape: pass through (cast to the template's dtype);
    - 2-D ``[n, k] -> [m, k']``: flatten (row-major == the padded flat
      vector), refit, reshape;
    - 3-D ``[L, n, k] -> [L, m, k']``: the same per layer (the LLaMA
      ZeRO-3 block layout);
    - anything else: refuse (a change of rank is not a change of mesh).

    ``saved`` is a numpy array (refit on the host), a tensor (refit on its
    device), or live :class:`Rows` (gathered over their axis on the device,
    then refit there).  The result takes the template's form: a template
    :class:`Rows` gets its own row of the refit tensor on its device; a
    tensor template a tensor on its device (the host for a ``meta``
    template); a numpy template an array."""
    if isinstance(saved, Rows):
        if isinstance(template, Rows) and template.shape == saved.shape \
                and template.index == saved.index:
            arr = saved.local            # this rank's row already: nothing to move
            return Rows(arr.to(template.device, template.dtype, copy=True), template.n,
                        template.index, template.axis)
        saved = saved.full()
    live = torch.is_tensor(saved)
    arr = saved if live else np.asarray(saved)
    tshape, tdtype = _shape_dtype(template)
    refit = _refit_flat_live if live else _refit_flat
    if tuple(arr.shape) == tshape:
        out = arr
    elif arr.ndim == 2 and len(tshape) == 2:
        out = refit(arr.reshape(-1), int(np.prod(tshape)), name).reshape(tshape)
    elif arr.ndim == 3 and len(tshape) == 3 and arr.shape[0] == tshape[0]:
        L = arr.shape[0]
        rows = int(np.prod(tshape[1:]))
        if live:
            # one refit of the whole [L, n, k] stack: the padding sits at each
            # layer's flat tail, so the batched refit is the per-layer one
            flat = arr.reshape(L, -1)
            if flat.shape[1] > rows:
                dropped = flat[:, rows:].detach().cpu()
                if bool((dropped != 0).any()):
                    raise _refusal(name, flat.shape[1], rows,
                                   int(torch.count_nonzero(dropped)), per_layer=True)
                flat = flat[:, :rows]
            elif flat.shape[1] < rows:
                flat = F.pad(flat, (0, rows - flat.shape[1]))
            out = flat.reshape(tshape)
        else:
            out = np.stack(
                [refit(arr[i].reshape(-1), rows, f"{name}[layer {i}]") for i in range(L)]
            ).reshape(tshape)
    else:
        raise ValueError(
            f"cannot reshard {name}: saved shape {tuple(arr.shape)} does not map onto "
            f"template shape {tshape} (rank/leading-dim mismatch)")
    if isinstance(template, Rows) or torch.is_tensor(template):
        t = out if live else torch.from_numpy(np.ascontiguousarray(out))
        t = t.to(tdtype)
        if isinstance(template, Rows):
            return template.placed(t)
        dev = template.device
        return t.to("cpu" if dev.type == "meta" else dev, copy=t is saved)
    if live:
        out = out.detach().cpu().numpy()
    return out.astype(tdtype) if out.dtype != tdtype else out


def reshard_state(saved_tree: Any, template_tree: Any) -> Any:
    """Refit a whole restored state onto a template state.

    ``saved_tree`` must flatten to the template's leaves, in order (the
    autosave layer restores through a template built from the manifest's
    recorded leaf shapes, so the structures match); every leaf goes through
    :func:`reshard_leaf` and comes back in the template's form.  This is the
    one entry :meth:`~ddl25spring_tpu_torch.ft.autosave.AutoSaver.
    restore_or_init` uses for the same-mesh and the other-mesh cases alike:
    matched shapes degenerate to a placement pass-through."""
    flat_t = pytree.flatten_with_path(template_tree)
    flat_s = pytree.leaves(saved_tree)
    if len(flat_s) != len(flat_t):
        raise ValueError(f"the saved state holds {len(flat_s)} leaves, the template "
                         f"{len(flat_t)}")
    out = [reshard_leaf(s, t, name=pytree.keystr(path))
           for (path, t), s in zip(flat_t, flat_s)]
    return pytree.unflatten_like(template_tree, out)
