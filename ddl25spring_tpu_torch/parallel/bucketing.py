"""Flat-buffer bucketing of collective launches: the counterpart of the JAX
package's ``parallel/bucketing.py`` (``BucketPlan``, ``plan_buckets``, the
``DDL25_BUCKET_BYTES`` knob).

One all-reduce per parameter tensor pays the launch cost once per tensor.
Packing the tensors into a few contiguous dtype-homogeneous buffers and
reducing per *bucket* pays it once per bucket, for the same bytes.

A *leaf* is what the JAX package's parameter pytree holds at one path: a
tensor, or a sequence of tensors that stands for one stacked leaf (the LLaMA
blocks' ``[L, ...]`` stacks, which the port keeps as one tensor per layer).
A stacked leaf is packed as its parts in order, which is the stack's
``reshape(-1)``, and is never split across buckets.  Walking the leaves in
the JAX pytree's flatten order (:func:`flatten`, sorted keys) makes both
packages plan the same buckets from the same tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import torch

from ddl25spring_tpu_torch.utils.config import env_int

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024

# the train steps' bucket_bytes default: DDL25_BUCKET_BYTES, read when the
# step is made; a string so that None keeps meaning "per tensor, no bucketing"
AUTO = "auto"

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]


def default_bucket_bytes() -> int | None:
    """``DDL25_BUCKET_BYTES`` (bytes; ``0`` means per tensor) or
    :data:`DEFAULT_BUCKET_BYTES` when unset."""
    bb = env_int("DDL25_BUCKET_BYTES", DEFAULT_BUCKET_BYTES)
    return bb if bb > 0 else None


def resolve_bucket_bytes(bucket_bytes) -> int | None:
    """A train step's ``bucket_bytes``: :data:`AUTO` -> :func:`default_bucket_bytes`,
    ``None``/``0`` -> None (per tensor), anything else -> ``int(bucket_bytes)``."""
    if bucket_bytes == AUTO:
        return default_bucket_bytes()
    if not bucket_bytes:
        return None
    return int(bucket_bytes)


def flatten(tree, prefix: str = "") -> list[tuple[str, Leaf]]:
    """``(dotted path, leaf)`` of a nested dict in the JAX pytree's flatten
    order: keys sorted at every level.  A list or tuple is one stacked leaf."""
    out = []
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}{key}"
        if isinstance(value, dict):
            out.extend(flatten(value, path + "."))
        else:
            out.append((path, value))
    return out


def parts(leaf: Leaf) -> list[torch.Tensor]:
    """The tensors of a leaf, in packing order."""
    return [leaf] if isinstance(leaf, torch.Tensor) else list(leaf)


def _shape(leaf: Leaf) -> tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return (len(leaf), *leaf[0].shape)


@dataclass(frozen=True)
class BucketPlan:
    """Leaves grouped into dtype-homogeneous flat buckets: ``buckets[b]`` lists
    leaf indices, ``sizes[i]`` is leaf ``i``'s element count (its padded ZeRO
    row under ``plan_buckets(sizes=)``)."""

    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    buckets: tuple[tuple[int, ...], ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def bucket_dtype(self, b: int) -> torch.dtype:
        return self.dtypes[self.buckets[b][0]]

    def bucket_size(self, b: int) -> int:
        """Total elements in bucket ``b``."""
        return sum(self.sizes[i] for i in self.buckets[b])

    def offsets(self, b: int) -> list[int]:
        """Element offset of each leaf within bucket ``b``'s buffer."""
        offs, acc = [], 0
        for i in self.buckets[b]:
            offs.append(acc)
            acc += self.sizes[i]
        return offs

    def pack(self, leaves: Sequence[Leaf]) -> list[torch.Tensor]:
        """Leaves -> one new 1-D buffer per bucket, leaves in bucket order."""
        return [self.pack_bucket(b, leaves) for b in range(self.n_buckets)]

    def pack_bucket(self, b: int, leaves: Sequence[Leaf]) -> torch.Tensor:
        """Bucket ``b``'s leaves -> one new 1-D buffer."""
        return torch.cat([t.reshape(-1) for i in self.buckets[b] for t in parts(leaves[i])])

    @torch.no_grad()
    def unpack_bucket_into(self, b: int, buf: torch.Tensor, leaves: Sequence[Leaf]):
        """Copy bucket ``b``'s buffer back into its leaves' own tensors."""
        for i, off in zip(self.buckets[b], self.offsets(b)):
            value = buf[off:off + self.sizes[i]].view(self.shapes[i])
            if isinstance(leaves[i], torch.Tensor):
                leaves[i].copy_(value)
            else:
                for t, v in zip(leaves[i], value):
                    t.copy_(v)

    def unpack(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Inverse of :meth:`pack`: leaf ``i`` as one tensor of ``shapes[i]``
        (a stacked leaf comes back stacked)."""
        out: list = [None] * self.n_leaves
        for b, idxs in enumerate(self.buckets):
            for i, off in zip(idxs, self.offsets(b)):
                out[i] = bufs[b][off:off + self.sizes[i]].view(self.shapes[i])
        return out

    @torch.no_grad()
    def unpack_into(self, bufs: Sequence[torch.Tensor], leaves: Sequence[Leaf]):
        """Copy the buffers back into ``leaves``' own tensors, in place."""
        for leaf, value in zip(leaves, self.unpack(bufs)):
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(value)
            else:
                for t, v in zip(leaf, value):
                    t.copy_(v)


def plan_buckets(leaves: Sequence[Leaf],
                 bucket_bytes: int | float = DEFAULT_BUCKET_BYTES,
                 order: str = "forward", sizes: Sequence[int] | None = None) -> BucketPlan:
    """Greedy order-preserving packing, as the JAX planner: walk the leaves in
    order, append each to the open bucket of its dtype until adding it would
    pass ``bucket_bytes``, then seal that bucket and open a new one.  A leaf
    above the threshold gets a bucket of its own; buckets never mix dtypes (a
    bf16 gradient packed into an fp32 buffer would be upcast on the wire).

    ``order="backward"`` walks the leaves reversed, as the JAX planner does
    for its overlapped path: the backward produces gradients roughly in
    reverse, so bucket 0 holds the last layers and is complete first.
    Packing and unpacking go by index, so both orders round-trip alike.

    ``sizes`` overrides each leaf's packed element count, as the JAX
    planner's does: ZeRO plans over its padded rows, where leaf ``i`` takes
    ``k_i = ceil(size_i / n)`` slots of a bucket row (the JAX ``_row_plan``,
    ``zero.py:59``).  Only :attr:`BucketPlan.sizes` changes; ``shapes`` stay
    the leaves' own, and :meth:`BucketPlan.pack`/``unpack`` are for plans
    without it.  Leaves may be ``meta`` tensors: only shapes and dtypes are
    read."""
    if order not in ("forward", "backward"):
        raise ValueError(f"order must be 'forward' or 'backward', got {order!r}")
    shapes = tuple(_shape(leaf) for leaf in leaves)
    dtypes = []
    for i, leaf in enumerate(leaves):
        kinds = {t.dtype for t in parts(leaf)}
        if len(kinds) != 1:
            raise ValueError(f"leaf {i} mixes dtypes {sorted(map(str, kinds))}")
        dtypes.append(kinds.pop())
    if sizes is None:
        sizes = [sum(t.numel() for t in parts(leaf)) for leaf in leaves]
    if len(sizes) != len(leaves):
        raise ValueError(f"sizes has {len(sizes)} entries for {len(leaves)} leaves")
    sizes = tuple(int(s) for s in sizes)
    bucket_bytes = max(int(bucket_bytes), 1)
    open_by_dtype: dict = {}  # dtype -> (indices, bytes)
    buckets: list[tuple[int, ...]] = []
    seen: list = []  # dtypes in first-seen order, for determinism
    walk = list(enumerate(zip(dtypes, sizes)))
    for i, (dt, sz) in (walk if order == "forward" else walk[::-1]):
        nbytes = sz * dt.itemsize
        cur = open_by_dtype.get(dt)
        if cur is None:
            open_by_dtype[dt] = ([i], nbytes)
            seen.append(dt)
            continue
        idxs, used = cur
        if used + nbytes > bucket_bytes and idxs:
            buckets.append(tuple(idxs))
            open_by_dtype[dt] = ([i], nbytes)
        else:
            idxs.append(i)
            open_by_dtype[dt] = (idxs, used + nbytes)
    for dt in seen:
        idxs, _ = open_by_dtype[dt]
        if idxs:
            buckets.append(tuple(idxs))
    return BucketPlan(shapes=shapes, dtypes=tuple(dtypes), sizes=sizes,
                      buckets=tuple(buckets))
