"""Nested containers of leaves, flattened in the JAX package's order.

The fault-tolerance layer saves, restores and refits *states*: nested
``dict``/``list``/``tuple`` containers whose leaves are tensors, numpy
arrays, scalars or sharded rows.  ``jax.tree_util`` flattens such a tree with
a dict's keys sorted and ``None`` as an empty subtree; these helpers do the
same, so a state's leaf list (the manifest's ``leaf_shapes``) is the one the
JAX package records for the same tree.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def _children(x) -> list[tuple[Any, Any]]:
    if isinstance(x, dict):
        return [(k, x[k]) for k in sorted(x)]
    if x is None:
        return []
    return list(enumerate(x))


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted, sequences in order, ``None`` holding no leaf."""
    out: list = []

    def walk(x, path):
        if not _is_node(x):
            out.append((path, x))
            return
        for k, v in _children(x):
            walk(v, path + (k,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`flatten_with_path`'s order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced by ``new_leaves`` (in
    :func:`flatten_with_path`'s order); a count that does not match raises."""
    it = iter(new_leaves)

    def build(x):
        if not _is_node(x):
            return next(it)
        if x is None:
            return None
        if isinstance(x, dict):
            made = {k: build(x[k]) for k in sorted(x)}
            return {k: made[k] for k in x}
        vals = [build(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)

    out = build(tree)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of each of ``rest``, which must
    share its structure), in the tree's structure."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("the trees hold different numbers of leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*flat)])


def keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` prints it: ``['params']['w1']``, and
    ``[0]`` for a sequence index."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in path)


def slashed(path) -> str:
    """A path as one ``/``-joined key (``params/w1``): a checkpoint's key."""
    return "/".join(str(k) for k in path)
