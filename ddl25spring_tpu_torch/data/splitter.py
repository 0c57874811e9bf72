"""Federated client data splitter.

Same capability as the reference's ``split(nr_clients, iid, seed)``
(``lab/tutorial_1a/hfl_complete.py:91-104``):

- IID: permute all indices, ``array_split`` into ``nr_clients`` chunks;
- non-IID: sort by label, cut into ``2 * nr_clients`` shards, deal each
  client 2 randomly-chosen shards (so each client sees at most ~2 labels).

Returns index arrays (not dataset objects) so callers can build stacked,
padded per-client arrays for the vmapped federated layer.

The PyTorch port's copy of the JAX package's ``data/splitter.py``, verbatim
in its code: the same seed gives the same client index arrays.
"""

from __future__ import annotations

import numpy as np


def split_indices(
    labels: np.ndarray, nr_clients: int, iid: bool, seed: int
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n = len(labels)
    if iid:
        return [s.astype(np.int64) for s in np.array_split(rng.permutation(n), nr_clients)]
    sorted_indices = np.argsort(labels, kind="stable")
    shards = np.array_split(sorted_indices, 2 * nr_clients)
    order = rng.permutation(len(shards)).reshape(nr_clients, 2)
    return [
        np.concatenate([shards[i] for i in pair]).astype(np.int64) for pair in order
    ]


def stack_client_data(
    x: np.ndarray, y: np.ndarray, splits: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build dense ``[n_clients, max_n, ...]`` arrays + per-client counts.

    Clients' shards differ in size (non-IID especially); the vmapped client
    axis needs rectangular arrays, so shorter clients are padded by repeating
    their own examples (repeats are masked out of weighted aggregation by the
    true ``counts``, matching the reference's weighting by sample count at
    ``hfl_complete.py:292,371``).
    """
    counts = np.array([len(s) for s in splits], dtype=np.int32)
    if (counts == 0).any():
        raise ValueError(
            f"empty client split (sizes {counts.tolist()}): need at least one "
            "example per client; use fewer clients or more data"
        )
    max_n = int(counts.max())
    xs, ys = [], []
    for s in splits:
        reps = -(-max_n // len(s))  # ceil
        idx = np.tile(s, reps)[:max_n]
        xs.append(x[idx])
        ys.append(y[idx])
    return np.stack(xs), np.stack(ys), counts
