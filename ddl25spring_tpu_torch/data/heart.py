"""Heart-disease tabular data pipeline.

The reference reads ``heart.csv`` (UCI Cleveland layout: 13 columns +
``target``) and preprocesses with one-hot categoricals + scaled numericals
(``lab/tutorial_2b/vfl.py:106-141``, ``lab/tutorial_2a/centralized.py:31-41``).
This loader reproduces that shape contract in numpy:

- one-hot: sex, cp, fbs, restecg, exang, slope, ca, thal;
- numericals scaled (min-max by default, matching the VFL/centralized
  scripts; standardization available for the VAE script's preprocessing);
- the encoded matrix lands at ~30 features, the input width of
  ``HeartDiseaseNN``.

Sources: ``DDL25_HEART_CSV`` env var, ``data/heart.csv``, else a
deterministic synthetic generator with the same schema and a real
label-feature dependence (so classifiers beat chance).

The PyTorch port's copy of the JAX package's ``data/heart.py`` (numpy and
csv only): the same matrices byte for byte.
"""

from __future__ import annotations

import csv
import os
from functools import lru_cache
from pathlib import Path

import numpy as np

CATEGORICAL = ["sex", "cp", "fbs", "restecg", "exang", "slope", "ca", "thal"]
NUMERICAL = ["age", "trestbps", "chol", "thalach", "oldpeak"]
COLUMNS = [
    "age", "sex", "cp", "trestbps", "chol", "fbs", "restecg", "thalach",
    "exang", "oldpeak", "slope", "ca", "thal", "target",
]
# category cardinalities in the UCI data (sex 2, cp 4, fbs 2, restecg 3,
# exang 2, slope 3, ca 5, thal 4)
_CARD = {"sex": 2, "cp": 4, "fbs": 2, "restecg": 3, "exang": 2, "slope": 3,
         "ca": 5, "thal": 4}


def _find_csv() -> Path | None:
    for cand in (os.environ.get("DDL25_HEART_CSV"), "data/heart.csv"):
        if cand and Path(cand).exists():
            return Path(cand)
    return None


def _synthetic(n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    rows = {
        "age": rng.integers(29, 78, n),
        "trestbps": rng.integers(94, 201, n),
        "chol": rng.integers(126, 565, n),
        "thalach": rng.integers(71, 203, n),
        "oldpeak": np.round(rng.uniform(0, 6.2, n), 1),
    }
    for c, k in _CARD.items():
        rows[c] = rng.integers(0, k, n)
    # target depends on a few features so models can learn
    logit = 3.0 * (
        0.03 * (rows["age"] - 54)
        + 0.8 * (rows["cp"] > 0)
        - 0.015 * (rows["thalach"] - 150)
        + 0.5 * rows["exang"]
        + 0.4 * (rows["oldpeak"] > 1.5)
        - 0.6
    )
    rows["target"] = (1 / (1 + np.exp(-logit)) > rng.uniform(0, 1, n)).astype(int)
    return {k: np.asarray(v) for k, v in rows.items()}


def _read_csv(path: Path) -> dict[str, np.ndarray]:
    with open(path) as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    return {
        c: np.asarray([float(r[c]) for r in rows]) for c in COLUMNS
    }


def _freeze(d: dict) -> dict:
    for v in d.values():
        if isinstance(v, np.ndarray):
            v.flags.writeable = False  # lru_cache shares the dict: no aliasing bugs
    return d


@lru_cache(maxsize=4)
def load_heart(
    n_synthetic: int = 1025, seed: int = 42, scale: str = "minmax"
) -> dict:
    """Return ``{"x": [N,F] float32, "y": [N] int32, "feature_names",
    "feature_slices"}`` where feature_slices maps each ORIGINAL column to its
    (start, stop) range in the encoded matrix — the handle VFL uses to deal
    disjoint feature groups to parties (``vfl.py:116-141``)."""
    p = _find_csv()
    raw = _read_csv(p) if p is not None else _synthetic(n_synthetic, seed)

    cols: list[np.ndarray] = []
    names: list[str] = []
    slices: dict[str, tuple[int, int]] = {}
    for c in COLUMNS[:-1]:
        start = sum(x.shape[1] for x in cols)
        if c in CATEGORICAL:
            vals = raw[c].astype(int)
            k = max(_CARD.get(c, 0), vals.max() + 1)
            onehot = np.zeros((len(vals), k), np.float32)
            onehot[np.arange(len(vals)), vals] = 1.0
            cols.append(onehot)
            names += [f"{c}_{i}" for i in range(k)]
        else:
            v = raw[c].astype(np.float32)
            if scale == "minmax":
                v = (v - v.min()) / max(v.max() - v.min(), 1e-8)
            else:  # standardize (VAE script's choice)
                v = (v - v.mean()) / max(v.std(), 1e-8)
            cols.append(v[:, None])
            names.append(c)
        slices[c] = (start, sum(x.shape[1] for x in cols))

    x = np.concatenate(cols, axis=1).astype(np.float32)
    y = raw["target"].astype(np.int32)
    return _freeze(
        {
            "x": x,
            "y": y,
            "feature_names": names,
            "feature_slices": slices,
            "provenance": "real" if p is not None else "synthetic",
        }
    )


def partition_features(
    feature_slices: dict[str, tuple[int, int]], n_parties: int
) -> list[np.ndarray]:
    """Deal the 13 original columns round the parties the way the reference
    does — floor(13/K) raw columns per party, remainder to the last, each
    expanded to its one-hot columns (``vfl.py:116-141``).  Returns per-party
    encoded-column index arrays (disjoint, covering)."""
    cols = list(feature_slices)
    per = len(cols) // n_parties
    groups = [cols[i * per : (i + 1) * per] for i in range(n_parties - 1)]
    groups.append(cols[(n_parties - 1) * per :])
    out = []
    for g in groups:
        idx: list[int] = []
        for c in g:
            lo, hi = feature_slices[c]
            idx.extend(range(lo, hi))
        out.append(np.asarray(idx, dtype=np.int64))
    return out
