"""CIFAR-10 pipeline (benchmark dataset per BASELINE.json).

Zero-egress build: loads the real binary batches when present
(``DDL25_CIFAR10_DIR`` env var or ``data/cifar-10-batches-bin``), else a
deterministic synthetic 32x32x3 class-prototype dataset with identical
shapes/dtypes (throughput benchmarking is shape-bound, not content-bound).
Arrays are NHWC float32, normalized per-channel with the canonical CIFAR-10
train statistics.

The PyTorch port's copy of the JAX package's ``data/cifar10.py``: numpy
only, the same arrays byte for byte.  :func:`normalize_on_device` (from the
JAX package's ``data/native_loader.py``) is the one addition;
``ensure_bin_dir``, which writes the files of the native streaming loader,
waits for that loader's port.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path

import numpy as np

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _find_candidate(*marker_groups: tuple[str, ...]) -> Path | None:
    """First candidate dir (env var, then standard paths) satisfying any
    marker group (a group matches when ALL its files exist)."""
    for cand in (
        os.environ.get("DDL25_CIFAR10_DIR"),
        "data/cifar-10-batches-bin",
        "data/cifar10",
    ):
        if cand and Path(cand).exists() and any(
            all((Path(cand) / m).exists() for m in group)
            for group in marker_groups
        ):
            return Path(cand)
    return None


def _find_dir() -> Path | None:
    """Directory with the full canonical layout (train batches + test split)
    — what :func:`load_cifar10` needs."""
    return _find_candidate(("data_batch_1.bin", "test_batch.bin"))


def _find_loader_dir() -> Path | None:
    """Directory usable by the native streaming loader — unlike
    :func:`_find_dir` this accepts the single-file ``train.bin`` layout and
    does not require a test split (``native/dataloader.cc`` supports both)."""
    return _find_candidate(("data_batch_1.bin",), ("train.bin",))


def _read_bin_u8(path: Path) -> tuple[np.ndarray, np.ndarray]:
    raw = np.frombuffer(path.read_bytes(), dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(imgs), labels


def _read_bin(path: Path) -> tuple[np.ndarray, np.ndarray]:
    imgs, labels = _read_bin_u8(path)
    return imgs.astype(np.float32) / 255.0, labels


def _synthetic(n: int, seed: int, noise: float = 0.2):
    proto_rng = np.random.default_rng(4242)
    coarse = proto_rng.random((10, 8, 8, 3)).astype(np.float32)
    protos = np.kron(coarse, np.ones((4, 4, 1), np.float32))  # [10, 32, 32, 3]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    scale = rng.uniform(0.7, 1.0, size=(n, 1, 1, 1)).astype(np.float32)
    imgs = protos[labels] * scale + rng.normal(0, noise, (n, 32, 32, 3)).astype(
        np.float32
    )
    return np.clip(imgs, 0.0, 1.0), labels


@lru_cache(maxsize=1)
def load_cifar10_u8(n_train: int = 50_000, seed: int = 0):
    """Raw uint8 NHWC training images + int32 labels (real binaries when
    present, quantized synthetic otherwise) — the device-side-normalization
    input format (pair with :func:`normalize_on_device`).  Always
    returns exactly ``n_train`` rows (short real datasets are tiled)."""
    d = _find_loader_dir()
    if d is not None:
        parts = sorted(d.glob("data_batch_*.bin")) or [d / "train.bin"]
        xs, ys = zip(*(_read_bin_u8(p) for p in parts))
        x, y = np.concatenate(xs), np.concatenate(ys)
        provenance = "real"
        if len(x) < n_train:
            reps = -(-n_train // len(x))
            x = np.tile(x, (reps, 1, 1, 1))
            y = np.tile(y, reps)
    else:
        x01, y = _synthetic(n_train, seed)
        x = np.round(x01 * 255.0).astype(np.uint8)
        provenance = "synthetic"
    return {"x": x[:n_train], "y": y[:n_train], "provenance": provenance}


@lru_cache(maxsize=1)
def load_cifar10(n_train: int = 50_000, n_test: int = 10_000, seed: int = 0):
    d = _find_dir()
    if d is not None:
        train_parts = sorted(d.glob("data_batch_*.bin"))
        xs, ys = zip(*(_read_bin(p) for p in train_parts))
        x_tr, y_tr = np.concatenate(xs), np.concatenate(ys)
        x_te, y_te = _read_bin(d / "test_batch.bin")
    else:
        x_tr, y_tr = _synthetic(n_train, seed)
        x_te, y_te = _synthetic(n_test, seed + 1)

    def norm(x):
        return ((x - MEAN) / STD).astype(np.float32)

    return {
        "x_train": norm(x_tr[:n_train]),
        "y_train": y_tr[:n_train],
        "x_test": norm(x_te[:n_test]),
        "y_test": y_te[:n_test],
    }


_NORM_CONSTS: dict = {}


def normalize_on_device(x_uint8, dtype=None):
    """Device-side CIFAR-10 normalization of a raw uint8 NHWC batch tensor,
    computed in ``dtype`` (default float32) on the batch's device: the
    counterpart of the JAX package's ``native_loader.normalize_on_device``.
    The per-channel constants are uploaded once per device and dtype, so a
    train step does not copy them from the host (a synchronous copy would
    wait for the card)."""
    import torch

    dtype = dtype or torch.float32
    key = (x_uint8.device, dtype)
    if key not in _NORM_CONSTS:
        mean = torch.as_tensor(MEAN, dtype=dtype, device=x_uint8.device) * 255.0
        inv = 1.0 / (torch.as_tensor(STD, dtype=dtype, device=x_uint8.device) * 255.0)
        _NORM_CONSTS[key] = (mean, inv)
    mean, inv = _NORM_CONSTS[key]
    return (x_uint8.to(dtype) - mean) * inv
