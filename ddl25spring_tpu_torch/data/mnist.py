"""MNIST data pipeline.

The reference pulls MNIST through torchvision with download
(``lab/tutorial_1a/hfl_complete.py:26-31``) and normalizes with the canonical
(0.1307, 0.3081) train statistics.  This build runs in a zero-egress
environment, so the loader has two paths:

1. real MNIST from raw IDX files if present (``DDL25_MNIST_DIR`` env var or
   ``./data/mnist``) — same bytes torchvision would download;
2. a deterministic synthetic MNIST-like dataset (class-prototype + noise)
   with identical shapes/dtypes, sufficient for every equivalence and
   convergence test in the suite.  Golden accuracy tables from
   ``lab/series01.ipynb`` are only reproducible with real data.

Arrays are NHWC ``float32`` ``[N, 28, 28, 1]``, normalized like the reference.

The PyTorch port's copy of the JAX package's ``data/mnist.py``: numpy only,
the same arrays byte for byte.  The models take the NHWC arrays as they are
(:mod:`~ddl25spring_tpu_torch.models.mnist_cnn` views ``[B, 28, 28, 1]`` as
NCHW ``[B, 1, 28, 28]``, the same bytes since C = 1).
"""

from __future__ import annotations

import gzip
import os
import struct
from functools import lru_cache
from pathlib import Path

import numpy as np

MEAN, STD = 0.1307, 0.3081


def _norm(x: np.ndarray) -> np.ndarray:
    """[N,28,28] in [0,1] -> normalized NHWC float32 (reference constants)."""
    return ((x - MEAN) / STD)[..., None].astype(np.float32)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find_idx_dir() -> Path | None:
    for cand in (os.environ.get("DDL25_MNIST_DIR"), "data/mnist", "data/MNIST/raw"):
        if cand and Path(cand).exists():
            d = Path(cand)
            for stem in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
                if (d / stem).exists() or (d / (stem + ".gz")).exists():
                    return d
    return None


def _synthetic(n: int, seed: int, noise: float = 0.25) -> tuple[np.ndarray, np.ndarray]:
    """Class-prototype images + per-sample amplitude jitter + gaussian noise:
    learnable to high accuracy by a CNN, fully deterministic.  The prototypes
    are blocky (4x4 upsampled) so convolutions have local structure to find.
    """
    # class structure is FIXED (independent of `seed`) so train/test splits
    # sample from the same distribution; `seed` only drives the sampling
    proto_rng = np.random.default_rng(777)
    coarse = (proto_rng.random((10, 7, 7)) < 0.35).astype(np.float32)
    protos = np.kron(coarse, np.ones((4, 4), np.float32))  # [10, 28, 28]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    scale = rng.uniform(0.6, 1.0, size=(n, 1, 1)).astype(np.float32)
    imgs = protos[labels] * scale + rng.normal(0.0, noise, (n, 28, 28)).astype(
        np.float32
    )
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs.astype(np.float32), labels


@lru_cache(maxsize=1)
def load_digits_28x28(
    n_train: int = 1437, n_test: int = 360, seed: int = 0
) -> dict[str, np.ndarray]:
    """REAL handwritten-digit data with MNIST shapes, zero egress.

    sklearn ships the UCI Optical-Recognition-of-Handwritten-Digits set
    (1,797 8x8 images) inside the package, so this is genuine handwritten
    pixel data available on the image: upsampled 8x8 -> 24x24 (x3 kron)
    and zero-padded to 28x28, scaled to [0,1], normalized with the same
    constants as :func:`load_mnist` so it drops into every MNIST consumer
    (MnistCnn, the FL servers, the sweep harness).

    Purpose: the synthetic prototype set saturates every FL config at
    ~100% (RESULTS.md §2), hiding the FedSGD-vs-FedAvg separation the
    homework sweeps exist to show; on this real data the separation and
    the non-IID trends manifest.  The golden `series01.ipynb` tables
    remain pinned to true MNIST (``DDL25_MNIST_DIR``) — different
    dataset, different absolute numbers.
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = (d.images.astype(np.float32) / 16.0).clip(0.0, 1.0)
    up = np.kron(imgs, np.ones((3, 3), np.float32))  # [N, 24, 24]
    up = np.pad(up, ((0, 0), (2, 2), (2, 2)))
    labels = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(up))
    up, labels = up[order], labels[order]
    if n_train + n_test > len(up):
        raise ValueError(
            f"digits has {len(up)} samples < {n_train}+{n_test} requested"
        )
    return {
        "x_train": _norm(up[:n_train]),
        "y_train": labels[:n_train],
        "x_test": _norm(up[n_train:n_train + n_test]),
        "y_test": labels[n_train:n_train + n_test],
    }


@lru_cache(maxsize=1)
def load_mnist(
    n_train: int = 60_000, n_test: int = 10_000, seed: int = 0
) -> dict[str, np.ndarray]:
    """Return ``{"x_train","y_train","x_test","y_test"}`` normalized NHWC."""
    d = _find_idx_dir()
    if d is not None:
        def grab(stem_img, stem_lbl):
            def first(*names):
                for nm in names:
                    for suf in ("", ".gz"):
                        p = d / (nm + suf)
                        if p.exists():
                            return p
                raise FileNotFoundError(nm)

            x = _read_idx(first(stem_img, stem_img.replace("-idx", ".idx")))
            y = _read_idx(first(stem_lbl, stem_lbl.replace("-idx", ".idx")))
            return x.astype(np.float32) / 255.0, y.astype(np.int32)

        x_tr, y_tr = grab("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
        x_te, y_te = grab("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    else:
        x_tr, y_tr = _synthetic(n_train, seed)
        x_te, y_te = _synthetic(n_test, seed + 1)

    return {
        "x_train": _norm(x_tr[:n_train]),
        "y_train": y_tr[:n_train],
        "x_test": _norm(x_te[:n_test]),
        "y_test": y_te[:n_test],
    }
