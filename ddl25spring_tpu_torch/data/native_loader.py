"""ctypes binding of the native C++ CIFAR-10 loader and prefetcher: the
port's copy of the JAX package's ``data/native_loader.py``.

The input pipeline around the train step is native C++
(``native/dataloader.cc``): parsing, per-epoch shuffling, optional
normalization and batch assembly run in worker threads that prefetch ahead
of the step loop.  The shared library is built at first use (``make -C
native libddl25_dataloader.so``); :class:`NativeCifar10Loader` is a Python
iterator of numpy batches.  Callers that can do without streaming catch
:class:`NativeLoaderUnavailable` (no toolchain, no data).  The device-side
normalization of raw uint8 batches is :func:`~ddl25spring_tpu_torch.data.
cifar10.normalize_on_device`.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_NAME = "libddl25_dataloader.so"
_lock = threading.Lock()
_lib = None


class NativeLoaderUnavailable(RuntimeError):
    """Toolchain or data missing: use the numpy path instead."""


def load_native_lib(lib_name: str) -> ctypes.CDLL:
    """Build on demand and load a ``native/`` shared library.  Raises
    :class:`NativeLoaderUnavailable` when the toolchain or the artifact is
    unusable (callers fall back to Python)."""
    so = _NATIVE_DIR / lib_name
    if not so.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), lib_name],
                check=True, capture_output=True, text=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise NativeLoaderUnavailable(f"building {lib_name} failed: {detail}") from e
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:  # wrong arch / corrupt .so: fall back, don't crash
        raise NativeLoaderUnavailable(f"loading {so} failed: {e}") from e


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_native_lib(_LIB_NAME)
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.dl_error.restype = ctypes.c_char_p
        lib.dl_error.argtypes = [ctypes.c_void_p]
        lib.dl_num_samples.restype = ctypes.c_long
        lib.dl_num_samples.argtypes = [ctypes.c_void_p]
        lib.dl_next.restype = ctypes.c_long
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeCifar10Loader:
    """Infinite iterator of ``(x [B, 32, 32, 3], y [B] int32)`` numpy
    batches, prefetched and shuffled per epoch in C++ worker threads.

    Deterministic for a given ``seed`` (per-epoch Fisher-Yates on the C++
    side, whatever ``workers``); :attr:`epoch` is the epoch of the last batch
    yielded.  ``normalize=False`` yields raw uint8 NHWC pixels instead of
    normalized float32: 4x fewer bytes to the card, normalized there by
    :func:`~ddl25spring_tpu_torch.data.cifar10.normalize_on_device`."""

    def __init__(self, data_dir: str | Path, batch_size: int, seed: int = 0,
                 prefetch_depth: int = 4, workers: int = 2, normalize: bool = True):
        lib = _load_lib()
        self._lib = lib
        self.normalize = normalize
        self._handle = lib.dl_create(str(data_dir).encode(), batch_size, seed,
                                     prefetch_depth, workers, int(normalize))
        err = lib.dl_error(self._handle)
        if err:
            msg = err.decode()
            lib.dl_destroy(self._handle)
            self._handle = None
            raise NativeLoaderUnavailable(msg)
        self.batch_size = batch_size
        self.num_samples = lib.dl_num_samples(self._handle)
        self.epoch = 0

    def next_into(self, x: np.ndarray, y: np.ndarray) -> int:
        """Write the next batch into ``x`` (``[B, 32, 32, 3]``, float32 when
        normalizing, else uint8) and ``y`` (``[B]`` int32), both C-contiguous,
        in place (a pinned buffer's numpy view, say); returns its epoch, or
        -1 once the loader is closed or has failed."""
        dtype = np.float32 if self.normalize else np.uint8
        if (x.shape != (self.batch_size, 32, 32, 3) or x.dtype != dtype
                or y.shape != (self.batch_size,) or y.dtype != np.int32
                or not (x.flags.c_contiguous and y.flags.c_contiguous)):
            raise ValueError(f"next_into wants C-contiguous x [{self.batch_size}, 32, 32, 3] "
                             f"{np.dtype(dtype).name} and y [{self.batch_size}] int32, got "
                             f"{x.shape} {x.dtype} and {y.shape} {y.dtype}")
        if self._handle is None:
            return -1
        epoch = self._lib.dl_next(self._handle, x.ctypes.data_as(ctypes.c_void_p),
                                  y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if epoch >= 0:
            self.epoch = int(epoch)
        return int(epoch)

    def __iter__(self):
        dtype = np.float32 if self.normalize else np.uint8
        x = np.empty((self.batch_size, 32, 32, 3), dtype)
        y = np.empty((self.batch_size,), np.int32)
        while self.next_into(x, y) >= 0:
            yield x.copy(), y.copy()

    def close(self):
        if self._handle is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        # at interpreter teardown the module globals may already be gone: a
        # finalizer must reach the native free without global lookups
        try:  # noqa: SIM105
            self.close()
        except Exception:
            pass
