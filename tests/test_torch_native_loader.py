"""The port's native C++ loader binding (``ddl25spring_tpu_torch/data/
native_loader.py``) and the synthesized binaries of ``data/cifar10.
ensure_bin_dir``, against the JAX package's, on the CPU: twins of
``tests/test_native_loader.py`` (parse equivalence with numpy, determinism
and epoch coverage, raw uint8 mode against the device normalization, a
missing directory refused), the two packages' synthesized ``train.bin``
bitwise, and their loaders' first batches bitwise on one directory; the
bench's ``InputFeed`` streaming those batches on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu_torch.data.cifar10 import MEAN, STD  # noqa: E402
from ddl25spring_tpu_torch.data.native_loader import (  # noqa: E402
    NativeCifar10Loader,
    NativeLoaderUnavailable,
)

N = 64  # records in the fixture file


@pytest.fixture(scope="module")
def bin_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar_bin")
    rng = np.random.default_rng(7)
    recs = []
    for i in range(N):
        label = np.array([i % 10], np.uint8)
        pixels = rng.integers(0, 256, 3072, dtype=np.uint8)  # CHW bytes
        recs.append(np.concatenate([label, pixels]))
    (d / "data_batch_1.bin").write_bytes(np.concatenate(recs).tobytes())
    return d


def _numpy_reference(path):
    raw = np.frombuffer((path / "data_batch_1.bin").read_bytes(), np.uint8).reshape(-1, 3073)
    y = raw[:, 0].astype(np.int32)
    x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = (x.astype(np.float32) / 255.0 - MEAN) / STD
    return x, y


def test_native_matches_numpy_normalization(bin_dir):
    loader = NativeCifar10Loader(bin_dir, batch_size=N, seed=0, workers=1)
    x_ref, y_ref = _numpy_reference(bin_dir)
    x, y = next(iter(loader))
    assert loader.num_samples == N
    assert sorted(y.tolist()) == sorted(y_ref.tolist())

    # batch 0 is a permutation of the file: denormalizing recovers the exact
    # uint8 pixels, which identify each record unambiguously
    def debytes(arr):
        px = np.rint((arr * STD + MEAN) * 255.0).clip(0, 255).astype(np.uint8)
        return px.tobytes()

    ref_by_key = {(int(y_ref[i]), debytes(x_ref[i])): x_ref[i] for i in range(N)}
    assert len(ref_by_key) == N
    for i in range(N):
        key = (int(y[i]), debytes(x[i]))
        assert key in ref_by_key, f"record {i} not found in reference"
        np.testing.assert_allclose(x[i], ref_by_key[key], atol=2e-5)
    loader.close()


def test_native_deterministic_and_epochs(bin_dir):
    a = NativeCifar10Loader(bin_dir, batch_size=16, seed=3, workers=2)
    b = NativeCifar10Loader(bin_dir, batch_size=16, seed=3, workers=1)
    ita, itb = iter(a), iter(b)
    seen = []
    for _ in range(N // 16 + 2):  # crosses an epoch boundary
        xa, ya = next(ita)
        xb, yb = next(itb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(xa, xb)
        seen.append(ya)
    # the first epoch covered every record exactly once
    first_epoch = np.concatenate(seen[: N // 16])
    assert len(first_epoch) == N
    counts = np.bincount(first_epoch, minlength=10)
    assert counts.sum() == N and counts.max() == N // 10 + (N % 10 > 0)
    assert a.epoch == 1 and b.epoch == 1
    a.close()
    b.close()


def test_raw_mode_matches_device_normalization(bin_dir):
    from ddl25spring_tpu_torch.data.cifar10 import normalize_on_device

    raw = NativeCifar10Loader(bin_dir, batch_size=16, seed=5, workers=1, normalize=False)
    ref = NativeCifar10Loader(bin_dir, batch_size=16, seed=5, workers=1)
    xr, yr = next(iter(raw))
    xf, yf = next(iter(ref))
    assert xr.dtype == np.uint8
    np.testing.assert_array_equal(yr, yf)
    np.testing.assert_allclose(normalize_on_device(torch.from_numpy(xr)).numpy(), xf, atol=1e-5)
    raw.close()
    ref.close()


def test_next_into_fills_the_callers_buffers_with_the_iterators_batches(bin_dir):
    """``next_into`` writes the batches the iterator yields, in order, into
    the caller's arrays (the pinned buffers of ``InputFeed`` on the card),
    and refuses arrays of another shape, dtype or layout."""
    it = iter(NativeCifar10Loader(bin_dir, batch_size=16, seed=3, normalize=False, workers=2))
    into = NativeCifar10Loader(bin_dir, batch_size=16, seed=3, normalize=False, workers=2)
    x, y = np.empty((16, 32, 32, 3), np.uint8), np.empty((16,), np.int32)
    for _ in range(6):  # past an epoch of 4 batches
        rx, ry = next(it)
        assert into.next_into(x, y) == into.epoch
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    for bad in (np.empty((16, 32, 32, 3), np.float32), np.empty((8, 32, 32, 3), np.uint8),
                np.empty((16, 3, 32, 32), np.uint8).transpose(0, 2, 3, 1)):
        with pytest.raises(ValueError):
            into.next_into(bad, y)
    into.close()
    assert into.next_into(x, y) == -1


def test_missing_dir_raises(tmp_path):
    with pytest.raises(NativeLoaderUnavailable):
        NativeCifar10Loader(tmp_path / "nope", batch_size=8)


@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    """Each package's ``ensure_bin_dir`` into a directory of its own (no real
    CIFAR-10 on the search path)."""
    from ddl25spring_tpu.data import cifar10 as jax_cifar
    from ddl25spring_tpu_torch.data import cifar10 as port_cifar

    mp = pytest.MonkeyPatch()
    mp.delenv("DDL25_CIFAR10_DIR", raising=False)
    mp.setattr(port_cifar, "_find_loader_dir", lambda: None)
    mp.setattr(jax_cifar, "_find_loader_dir", lambda: None)
    root = tmp_path_factory.mktemp("synth")
    try:
        port = port_cifar.ensure_bin_dir(256, seed=3, synth_dir=str(root / "port"))
        jax = jax_cifar.ensure_bin_dir(256, seed=3, synth_dir=str(root / "jax"))
    finally:
        mp.undo()
    return port, jax


def test_synthesized_binaries_equal_the_jax_packages(synth_dirs):
    (pd, pprov), (jd, jprov) = synth_dirs
    assert pprov == jprov == "synthetic"
    assert (pd / "train.bin").read_bytes() == (jd / "train.bin").read_bytes()
    assert (pd / "train.bin").stat().st_size == 256 * 3073
    assert not list(pd.glob("*.tmp*"))


@pytest.mark.parametrize("normalize", [False, True], ids=["uint8", "float32"])
def test_first_batches_equal_the_jax_loaders(synth_dirs, normalize):
    """The port's binding and JAX's over one directory, same seed: the first
    three batches (into the second epoch) bitwise."""
    from ddl25spring_tpu.data.native_loader import NativeCifar10Loader as JaxLoader

    (d, _), _ = synth_dirs
    port = NativeCifar10Loader(d, batch_size=96, seed=11, workers=2, normalize=normalize)
    jax = JaxLoader(d, batch_size=96, seed=11, workers=2, normalize=normalize)
    try:
        for (xp, yp), (xj, yj), _ in zip(port, jax, range(3)):
            assert xp.dtype == xj.dtype and xp.shape == (96, 32, 32, 3)
            np.testing.assert_array_equal(xp, xj)
            np.testing.assert_array_equal(yp, yj)
    finally:
        port.close()
        jax.close()


def test_input_feed_streams_on_the_cpu(synth_dirs, monkeypatch):
    """``InputFeed(stream=True)`` on the CPU: the fixed batch is the first
    streamed one, the next feeds are the loader's next batches, as uint8
    torch tensors; ``stream=False`` re-feeds the first rows of the train
    split and says ``fixed-device-batch``."""
    from ddl25spring_tpu_torch import benchmarks
    from ddl25spring_tpu_torch.data import cifar10

    (d, _), _ = synth_dirs
    monkeypatch.setattr(cifar10, "ensure_bin_dir", lambda: (d, "synthetic"))
    feed = benchmarks.InputFeed(32, stream=True, workers=2, prefetch_depth=2, device="cpu")
    ref = NativeCifar10Loader(d, batch_size=32, normalize=False, workers=1)
    try:
        assert feed.streaming and feed.input_mode == "native-stream-uint8"
        got = [feed.feed_fixed(), feed.feed(), feed.feed()]
        for (x, y), (rx, ry) in zip(got, ref):
            assert x.dtype == torch.uint8 and x.device.type == "cpu"
            assert torch.equal(x, torch.from_numpy(rx)) and torch.equal(y, torch.from_numpy(ry))
    finally:
        feed.close()
        ref.close()
    assert not feed.streaming and feed.feed() is feed.fixed
    fixed = benchmarks.InputFeed(8, stream=False, device="cpu")
    assert fixed.input_mode == "fixed-device-batch" and fixed.feed() is fixed.feed_fixed()
    assert fixed.fixed[0].shape == (8, 32, 32, 3) and fixed.fixed[0].dtype == torch.uint8
