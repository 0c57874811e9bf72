"""The ResNet input's scan mode on the CPU: ``DeviceDataset.scan_window``
against ``feed()`` (window ``w`` selects, bitwise, the batches that
``feed()`` selects at cursors ``w*K .. w*K + K-1`` of a fresh dataset, over
two epochs), its refusal of a K that does not divide the epoch, its cursor
counting windows, and ``build_resnet_scan_step`` (K = 2, batch 2, 8 rows)
against two sequential ``build_resnet_step`` steps, bitwise: on the CPU the
fused window is a loop of the same step (NCHW, ``benchmarks._nchw``), and
the gather reads the same rows.  The CUDA graph of the window runs on the
card (``chip_smoke.py`` phase 11 (c)).
"""

import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch import benchmarks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: the suite runs its files side by side
    on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(batch, n_train):
    ds = benchmarks.DeviceDataset(batch, n_train=n_train, device="cpu")
    ds.cursor = 0  # the constructor drew the fixed batch
    return ds


def test_windows_select_the_batches_feed_selects():
    K = 4
    feeds = _fresh(8, 64)
    want = [feeds.feed() for _ in range(16)]  # epochs 0 and 1, 8 batches each
    ds = _fresh(8, 64)
    for w in range(4):
        offsets = ds.scan_window(K)
        assert offsets.dtype == torch.int64 and offsets.shape == (K,)
        assert ds.cursor == w + 1  # the cursor counts windows
        for i in range(K):
            x, y = ds.gather(offsets[i])
            wx, wy = want[w * K + i]
            assert torch.equal(x, wx) and torch.equal(y, wy)
    # the epochs differ, so the test would see a window that read the wrong one
    assert not torch.equal(want[0][1], want[8][1])


def test_a_window_never_crosses_an_epoch():
    ds = _fresh(8, 64)
    with pytest.raises(ValueError, match="must divide batches_per_epoch=8"):
        ds.scan_window(3)
    assert ds.cursor == 0


def test_scan_step_equals_sequential_steps():
    kw = dict(lr=0.01, device="cpu", seed=3)
    ds = _fresh(2, 8)
    multi, step1, module, _, meta = benchmarks.build_resnet_scan_step(
        None, 1, 2, scan_steps=2, dataset=ds, **kw)
    assert meta["scan_steps"] == 2 and meta["layout"] == "dp"
    ds.cursor = 1  # window 1: batches 2 and 3 of epoch 0
    fused = multi(ds.scan_window(2))

    step, ref, _, _ = benchmarks.build_resnet_step(None, 1, 2, **kw)
    feeds = _fresh(2, 8)
    feeds.cursor = 2
    seq = torch.stack([step(feeds.feed()) for _ in range(2)])
    assert fused.shape == (2,) and torch.equal(fused, seq)
    for a, b in zip(module.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="batches of 2, the step takes 4"):
        benchmarks.build_resnet_scan_step(None, 1, 4, scan_steps=2, dataset=ds, **kw)
    with pytest.raises(ValueError, match="must divide"):
        benchmarks.build_resnet_scan_step(None, 1, 2, scan_steps=3, dataset=ds, **kw)
