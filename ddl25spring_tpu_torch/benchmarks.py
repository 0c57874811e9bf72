"""The ResNet-18/CIFAR-10 train step of the north-star benchmark: the
counterpart of the JAX package's ``benchmarks.py``.

:func:`build_resnet_step` builds the step of one rank (or of one process on
one device): pure DP over ``ResNet18(norm="group")`` when the rank grid has
one stage (layout ``"dp"``), the S-stage heterogeneous GPipe pipeline x DP
otherwise (``"dppp"``).  The step takes a raw uint8 NHWC batch
``(x_u8 [B, 32, 32, 3], y [B])`` and normalizes it on the device inside the
step, in the compute dtype; the permute to NCHW is free, because the NHWC
bytes are ``channels_last`` memory.  :class:`DeviceDataset` keeps the whole
train split on the device and draws each step's batch there;
:func:`build_resnet_scan_step` runs ``K`` steps per dispatch, the batches
drawn inside one CUDA graph (:meth:`DeviceDataset.scan_window`);
:func:`timed_run` times the steps or the windows; :func:`report_line` is the
one-line JSON record the entry points print.

Where the JAX step is a pure function of ``(params, opt_state, batch)``
that returns new ones, the port's step updates its module and optimizer in
place (as :mod:`~ddl25spring_tpu_torch.parallel.dp` does): ``step(batch)``
returns the loss, or None on a pipeline rank that is not the last stage.

Not ported yet (ROADMAP): the native streaming ``InputFeed`` and the
compute counterfactual.
"""

from __future__ import annotations

import json
import time

import torch

from ddl25spring_tpu_torch.data.cifar10 import load_cifar10_u8, normalize_on_device
from ddl25spring_tpu_torch.models.resnet import ResNet18, boundary_shapes, resnet_stage
from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
from ddl25spring_tpu_torch.parallel import bucketing
from ddl25spring_tpu_torch.parallel.dp import make_dp_train_step, make_train_step
from ddl25spring_tpu_torch.parallel.het_pipeline import make_het_pipeline_train_step
from ddl25spring_tpu_torch.parallel.pipeline import fuse_train_steps
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.mesh import cards_used

BASELINE_SAMPLES_PER_SEC_PER_CHIP = 5_000.0
TRAIN_ROWS = 50_000  # CIFAR-10's train split


def _nchw(x_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A raw NHWC uint8 batch, normalized in ``dtype``, as an NCHW tensor: in
    ``channels_last`` memory on CUDA (the permute moves no bytes), contiguous
    on the CPU (torch's CPU backward of a 1x1 stride-2 conv over a narrow
    ``channels_last`` input crashes the process)."""
    x = normalize_on_device(x_u8, dtype).permute(0, 3, 1, 2)
    return x if x.device.type == "cuda" else x.contiguous()


def build_resnet_step(mesh=None, num_microbatches: int = 1, batch: int = 1024,
                      lr: float = 0.1, dtype: torch.dtype | None = None, *,
                      device=None, seed: int = 0, overlap: bool = False,
                      instrument: bool | None = None, sentinel: bool | None = None):
    """The north-star train step of this rank of ``mesh``
    (:func:`~ddl25spring_tpu_torch.utils.mesh.init_mesh`; ``data x stages``
    ranks), or of this process alone on ``device`` when ``mesh`` is None (one
    replica, one stage: nothing to reduce).

    ``stages == 1`` -> pure DP (layout ``"dp"``) through
    :func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step`;
    ``stages`` in 2..4 -> the heterogeneous pipeline x DP (``"dppp"``) over
    ``make_resnet_stages(stages)``, stage ``s`` alone on rank ``(d, s)``, with
    ``num_microbatches`` microbatches.  ``batch`` is the global batch and must
    divide by ``data * num_microbatches``.  SGD with momentum 0.9 at ``lr``
    (``optax.sgd(lr, momentum=0.9)``, step for step).  ``dtype`` is the
    compute dtype (default bf16 on CUDA, float32 on the CPU); parameters are
    float32, and on CUDA in ``channels_last`` memory.  Weights come from
    ``seed`` (stage ``s`` from ``seed + s``).

    ``overlap`` (pure DP only; ``stages > 1`` raises ``ValueError``, as in
    the JAX function): each gradient bucket's all-reduce is issued from the
    backward as it completes (:func:`~ddl25spring_tpu_torch.parallel.dp.
    make_dp_train_step`'s ``overlap``), and the layout is named
    ``"dp-overlap"``.  With one process and no mesh there is nothing to
    reduce, and only the name changes.

    Returns ``(step, module, optimizer, meta)``: ``step((x_u8, y))`` updates
    ``module`` (this rank's model or stage) and ``optimizer`` in place and
    returns the loss (None off the last stage); ``meta`` carries the layout,
    topology, the number of cards the world's ranks share
    (:func:`~ddl25spring_tpu_torch.utils.mesh.cards_used`), boundary shapes
    and this rank's parameter count.  The JAX function's ``donate`` has no
    counterpart: the update is in place, so parameters and momentum exist
    once anyway."""
    D, S = (mesh.grid.data, mesh.grid.size) if mesh is not None else (1, 1)
    if S not in (1, 2, 3, 4):
        raise ValueError(f"resnet pipeline supports S in (1, 2, 3, 4), got {S}")
    if overlap and S != 1:
        raise ValueError("overlap applies to the pure-DP layout (S == 1); the DPxPP het "
                         "pipeline owns its own gradient reduction")
    dev = mesh.device if mesh is not None else resolve_device(device)
    M = num_microbatches if S >= 2 else 1
    if batch % (D * M):
        raise ValueError(f"batch {batch} not divisible by dp*M = {D * M}")
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    fmt = torch.channels_last if dev.type == "cuda" else torch.preserve_format

    if S >= 2:
        shapes = boundary_shapes(S)
        module = resnet_stage(mesh.coords[1], S, dtype=dtype, seed=seed).to(dev,
                                                                           memory_format=fmt)
        opt = torch.optim.SGD(module.parameters(), lr=lr, momentum=0.9)
        inner = make_het_pipeline_train_step(
            module, lambda logits, b: cross_entropy_logits(logits, b["y"]), shapes, opt,
            mesh, M, inject_fn=lambda b: _nchw(b["x"], dtype), compute_dtype=dtype,
            instrument=instrument, sentinel=sentinel)

        def step(raw):
            return inner({"x": raw[0], "y": raw[1]})

        step.guard = inner.guard

        layout, topo = "dppp", f"mesh(data={D}, stage={S}), microbatches={M}"
    else:
        shapes = None
        module = ResNet18(norm="group", dtype=dtype,
                          generator=torch.Generator().manual_seed(seed)).to(dev, memory_format=fmt)
        opt = torch.optim.SGD(module.parameters(), lr=lr, momentum=0.9)

        def loss_fn(model, raw):
            return cross_entropy_logits(model(_nchw(raw[0], dtype)), raw[1])

        if mesh is None:
            inner = make_train_step(module, loss_fn, opt, sentinel=sentinel)

            def step(raw):
                return inner((raw[0].to(dev), raw[1].to(dev)))

            step.guard = inner.guard
        else:
            step = make_dp_train_step(module, loss_fn, opt, mesh, overlap=overlap,
                                      instrument=instrument, sentinel=sentinel)
        layout, topo = "dp-overlap" if overlap else "dp", f"mesh(data={D})"

    meta = {
        "n_chips": cards_used(D * S, dev.type),
        "batch": batch,
        "layout": layout,
        "topology": topo,
        "device": dev,
        "num_stages": S,
        "num_microbatches": M,
        "dtype": dtype,
        "boundary_shapes": shapes,
        "n_params": sum(p.numel() for p in module.parameters()),
        "bucket_bytes": bucketing.resolve_bucket_bytes(bucketing.AUTO) if D > 1 else None,
    }
    return step, module, opt, meta


def build_resnet_scan_step(mesh=None, num_microbatches: int = 1, batch: int = 1024,
                           lr: float = 0.1, dtype: torch.dtype | None = None, *,
                           scan_steps: int, dataset: "DeviceDataset", device=None,
                           seed: int = 0, overlap: bool = False,
                           instrument: bool | None = None, sentinel: bool | None = None):
    """``scan_steps`` train steps per dispatch, each drawing its batch from
    ``dataset`` on the device: the counterpart of the JAX
    ``build_resnet_scan_step`` (``benchmarks.py:180-246``).

    The step is :func:`build_resnet_step`'s (same arguments), and the
    dispatch :func:`~ddl25spring_tpu_torch.parallel.pipeline.
    fuse_train_steps` of it over a window of batch offsets
    (:meth:`DeviceDataset.scan_window`): on CUDA one CUDA graph of the
    ``K`` steps, each gathering its rows of the epoch's permutation with
    device-side indexing (:meth:`DeviceDataset.gather`), so no host integer
    enters the graph; on the CPU a loop of the same steps.  Where the JAX
    program draws the epoch's permutation inside the scan, the port draws it
    outside the graph, into the dataset's static permutation buffer, when
    the epoch changes.

    Returns ``(multi, step1, module, optimizer, meta)``: ``multi(window)``
    runs the window's ``K`` steps and returns their ``[K]`` losses (the JAX
    program returns the last); ``step1`` is the one-batch step (for the
    FLOP count); ``meta`` is :func:`build_resnet_step`'s with
    ``scan_steps``.  ``scan_steps`` must divide ``dataset``'s batches per
    epoch (``ValueError``), so a window never crosses an epoch; a mesh whose
    transport cannot be graphed raises (:func:`~ddl25spring_tpu_torch.
    parallel.pipeline.graph_refusal`).  ``instrument`` and ``sentinel`` as in
    :func:`build_resnet_step`; a guarded step's records fold after each
    window (:func:`~ddl25spring_tpu_torch.parallel.pipeline.fuse_train_steps`)."""
    if dataset.batch != batch:
        raise ValueError(f"the dataset draws batches of {dataset.batch}, the step takes {batch}")
    dataset.check_scan(scan_steps)
    step1, module, opt, meta = build_resnet_step(mesh, num_microbatches, batch, lr, dtype,
                                                 device=device, seed=seed, overlap=overlap,
                                                 instrument=instrument, sentinel=sentinel)

    def scan_body(off):
        return step1(dataset.gather(off))

    scan_body.guard = step1.guard

    multi = fuse_train_steps(scan_body, scan_steps, module=module, optimizer=opt,
                             device=meta["device"], comm=mesh.comm if mesh is not None else None)
    return multi, step1, module, opt, dict(meta, scan_steps=scan_steps)


class DeviceDataset:
    """The train split resident on the device, one shuffle per epoch drawn
    there: the counterpart of the JAX package's ``DeviceDataset``.

    The uint8 images (50 000 x 32 x 32 x 3 = 146.5 MiB) and labels are copied
    to ``device`` once; every :meth:`feed` returns the next batch of the
    epoch's permutation, gathered on the device, with no host-to-device
    traffic.  Epochs are drop-last: ``n // batch`` disjoint batches, the tail
    dropped.  The permutation of epoch ``e`` is ``torch.randperm`` from a
    generator on the device seeded with ``(seed << 32) + e`` (``seed`` 20, as
    the JAX class keys its shuffle), made once per epoch.  Its order is not
    ``jax.random.permutation``'s, which no torch generator reproduces; the
    properties are the same (disjoint batches, a new order every epoch,
    epoch arithmetic on host integers).  As in the JAX class, the
    constructor draws the first batch as :attr:`fixed`, so the first
    :meth:`feed` returns the epoch's second batch.  The permutation lives in
    one buffer, rewritten in place per epoch, so a CUDA graph that gathers
    from it (:meth:`scan_window`, :meth:`gather`) reads the current epoch's.

    ``device`` follows :func:`~ddl25spring_tpu_torch.utils.device.resolve_device`:
    CUDA unless ``"cpu"`` is asked for; no GPU raises."""

    input_mode = "hbm-resident-shuffle"

    def __init__(self, batch: int, n_train: int | None = None, device=None):
        self.device = resolve_device(device)
        d = load_cifar10_u8(n_train=n_train or TRAIN_ROWS)
        self.provenance = d["provenance"]
        self.x = torch.from_numpy(d["x"]).to(self.device)  # [N, 32, 32, 3] uint8
        self.y = torch.from_numpy(d["y"]).to(self.device)
        self.n = int(self.x.shape[0])
        if batch > self.n:
            raise ValueError(f"batch {batch} exceeds dataset size {self.n}")
        self.batch = batch
        self.batches_per_epoch = self.n // batch
        self._i = 0
        self.seed = 20
        self._gen = torch.Generator(device=self.device)
        self._epoch = None
        self._perm = torch.empty(self.n, dtype=torch.long, device=self.device)
        self._rows = torch.arange(batch, device=self.device)
        self.fixed = self.feed()

    def _permutation(self, epoch: int) -> torch.Tensor:
        if epoch != self._epoch:
            self._gen.manual_seed((self.seed << 32) + epoch)
            torch.randperm(self.n, generator=self._gen, device=self.device, out=self._perm)
            self._epoch = epoch
        return self._perm

    def feed(self):
        # epoch/offset arithmetic on host Python ints
        epoch, b = divmod(self._i, self.batches_per_epoch)
        self._i += 1
        idx = self._permutation(epoch % (2**31 - 1))[b * self.batch:(b + 1) * self.batch]
        return self.x[idx], self.y[idx]

    def check_scan(self, K: int):
        """Raise ``ValueError`` unless ``K`` divides the batches per epoch."""
        if K < 1 or self.batches_per_epoch % K:
            raise ValueError(f"scan_steps={K} must divide batches_per_epoch="
                             f"{self.batches_per_epoch}: a window of K batches never crosses "
                             "an epoch")

    def scan_window(self, K: int) -> torch.Tensor:
        """The next window of ``K`` consecutive disjoint batches of the
        epoch's permutation, for :func:`build_resnet_scan_step`: their
        offsets in the permutation, ``[K]`` int64 on the device, made there
        from host integers; the permutation buffer holds the window's epoch
        when this returns.  The counterpart of the JAX ``scan_window``: ``K``
        must divide the batches per epoch (``ValueError``), so a window never
        crosses an epoch, and :attr:`cursor` counts windows in this mode, so
        window ``w`` selects the batches that :meth:`feed` selects at cursors
        ``w * K .. w * K + K - 1``.  Do not interleave the two modes within a
        run."""
        self.check_scan(K)
        epoch, w = divmod(self._i, self.batches_per_epoch // K)
        self._i += 1
        self._permutation(epoch % (2**31 - 1))
        off = w * K * self.batch
        return torch.arange(off, off + K * self.batch, self.batch, device=self.device)

    def gather(self, off: torch.Tensor):
        """The batch at offset ``off`` (a 0-d int64 tensor on the device) of
        the current permutation, gathered on the device: ``(x, y)`` as
        :meth:`feed` returns them, with no host integer involved."""
        idx = self._perm.index_select(0, off + self._rows)
        return self.x.index_select(0, idx), self.y.index_select(0, idx)

    @property
    def cursor(self) -> int:
        """The position in the batch sequence (the next :meth:`feed`, or the
        next window of :meth:`scan_window`); with :attr:`seed` it pins the
        batches that follow."""
        return self._i

    @cursor.setter
    def cursor(self, value: int) -> None:
        self._i = int(value)


def report_line(layout, sps_chip, input_mode, frac, tf, **extra):
    """The one-line JSON record the entry points print: metric, value, unit
    and vs_baseline, plus self-describing fields."""
    return json.dumps({
        "metric": f"cifar10_resnet18_{layout}_samples_per_sec_per_chip",
        "value": round(sps_chip, 1),
        "unit": "samples/sec/chip",
        "vs_baseline": round(sps_chip / BASELINE_SAMPLES_PER_SEC_PER_CHIP, 3),
        "input": input_mode,
        "mfu": round(frac, 4) if frac else None,
        "achieved_tflops_per_chip": round(tf, 1) if tf else None,
        **extra,
    })


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(step, feed, steps: int, warmup: int, device=None, k: int = 1):
    """``warmup`` calls, then ``steps`` timed ones: ``step(feed())`` each.
    Returns ``(dt, losses, step_s)``: the seconds of the timed calls (from
    the host's dispatch of the first to ``device``'s idle after the last),
    the losses of every step (warm-up included; steps that return None are
    left out), read after the clock stops, and each timed call's seconds
    per step.

    With ``k > 1`` each call is a window of ``k`` fused steps
    (:func:`build_resnet_scan_step`) that returns their ``[k]`` losses, and
    its seconds are divided by ``k``.

    On CUDA the seconds come from an event recorded after each call on the
    stream, so the calls are not synchronized one by one (the time between
    two events is the card's time for a call while the host stays ahead of
    it); elsewhere they are host time."""
    cuda = device is not None and torch.device(device).type == "cuda"
    losses = [step(feed()) for _ in range(warmup)]
    _sync(device)
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    t0 = time.perf_counter()
    mark()
    for _ in range(steps):
        losses.append(step(feed()))
        mark()
    _sync(device)
    dt = time.perf_counter() - t0
    if cuda:
        step_s = [a.elapsed_time(b) / 1e3 / k for a, b in zip(marks, marks[1:])]
    else:
        step_s = [(b - a) / k for a, b in zip(marks, marks[1:])]
    kept = [x.reshape(-1) for x in losses if x is not None]
    return dt, (torch.cat(kept).tolist() if kept else []), step_s
