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
:func:`timed_run` times the steps; :func:`report_line` is the one-line JSON
record the entry points print.

Where the JAX step is a pure function of ``(params, opt_state, batch)``
that returns new ones, the port's step updates its module and optimizer in
place (as :mod:`~ddl25spring_tpu_torch.parallel.dp` does): ``step(batch)``
returns the loss, or None on a pipeline rank that is not the last stage.

Not ported yet (ROADMAP): the K-steps-per-dispatch
``build_resnet_scan_step``, the native streaming ``InputFeed``, the
compute counterfactual, and the JAX builders' ``instrument`` and
``sentinel`` options.
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
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.mesh import cards_used

BASELINE_SAMPLES_PER_SEC_PER_CHIP = 5_000.0


def _nchw(x_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A raw NHWC uint8 batch, normalized in ``dtype``, as an NCHW tensor: in
    ``channels_last`` memory on CUDA (the permute moves no bytes), contiguous
    on the CPU (torch's CPU backward of a 1x1 stride-2 conv over a narrow
    ``channels_last`` input crashes the process)."""
    x = normalize_on_device(x_u8, dtype).permute(0, 3, 1, 2)
    return x if x.device.type == "cuda" else x.contiguous()


def build_resnet_step(mesh=None, num_microbatches: int = 1, batch: int = 1024,
                      lr: float = 0.1, dtype: torch.dtype | None = None, *,
                      device=None, seed: int = 0, overlap: bool = False):
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
    D, S = (mesh.grid.data, mesh.grid.stages) if mesh is not None else (1, 1)
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
            mesh, M, inject_fn=lambda b: _nchw(b["x"], dtype), compute_dtype=dtype)

        def step(raw):
            return inner({"x": raw[0], "y": raw[1]})

        layout, topo = "dppp", f"mesh(data={D}, stage={S}), microbatches={M}"
    else:
        shapes = None
        module = ResNet18(norm="group", dtype=dtype,
                          generator=torch.Generator().manual_seed(seed)).to(dev, memory_format=fmt)
        opt = torch.optim.SGD(module.parameters(), lr=lr, momentum=0.9)

        def loss_fn(model, raw):
            return cross_entropy_logits(model(_nchw(raw[0], dtype)), raw[1])

        if mesh is None:
            inner = make_train_step(module, loss_fn, opt)

            def step(raw):
                return inner((raw[0].to(dev), raw[1].to(dev)))
        else:
            step = make_dp_train_step(module, loss_fn, opt, mesh, overlap=overlap)
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
    :meth:`feed` returns the epoch's second batch.

    ``device`` follows :func:`~ddl25spring_tpu_torch.utils.device.resolve_device`:
    CUDA unless ``"cpu"`` is asked for; no GPU raises."""

    input_mode = "hbm-resident-shuffle"

    def __init__(self, batch: int, n_train: int | None = None, device=None):
        self.device = resolve_device(device)
        d = load_cifar10_u8(n_train=n_train or 50_000)
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
        self._epoch, self._perm = None, None
        self.fixed = self.feed()

    def _permutation(self, epoch: int) -> torch.Tensor:
        if epoch != self._epoch:
            self._gen.manual_seed((self.seed << 32) + epoch)
            self._perm = torch.randperm(self.n, generator=self._gen, device=self.device)
            self._epoch = epoch
        return self._perm

    def feed(self):
        # epoch/offset arithmetic on host Python ints
        epoch, b = divmod(self._i, self.batches_per_epoch)
        self._i += 1
        idx = self._permutation(epoch % (2**31 - 1))[b * self.batch:(b + 1) * self.batch]
        return self.x[idx], self.y[idx]

    @property
    def cursor(self) -> int:
        """The position in the batch sequence (the next :meth:`feed`); with
        :attr:`seed` it pins the batches that follow."""
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


def timed_run(step, feed, steps: int, warmup: int, device=None):
    """``warmup`` steps, then ``steps`` timed ones: ``step(feed())`` each.
    Returns ``(dt, losses, step_s)``: the seconds of the timed steps (from
    the host's dispatch of the first to ``device``'s idle after the last),
    the losses of every step (warm-up included; steps that return None are
    left out), read after the clock stops, and each timed step's seconds.

    On CUDA the per-step seconds come from an event recorded after each step
    on the stream, so the steps are not synchronized one by one (the time
    between two events is the card's time for a step while the host stays
    ahead of it); elsewhere they are host time."""
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
        step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        step_s = [b - a for a, b in zip(marks, marks[1:])]
    kept = [x for x in losses if x is not None]
    return dt, (torch.stack(kept).tolist() if kept else []), step_s
