"""FLOPs of a train step and model FLOPs utilisation: the counterpart of the
JAX package's ``utils/flops.py`` (``compiled_flops``, ``mfu``).

The JAX package reads one step's FLOPs from XLA's cost analysis of the
compiled program.  Eager PyTorch has no compiled program, so
:func:`count_flops` runs the step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the FLOPs of the
matrix products and convolutions (forward and backward) that the step
dispatches; elementwise work, norms and the optimizer are not counted, as
they are a vanishing share of a ResNet or LLaMA step.

The peak is the card's dense bf16 rate, whatever the step's dtype (as the
JAX package's ``chip_peak_flops``), from a table matched by the prefix of
``torch.cuda.get_device_name()``: the data-sheet number of each card named
there.  An unknown card and the CPU have no data-sheet peak, and the bench
line's :func:`mfu` is None there.

The measured-MFU path (:mod:`~ddl25spring_tpu_torch.obs.perfscope`) keys on
:func:`host_peak_spec` instead, which stands a *measured* host peak in for
the CPU (:func:`calibrated_host_peak_flops`, the ``cpu-host`` pseudo-chip),
as the JAX package does, so that a CPU run's MFU is defined: a host-relative
trend number, never a comparison across machines.
"""

from __future__ import annotations

import logging
import time

import torch

_log = logging.getLogger(__name__)

#: the pseudo-chip of a CPU run: its peak is measured, not a data sheet's
CPU_HOST_KIND = "cpu-host"

# dense bf16 FLOP/s by device-name prefix (data sheets)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
}


def peak_bf16_flops(device=None) -> float | None:
    """The dense bf16 peak of ``device`` (default: the current CUDA device), or
    None for the CPU, a missing GPU and a card the table does not name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    return next((peak for prefix, peak in PEAK_BF16_FLOPS.items()
                 if name.startswith(prefix)), None)


def chip_peak_flops(device=None, allow_host: bool = True) -> float | None:
    """The per-chip peak of ``device`` (default: the card when there is one,
    else the CPU): the data-sheet bf16 rate of a card :data:`PEAK_BF16_FLOPS`
    names; on the CPU the calibrated host peak
    (:func:`calibrated_host_peak_flops`), or None with ``allow_host=False``."""
    dev = _device(device)
    if dev.type != "cuda":
        return calibrated_host_peak_flops() if allow_host else None
    return peak_bf16_flops(dev)


_HOST_PEAK: float | None = None
_HOST_PEAK_TRIED = False


def calibrated_host_peak_flops(refresh: bool = False) -> float | None:
    """The measured fp32 matmul rate of this host (FLOP/s), cached for the
    process: a chain of eight 512 x 512 products, the best of 3 timed runs
    after one untimed.  It is the ``cpu-host`` pseudo-chip's peak, so a CPU
    MFU is a host-relative trend number.  None when the calibration itself
    fails; the failure is cached too, so it is paid once."""
    global _HOST_PEAK, _HOST_PEAK_TRIED
    if _HOST_PEAK_TRIED and not refresh:
        return _HOST_PEAK
    _HOST_PEAK_TRIED = True
    m, chain = 512, 8
    flops = 2.0 * m * m * m * chain
    try:
        a = torch.full((m, m), 0.5, dtype=torch.float32)

        def run():
            x = a
            for _ in range(chain):
                x = x @ a
            return x

        run()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        _HOST_PEAK = flops / best if best > 0 else None
    except RuntimeError as e:  # degrade to None, but say why
        _log.warning("host peak calibration failed (%s)", e)
        _HOST_PEAK = None
    return _HOST_PEAK


def host_peak_spec(device=None) -> tuple[str | None, dict[str, float] | None]:
    """``(chip kind, {"peak_bf16_flops": peak})`` for the device that runs:
    on a card its name and data-sheet peak (the spec None for a card the
    table does not name); on the CPU :data:`CPU_HOST_KIND` and the
    calibrated peak, or ``(CPU_HOST_KIND, None)`` when calibration failed
    (a placeholder peak must never pass for a measurement)."""
    dev = _device(device)
    if dev.type != "cuda":
        peak = calibrated_host_peak_flops()
        return CPU_HOST_KIND, ({"peak_bf16_flops": peak} if peak else None)
    peak = peak_bf16_flops(dev)
    return torch.cuda.get_device_name(dev), ({"peak_bf16_flops": peak} if peak else None)


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops)``: the call's result and the FLOPs of
    every matrix product and convolution it ran, backward included."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()


def mfu(flops_per_step: float | None, step_time_s: float, n_chips: int = 1,
        device=None) -> tuple[float | None, float | None]:
    """``(achieved_tflops_per_chip, mfu_fraction)`` of a step of
    ``flops_per_step`` (all ranks together) that took ``step_time_s`` on
    ``n_chips`` cards.  Either is None where its ingredient is missing."""
    if flops_per_step is None or step_time_s <= 0:
        return None, None
    achieved = flops_per_step / step_time_s / max(n_chips, 1)
    peak = peak_bf16_flops(device)
    return achieved / 1e12, (achieved / peak if peak else None)
