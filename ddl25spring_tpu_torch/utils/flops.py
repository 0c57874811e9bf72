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
there.  An unknown card and the CPU have no peak, and their MFU is None.
"""

from __future__ import annotations

import torch

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
