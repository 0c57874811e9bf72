"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  A missing GPU is
an error, never a silent move to the CPU: a run that was meant for the card and
measured the host instead would report numbers of the wrong machine.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device.  A CUDA device that is not there
    raises ``RuntimeError``; ``"cpu"`` is taken as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    return dev
