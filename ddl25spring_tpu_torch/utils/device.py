"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  A missing GPU is
an error, never a silent move to the CPU: a run that was meant for the card and
measured the host instead would report numbers of the wrong machine.
"""

from __future__ import annotations

import contextlib

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


_FLAGS = {
    "cudnn_benchmark": (torch.backends.cudnn, "benchmark"),
    "cudnn_deterministic": (torch.backends.cudnn, "deterministic"),
    "cudnn_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
}


@contextlib.contextmanager
def backend_flags(**flags: bool):
    """Set cuDNN and cuBLAS flags for the block and put them back after:
    ``cudnn_benchmark``, ``cudnn_deterministic``, ``cudnn_tf32`` and
    ``matmul_tf32`` (TF32 for cuDNN's convolutions and cuBLAS's float32
    products)."""
    targets = [(*_FLAGS[k], v) for k, v in flags.items()]
    saved = [getattr(mod, name) for mod, name, _ in targets]
    for mod, name, value in targets:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(targets, saved):
            setattr(mod, name, value)
