"""Moving flax parameter trees into torch modules and back: the bridge the
parity tests and the card-vs-CPU checks pass weights through, as numpy.

A module whose submodules carry flax's names (``Conv_0``, ``Dense_1``,
``BatchNorm_0``, ``ResNetBlock_3``, ...) maps onto flax's tree with only the
layout changes: conv kernels HWIO <-> OIHW, dense ``[in, out]`` <->
``Linear.weight [out, in]``, a norm's ``scale`` <-> ``weight``, and
BatchNorm's ``batch_stats`` (``mean``, ``var``) <-> its ``running_mean`` and
``running_var`` buffers.  Exported arrays are copies, never views of the
tensors.

The exports take a module or a mapping of torch names to tensors (the
parameters a federated server keeps outside any module).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def flax_path(name: str) -> tuple[str, ...]:
    """The flax path of a torch parameter or buffer name:
    ``"ResNetBlock_0.Conv_1.weight"`` -> ``("ResNetBlock_0", "Conv_1", "kernel")``."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if path[-1].startswith(("Conv", "Dense")) else "scale"
    else:
        leaf = _LEAF[leaf]
    return (*path, leaf)


def _named(src, buffers: bool = False):
    if isinstance(src, Mapping):
        return src.items()
    return src.named_buffers() if buffers else src.named_parameters()


def to_flax(path, t: torch.Tensor) -> np.ndarray:
    """A tensor in flax's layout, as a new float32 numpy array."""
    a = t.detach().float().cpu().numpy()
    if path[-1] == "kernel":
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T  # OIHW -> HWIO; [out,in] -> [in,out]
    return np.array(a, order="C")  # a copy: a float32 CPU tensor's numpy() shares its memory


def from_flax(path, a) -> np.ndarray:
    """A flax leaf in torch's layout, as a new float32 numpy array."""
    a = np.array(a, dtype=np.float32)
    if path[-1] == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return np.ascontiguousarray(a)


def tree(items) -> dict:
    """A nested dict from ``(path, value)`` pairs."""
    out: dict = {}
    for path, value in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def export_params(src) -> dict:
    """The ``params`` tree of a module (or of a name -> tensor mapping) in
    flax's names and layouts, numpy float32."""
    return tree((flax_path(n), to_flax(flax_path(n), t)) for n, t in _named(src))


def export_grads(module: nn.Module) -> dict:
    """The ``.grad`` of every parameter as :func:`export_params` lays them out."""
    return tree((flax_path(n), to_flax(flax_path(n), t.grad))
                for n, t in module.named_parameters())


def export_batch_stats(module: nn.Module) -> dict:
    """BatchNorm's running statistics as flax's ``batch_stats`` tree."""
    return tree((flax_path(n), to_flax(flax_path(n), t)) for n, t in _named(module, True))


@torch.no_grad()
def load_flax_params(module: nn.Module, params: dict, batch_stats: dict | None = None):
    """Copy a flax ``params`` tree (and ``batch_stats``, for BatchNorm) into
    ``module``, in place; every parameter must be in the tree, with its
    shape.  Returns ``module``."""
    for buffers, tree_ in ((False, params), (True, batch_stats)):
        if tree_ is None:
            continue
        for name, t in _named(module, buffers):
            path = flax_path(name)
            node = tree_
            for key in path:
                node = node[key]
            a = from_flax(path, node)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape {a.shape} does not "
                                 f"fit {tuple(t.shape)}")
            t.copy_(torch.from_numpy(a))
    return module
