"""The MNIST CNN of the federated-learning tutorials: the counterpart of the
JAX package's ``models/mnist_cnn.py`` (the reference's ``MnistCnn``,
``lab/tutorial_1a/hfl_complete.py:39-64``).

conv(1->32, 3x3) -> relu -> conv(32->64, 3x3) -> relu -> maxpool 2 ->
dropout(0.25) -> flatten -> fc(9216, 128) -> relu -> dropout(0.5) ->
fc(128, 10) -> log_softmax.

The input is the JAX package's NHWC ``[B, 28, 28, 1]``; with one channel
that is the same bytes as NCHW ``[B, 1, 28, 28]``, so it is a view.  The
convolutions run in NCHW (cuDNN on the card).

Dropout takes its keep-masks from the caller (:meth:`MnistCnn.dropout_masks`
draws them from a generator the caller owns): ``forward(x)`` is evaluation,
``forward(x, masks)`` training.  Under ``torch.func.vmap`` over federated
clients each client's masks come stacked with its data, and nothing inside
the model draws.

Flatten-order trap: flax flattens the pooled ``[B, 12, 12, 64]`` in HWC
order, torch's NCHW ``[B, 64, 12, 12]`` in CHW order, so the 9216 input rows
of ``Dense_0``'s flax kernel are permuted by :func:`load_flax_params` and
back by :func:`export_params` (and :func:`export_grads`); the other leaves
take the plain layout changes of :mod:`~ddl25spring_tpu_torch.models.flax_bridge`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.models import flax_bridge
from ddl25spring_tpu_torch.models.layers import conv, dense, dropout, keep_mask

POOLED = (64, 12, 12)  # C, H, W after the pool
RATES = (0.25, 0.5)    # dropout after the pool, after Dense_0


class MnistCnn(nn.Module):
    def __init__(self, num_classes: int = 10, *, generator: torch.Generator):
        super().__init__()
        self.Conv_0 = conv(1, 32, 3, generator)
        self.Conv_1 = conv(32, 64, 3, generator)
        self.Dense_0 = dense(int(np.prod(POOLED)), 128, generator)
        self.Dense_1 = dense(128, num_classes, generator)

    def dropout_masks(self, rows: int, generator: torch.Generator) -> tuple:
        """The keep-masks of one training batch of ``rows`` rows, drawn from
        ``generator`` on its device: ``[rows, 64, 12, 12]`` and ``[rows, 128]``."""
        return (keep_mask((rows, *POOLED), RATES[0], generator),
                keep_mask((rows, self.Dense_0.out_features), RATES[1], generator))

    def forward(self, x: torch.Tensor, masks: tuple | None = None) -> torch.Tensor:
        m0, m1 = masks if masks is not None else (None, None)
        x = x.reshape(x.shape[0], 1, 28, 28)
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = dropout(F.max_pool2d(x, 2), m0, RATES[0])
        x = F.relu(self.Dense_0(x.flatten(1)))
        x = dropout(x, m1, RATES[1])
        return F.log_softmax(self.Dense_1(x), dim=-1)


def _rows(kernel: np.ndarray, src, dst) -> np.ndarray:
    """``Dense_0``'s ``[9216, out]`` flax-layout kernel with its rows taken
    from ``src`` order (``"hwc"`` or ``"chw"``) to ``dst`` order."""
    C, H, W = POOLED
    dims = {"chw": (C, H, W), "hwc": (H, W, C)}[src]
    axes = [src.index(d) for d in dst]
    out = kernel.reshape(*dims, -1).transpose(*axes, 3).reshape(kernel.shape)
    return np.ascontiguousarray(out)


def _to_flax_tree(tree: dict) -> dict:
    tree["Dense_0"]["kernel"] = _rows(tree["Dense_0"]["kernel"], "chw", "hwc")
    return tree


def export_params(src) -> dict:
    """The flax ``params`` tree of a :class:`MnistCnn` (or of its
    name -> tensor mapping), ``Dense_0``'s rows in flax's HWC order."""
    return _to_flax_tree(flax_bridge.export_params(src))


def export_grads(module: MnistCnn) -> dict:
    """The gradients as :func:`export_params` lays out the parameters."""
    return _to_flax_tree(flax_bridge.export_grads(module))


def load_flax_params(module: MnistCnn, params: dict) -> MnistCnn:
    """Copy a flax ``MnistCnn`` params tree into ``module`` in place, with
    ``Dense_0``'s rows moved from HWC to CHW order.  Returns ``module``."""
    d0 = params["Dense_0"]
    moved = {**params, "Dense_0": {**d0, "kernel": _rows(np.asarray(d0["kernel"]), "hwc", "chw")}}
    return flax_bridge.load_flax_params(module, moved)
