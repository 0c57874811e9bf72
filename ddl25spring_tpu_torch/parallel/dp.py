"""Training steps, the counterpart of the JAX package's ``parallel/dp.py``.

Only the single-device step is ported so far; data parallelism follows in a
later slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

# loss_fn(model, batch) -> scalar tensor
LossFn = Callable[[nn.Module, Any], torch.Tensor]


def make_train_step(model: nn.Module, loss_fn: LossFn, optimizer: torch.optim.Optimizer):
    """Single-device train step (parity: the centralized loop of
    ``lab/tutorial_1b/primer/intro.py:23-33``): forward, loss, ``backward()``,
    optimizer step.  ``step(batch)`` updates ``model`` in place and returns the
    loss, detached."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
