"""The heart-disease MLP: the counterpart of the JAX package's
``models/heart_mlp.py`` (``HeartDiseaseNN``,
``lab/tutorial_2a/centralized.py:13-28``): 30 -> 64 -> 128 -> 256 -> 2 with
ReLU between layers and raw logits out.  It is the evaluator of the TSTR
harness (:func:`~ddl25spring_tpu_torch.fl.generative.train_evaluator`).

Layers carry flax's names (``Dense_0`` .. ``Dense_3``), so
:mod:`~ddl25spring_tpu_torch.models.flax_bridge` moves its weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.models.layers import dense


class HeartDiseaseNN(nn.Module):
    def __init__(self, d_in: int = 30, hidden: tuple[int, ...] = (64, 128, 256),
                 num_classes: int = 2, *, generator: torch.Generator):
        super().__init__()
        widths = (d_in, *hidden, num_classes)
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"Dense_{i}", dense(a, b, generator))
        self.n_layers = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_layers - 1}")(x)
