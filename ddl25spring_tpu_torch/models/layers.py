"""flax's layer defaults, in torch: the pieces the port's models share.

- :func:`lecun_normal`: flax's default kernel initialiser (a normal truncated
  at 2 std, rescaled so that the std is ``sqrt(1 / fan_in)``), drawn from an
  explicit ``torch.Generator``; :func:`dense` and :func:`conv` are flax's
  ``nn.Dense`` and ``nn.Conv(padding="VALID")`` with it and zero biases.
- :class:`BatchNorm`: flax's ``nn.BatchNorm(momentum=0.9)``, whose two
  defaults torch's ``BatchNorm1d``/``BatchNorm2d`` do not share.
- :func:`keep_mask` and :func:`dropout`: flax's ``nn.Dropout`` with the mask
  made by the caller, from a generator the caller owns, so that a model run
  under ``torch.func.vmap`` draws nothing itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: truncated at 2 std, rescaled so the std is sqrt(1/fan_in)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return nn.Parameter(w)


@torch.no_grad()
def dense(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense(cout)`` on ``cin`` features: the kernel is drawn in
    flax's ``[in, out]`` shape and stored transposed."""
    layer = nn.Linear(cin, cout)
    layer.weight.copy_(lecun_normal((cin, cout), cin, generator).T)
    layer.bias.zero_()
    return layer


@torch.no_grad()
def conv(cin: int, cout: int, k: int, generator: torch.Generator) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (k, k), padding="VALID")`` with a bias."""
    layer = nn.Conv2d(cin, cout, k)
    layer.weight.copy_(lecun_normal((cout, cin, k, k), cin * k * k, generator))
    layer.bias.zero_()
    return layer


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over every dimension but the
    channels (dimension 1): batch statistics in training, running ones
    otherwise.  flax's momentum 0.9 keeps 0.9 of the running statistics per
    step (torch's ``momentum=0.1``), and its running variance takes the
    *biased* batch variance, where torch's batch norms take the unbiased
    one.  Computes in float32, returns the input's dtype."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.to(x.dtype)
        # normalise by the biased batch variance (torch's batch norm does, in
        # training); no running statistics are passed, since torch's would
        # take the unbiased variance: they are updated here instead.  The
        # aten op, not F.batch_norm, which refuses a one-row batch that flax
        # takes (the last batch of an epoch can be one row)
        y = torch.batch_norm(xf, self.weight, self.bias, None, None, True, 0.0, self.eps,
                             False)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, *range(2, x.ndim)), correction=0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y.to(x.dtype)


def keep_mask(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """A boolean keep-mask for dropout at ``rate``, drawn from ``generator``
    on its device: each element kept with probability ``1 - rate``."""
    return torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: ``x / (1 - rate)`` where ``keep``, else 0;
    ``keep`` None is evaluation (``x`` unchanged)."""
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)
