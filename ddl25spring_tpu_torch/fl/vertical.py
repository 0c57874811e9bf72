"""Vertical federated learning (split-NN) on PyTorch: the counterpart of the
JAX package's ``fl/vertical.py``.

Capability parity with ``lab/tutorial_2b/vfl.py``: K parties each own a
disjoint **feature** slice; each runs a :class:`BottomModel`
(Linear -> ReLU -> Linear -> ReLU -> Dropout, ``vfl.py:11-22``); the
server's :class:`TopModel` concatenates the party activations and classifies
(128 -> 256 -> 2 with LeakyReLU, ``vfl.py:25-40``); one joint AdamW over all
parties' parameters (``vfl.py:50``), so gradients cross the party boundary
through the concatenation: the cut layer.

The cut layer stays explicit as the list of per-party activations
(:meth:`VFLNetwork.forward`).  The logits come out raw, as in the JAX
package: the reference's LeakyReLU and Dropout on its final logits
(``vfl.py:38-40``) are not copied.

Two defaults differ between the packages and are matched: ``optax.adamw``
decays weights by 1e-4, torch's ``AdamW`` by 1e-2, so the optimizer is given
1e-4; LeakyReLU's slope is 0.01 in both.  Dropout masks come from the
network's own generator (seeded from ``seed``), drawn outside the modules.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.models.layers import dense, dropout, keep_mask
from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.prng import seeded_generator

RATE = 0.1            # dropout in the bottoms and the top (vfl.py:22, :37)
WEIGHT_DECAY = 1e-4   # optax.adamw's default


class BottomModel(nn.Module):
    def __init__(self, d_in: int, out_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.out_dim = out_dim
        self.Dense_0 = dense(d_in, out_dim, generator)
        self.Dense_1 = dense(out_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return dropout(x, keep, RATE)


class TopModel(nn.Module):
    def __init__(self, d_in: int, n_outs: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.Dense_0 = dense(d_in, 128, generator)
        self.Dense_1 = dense(128, 256, generator)
        self.Dense_2 = dense(256, n_outs, generator)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        x = F.leaky_relu(self.Dense_0(x), 0.01)
        x = F.leaky_relu(self.Dense_1(x), 0.01)
        return self.Dense_2(dropout(x, keep, RATE))


class VFLNetwork:
    """Joint split-network trainer (parity: ``VFLNetwork``, ``vfl.py:43-102``).

    ``feature_indices``: per-party encoded-column index arrays (from
    ``data.heart.partition_features``).  ``outs_per_feature=2`` mirrors the
    reference's ``outs_per_client * len(in_feats)`` bottom widths
    (``vfl.py:148``).  Weights are drawn from ``seed``; ``device`` follows
    :func:`~ddl25spring_tpu_torch.utils.device.resolve_device`.
    """

    def __init__(self, feature_indices: list[np.ndarray], n_outs: int = 2,
                 outs_per_feature: int = 2, lr: float = 1e-3, seed: int = 42, *,
                 device=None):
        self.device = resolve_device(device)
        self.feature_indices = [torch.as_tensor(np.asarray(f), device=self.device)
                                for f in feature_indices]
        self.n_parties = len(feature_indices)
        init = torch.Generator().manual_seed(seed)
        self.bottoms = [BottomModel(len(f), outs_per_feature * len(f), generator=init)
                        .to(self.device) for f in self.feature_indices]
        self.top = TopModel(sum(m.out_dim for m in self.bottoms), n_outs,
                            generator=init).to(self.device)
        self.gen = seeded_generator(seed, device=self.device)
        # the reference uses torch's AdamW (vfl.py:50); the JAX package
        # optax.adamw, whose weight decay is the one kept here.  Fused: one
        # kernel per update, since these small steps are bound by the host
        params = [p for m in (*self.bottoms, self.top) for p in m.parameters()]
        self.opt = torch.optim.AdamW(params, lr=lr, weight_decay=WEIGHT_DECAY, fused=True)

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Each party's columns of the encoded rows ``x``."""
        return [x.index_select(1, f) for f in self.feature_indices]

    def draw_masks(self, rows: int) -> list[torch.Tensor]:
        """Dropout keep-masks for a batch of ``rows``: each bottom's, then the
        top's."""
        shapes = [(rows, m.out_dim) for m in self.bottoms]
        shapes.append((rows, self.top.Dense_1.out_features))
        return [keep_mask(s, RATE, self.gen) for s in shapes]

    def forward(self, xs: list[torch.Tensor], masks: list | None = None) -> torch.Tensor:
        """Logits from the parties' slices ``xs``; ``masks`` None is
        evaluation (no dropout)."""
        keep = masks if masks is not None else [None] * (self.n_parties + 1)
        # the CUT LAYER: per-party activations, then the concat (vfl.py:36)
        acts = [m(x, k) for m, x, k in zip(self.bottoms, xs, keep)]
        return self.top(torch.cat(acts, dim=1), keep[-1])

    def step(self, xs: list[torch.Tensor], y: torch.Tensor, masks: list | None) -> torch.Tensor:
        """One joint AdamW step on a batch; returns the loss (detached)."""
        loss = cross_entropy_logits(self.forward(xs, masks), y)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_with_settings(self, epochs: int, batch_size: int, x: np.ndarray, y: np.ndarray,
                            verbose: bool = False) -> list[float]:
        """Minibatch joint training (parity: ``train_with_settings``,
        ``vfl.py:53-85``; per-batch optimizer step, dropout on); returns each
        epoch's mean loss."""
        xd = torch.tensor(x, dtype=torch.float32, device=self.device)
        yd = torch.tensor(y, dtype=torch.long, device=self.device)
        n, losses = len(xd), []
        for e in range(epochs):
            total = torch.zeros((), device=self.device)
            for lo in range(0, n, batch_size):
                xb = xd[lo:lo + batch_size]
                total += self.step(self.split(xb), yd[lo:lo + batch_size],
                                   self.draw_masks(len(xb)))
            losses.append(float(total) / -(-n // batch_size))
            if verbose:
                print(f"epoch {e}: loss {losses[-1]:.4f}")
        return losses

    @torch.no_grad()
    def test(self, x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
        """Accuracy and mean loss on held-out data (``vfl.py:91-102``)."""
        xd = torch.tensor(x, dtype=torch.float32, device=self.device)
        yd = torch.tensor(y, dtype=torch.long, device=self.device)
        logits = self.forward(self.split(xd))
        loss = float(cross_entropy_logits(logits, yd))
        acc = float((logits.argmax(-1) == yd).float().mean())
        return acc, loss
