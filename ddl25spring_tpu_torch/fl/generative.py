"""Generative FL on PyTorch: the tabular VAE and TSTR, the counterpart of
the JAX package's ``fl/generative.py``.

Capability parity with ``lab/tutorial_2a/generative-modeling.py``:

- :class:`TabularVAE`: the reference's ``Autoencoder`` (``:14-115``):
  BN+ReLU dense stacks D -> H -> H2 -> H2 -> latent, latent mu/logvar
  heads, a mirrored decoder with a final BatchNorm and no activation; the
  reparameterisation in training;
- ``vae_loss`` (in :mod:`~ddl25spring_tpu_torch.ops.losses`): summed MSE +
  KLD (``customLoss``, ``:118-127``);
- :meth:`TabularVAE.sample`: draws z from N(mu-bar, sigma-bar) aggregated
  over the train set, decodes, clips and rounds the label column
  (``:105-115``);
- :func:`tstr`: Train-on-Synthetic-Test-on-Real: fit one evaluator on real
  and one on synthetic data, compare their real-test accuracy
  (``:164-208``).

BatchNorm is flax's (:class:`~ddl25spring_tpu_torch.models.layers.BatchNorm`:
momentum 0.9 keeps 0.9, the running variance takes the biased batch
variance), not torch's ``BatchNorm1d``.  The reparameterisation noise
``eps`` comes from the trainer's generator, or from the caller.  The
evaluator's AdamW decays weights by optax's 1e-4, not torch's 1e-2.  The
optimizers are fused (one kernel per update): these small steps are bound
by the host.
Submodules carry flax's names (``encoder.Dense_0``, ``decoder.BatchNorm_4``,
...) for :mod:`~ddl25spring_tpu_torch.models.flax_bridge`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.models.heart_mlp import HeartDiseaseNN
from ddl25spring_tpu_torch.models.layers import BatchNorm, dense
from ddl25spring_tpu_torch.ops.losses import cross_entropy_logits, vae_loss
from ddl25spring_tpu_torch.utils.device import resolve_device
from ddl25spring_tpu_torch.utils.prng import seeded_generator

WEIGHT_DECAY = 1e-4  # optax.adamw's default


class _Stack(nn.Module):
    """``Dense_i -> BatchNorm_i -> relu`` for each of ``widths``, from ``d_in``."""

    def __init__(self, d_in: int, widths, generator: torch.Generator):
        super().__init__()
        self.depth = len(widths)
        for i, w in enumerate(widths):
            self.add_module(f"Dense_{i}", dense(d_in, w, generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(w))
            d_in = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return x


class Encoder(_Stack):
    def __init__(self, d_in: int, h: int, h2: int, latent: int, *, generator: torch.Generator):
        super().__init__(d_in, (h, h2, h2, latent), generator)
        self.Dense_4 = dense(latent, latent, generator)  # mu
        self.Dense_5 = dense(latent, latent, generator)  # logvar

    def forward(self, x: torch.Tensor):
        x = super().forward(x)
        return self.Dense_4(x), self.Dense_5(x)


class Decoder(_Stack):
    def __init__(self, d_out: int, h: int, h2: int, latent: int, *,
                 generator: torch.Generator):
        super().__init__(latent, (latent, h2, h2, h), generator)
        self.Dense_4 = dense(h, d_out, generator)
        # final BatchNorm, no activation (lin_bn6, generative-modeling.py:76)
        self.BatchNorm_4 = BatchNorm(d_out)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_4(self.Dense_4(super().forward(z)))


class VaeModule(nn.Module):
    """The VAE.  In training mode (``module.train()``: batch statistics, the
    running ones updated) ``forward(x, eps)`` samples ``z = mu + eps *
    exp(logvar / 2)``; in evaluation mode ``z = mu``."""

    def __init__(self, d_in: int, h: int = 48, h2: int = 32, latent: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        self.latent = latent
        self.encoder = Encoder(d_in, h, h2, latent, generator=generator)
        self.decoder = Decoder(d_in, h, h2, latent, generator=generator)

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None):
        mu, logvar = self.encoder(x)
        if self.training:
            z = mu + eps * torch.exp(0.5 * logvar)
        else:
            z = mu
        return self.decoder(z), mu, logvar


class TabularVAE:
    """Trainer wrapper (parity: ``Autoencoder.train_with_settings`` +
    ``sample``).  Reference defaults: H=48, H2=32, latent=16, Adam 1e-3,
    200 epochs, batch 64 (``generative-modeling.py:147-156``).  Weights and
    the noise come from ``seed``; ``device`` follows
    :func:`~ddl25spring_tpu_torch.utils.device.resolve_device`."""

    def __init__(self, d_in: int, h: int = 48, h2: int = 32, latent: int = 16,
                 lr: float = 1e-3, seed: int = 42, *, device=None):
        self.device = resolve_device(device)
        self.seed = seed
        self.module = VaeModule(d_in, h, h2, latent,
                                generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.gen = seeded_generator(seed, device=self.device)
        self.opt = torch.optim.Adam(self.module.parameters(), lr=lr, fused=True)

    def step(self, x: torch.Tensor, eps: torch.Tensor | None = None) -> torch.Tensor:
        """One Adam step on the batch ``x`` with noise ``eps`` (drawn from
        the trainer's generator when None); returns the loss (detached)."""
        if eps is None:
            eps = torch.randn(len(x), self.module.latent, generator=self.gen,
                              device=self.device)
        self.module.train()
        recon, mu, logvar = self.module(x, eps)
        loss = vae_loss(recon, x, mu, logvar)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_with_settings(self, epochs: int, batch_size: int, data: np.ndarray,
                            verbose: bool = False) -> list[float]:
        xd = torch.tensor(data, dtype=torch.float32, device=self.device)
        n, losses = len(xd), []
        for e in range(epochs):
            total = torch.zeros((), device=self.device)
            for lo in range(0, n, batch_size):
                total += self.step(xd[lo:lo + batch_size])
            losses.append(float(total) / -(-n // batch_size))
            if verbose:
                print(f"epoch {e}: loss {losses[-1]:.3f}")
        return losses

    @torch.no_grad()
    def encode_stats(self, data: np.ndarray):
        self.module.eval()
        _, mu, logvar = self.module(torch.tensor(data, dtype=torch.float32,
                                                 device=self.device))
        return mu, logvar

    @torch.no_grad()
    def sample(self, nr_samples: int, mu, logvar, generator=None) -> np.ndarray:
        """Synthesize rows; the last column is the label, clipped and
        rounded (``generative-modeling.py:105-115``)."""
        if generator is None:
            generator = seeded_generator(self.seed, 7, device=self.device)
        sigma = torch.exp(logvar / 2)
        z = mu.mean(0) + sigma.mean(0) * torch.randn(
            nr_samples, mu.shape[-1], generator=generator, device=generator.device
        ).to(self.device)
        self.module.eval()
        pred = self.module.decoder(z).cpu().numpy().copy()
        pred[:, -1] = np.clip(pred[:, -1], 0, 1).round()
        return pred


def train_evaluator(x_train, y_train, x_test, y_test, epochs: int = 49, lr: float = 1e-3,
                    seed: int = 0, *, device=None) -> float:
    """Full-batch AdamW evaluator training, returns final real-test accuracy
    (the reference's 49-epoch EvaluatorModel loops,
    ``generative-modeling.py:171-208``)."""
    dev = resolve_device(device)
    x = torch.tensor(x_train, dtype=torch.float32, device=dev)
    y = torch.tensor(y_train, dtype=torch.long, device=dev)
    model = HeartDiseaseNN(x.shape[1], generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=WEIGHT_DECAY, fused=True)
    for _ in range(epochs):
        loss = cross_entropy_logits(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        logits = model(torch.tensor(x_test, dtype=torch.float32, device=dev))
        want = torch.tensor(y_test, dtype=torch.long, device=dev)
        return float((logits.argmax(-1) == want).float().mean())


def tstr(vae: TabularVAE, x_train, y_train, x_test, y_test, seed: int = 0) -> dict[str, float]:
    """Train-on-Synthetic-Test-on-Real comparison
    (``generative-modeling.py:150-208``), on the VAE's device."""
    real = np.concatenate([x_train, y_train[:, None].astype(np.float32)], axis=1)
    mu, logvar = vae.encode_stats(real)
    synth = vae.sample(len(real), mu, logvar)
    acc_real = train_evaluator(x_train, y_train, x_test, y_test, seed=seed, device=vae.device)
    acc_synth = train_evaluator(synth[:, :-1], synth[:, -1].astype(np.int32), x_test, y_test,
                                seed=seed, device=vae.device)
    return {"real": acc_real, "synthetic": acc_synth}
