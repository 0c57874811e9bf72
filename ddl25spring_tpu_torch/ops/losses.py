"""Loss functions, the counterparts of the JAX package's ``ops/losses.py``.

All are computed in float32 whatever the activation dtype: a softmax or
log-sum-exp in bf16 loses too much precision.
"""

from __future__ import annotations

import torch


def _pick(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return values.gather(-1, labels.long()[..., None])[..., 0]


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of integer labels under log-probs."""
    return -_pick(log_probs.float(), labels).mean()


def masked_nll_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    denom: torch.Tensor | None = None,
) -> torch.Tensor:
    """NLL over the rows where ``mask`` is 1, averaged over ``denom``
    (default: the number of unmasked rows, floored at 1 so an all-pad batch
    yields a zero constant -> zero gradient)."""
    picked = _pick(log_probs.float(), labels)
    mask = mask.float()
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return -(picked * mask).sum() / denom


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy from raw logits (``nn.CrossEntropyLoss``)."""
    logits = logits.float()
    return (torch.logsumexp(logits, -1) - _pick(logits, labels)).mean()


def causal_lm_loss(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    pad_id: int | None = None,
) -> torch.Tensor:
    """Next-token cross-entropy: logits at position t predict token t+1.

    Args:
      logits: ``[B, L, V]``.
      tokens: ``[B, L]`` input token ids (targets derived by shifting).
      pad_id: optional id masked out of the loss.
    """
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    per_tok = torch.logsumexp(logits, -1) - _pick(logits, targets)
    if pad_id is not None:
        mask = (targets != pad_id).float()
        return (per_tok * mask).sum() / mask.sum().clamp_min(1.0)
    return per_tok.mean()


def accuracy(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy from logits or log-probs."""
    return (outputs.argmax(-1) == labels).float().mean()


def vae_loss(
    recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor
) -> torch.Tensor:
    """Summed reconstruction MSE + KL divergence."""
    mse = ((recon.float() - x.float()) ** 2).sum()
    kld = -0.5 * (1.0 + logvar - mu**2 - logvar.exp()).sum()
    return mse + kld
