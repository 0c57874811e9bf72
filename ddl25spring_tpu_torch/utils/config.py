"""Config dataclasses and the ``DDL25_*`` environment readers.

The same dataclasses as the JAX package's ``utils/config.py``, field for field,
so one configuration means the same model in both packages.  ``dtype`` names a
torch dtype (``"bfloat16"``, ``"float32"``); parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class LlamaConfig:
    """Reference workload constants: ``lab/s01_b1_microbatches.py:21-26``."""

    vocab_size: int = 4096
    dmodel: int = 288
    num_heads: int = 6
    n_layers: int = 6
    ctx_size: int = 256
    pad_id: int = 0
    dtype: str = "bfloat16"     # compute dtype; params stay float32
    use_flash: bool = False     # flash-attention kernels for the attention op
    n_experts: int = 0          # > 0: switch-MoE FFN in every block
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01  # load-balance aux loss weight
    moe_top_k: int = 1          # experts/token: 1 = switch, 2 = Mixtral-style

    @property
    def head_dim(self) -> int:
        return self.dmodel // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.dmodel


@dataclass(frozen=True)
class PipelineConfig:
    """Reference: 3 stages x 3 microbatches, batch 3, Adam lr=8e-4
    (``lab/s01_b1_microbatches.py:24-26,64,66``; ``lab/run-b1.sh``)."""

    num_stages: int = 3
    num_microbatches: int = 3
    batch_size: int = 3
    learning_rate: float = 8e-4


@dataclass(frozen=True)
class DpPpConfig:
    """Reference: 2 pipelines x 3 stages, world 6
    (``lab/s01_b2_dp_pp.py:22-34``)."""

    data: int = 2
    num_stages: int = 3
    num_microbatches: int = 3
    per_replica_batch: int = 3
    learning_rate: float = 8e-4


@dataclass(frozen=True)
class FlConfig:
    """Tutorial defaults: lr=0.01, E=1, B=100, 10 rounds, seed=10
    (``lab/homework-1.ipynb`` cell 5; BASELINE.md)."""

    nr_clients: int = 10
    client_fraction: float = 0.1
    batch_size: int = 100      # -1 = full batch (FedSGD)
    nr_local_epochs: int = 1
    learning_rate: float = 0.01
    nr_rounds: int = 10
    iid: bool = True
    seed: int = 10


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def env_flag(name: str, default: bool = False) -> bool:
    """Read a boolean ``DDL25_*`` switch: every runtime toggle of the package
    goes through these readers, so each env-dependent default is greppable in
    one place.  Unset -> ``default``; ``""``/``"0"``/``"false"`` -> False;
    anything else -> True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw not in ("", "0", "false")


def env_choice(name: str, choices: tuple[str, ...], default: str) -> str:
    """Read an enumerated ``DDL25_*`` setting.  Unset/empty -> ``default``; a
    value outside ``choices`` raises: a typo'd policy must not silently fall
    back to the default."""
    raw = os.environ.get(name)
    if not raw:
        return default
    if raw not in choices:
        raise ValueError(f"{name}={raw!r} is not one of {sorted(choices)}")
    return raw


def env_str(name: str, default: str | None = None) -> str | None:
    """Read a free-form string ``DDL25_*`` setting.  Unset/empty -> ``default``."""
    raw = os.environ.get(name)
    return raw if raw else default


def env_float(name: str, default: float) -> float:
    """Read a float ``DDL25_*`` setting.  Unset/empty -> ``default``."""
    raw = os.environ.get(name)
    if not raw:
        return default
    return float(raw)


def env_int(name: str, default: int) -> int:
    """Read an integer ``DDL25_*`` setting.  Unset/empty -> ``default``; a
    non-integer value raises."""
    raw = os.environ.get(name)
    if not raw:
        return default
    return int(raw)
