"""Explicit randomness: the counterpart of the JAX package's ``utils/prng.py``
(``client_round_key``).

The reference seeds each client's update with the arithmetic
``seed + ind + 1 + round * clients_per_round``
(``lab/tutorial_1a/hfl_complete.py:289``), which collides across rounds; the
JAX package folds the round and the client into a typed key.  The port's
form is an explicit ``torch.Generator`` per stream, seeded from
``np.random.SeedSequence`` over the stream's integers (``[seed, round,
client]`` for a client's update), whose hash keeps distinct tuples apart.
No code here touches torch's global generator.
"""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(*entropy: int, device="cpu") -> torch.Generator:
    """A new ``torch.Generator`` on ``device`` seeded with the 64-bit state of
    ``np.random.SeedSequence(entropy)``: one stream per tuple of integers."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]))
    return g


def client_round_generator(seed: int, round_idx: int, client_idx: int,
                           device="cpu") -> torch.Generator:
    """The generator of client ``client_idx``'s update in round
    ``round_idx``: its row orders and dropout masks for the round."""
    return seeded_generator(seed, round_idx, client_idx, device=device)
