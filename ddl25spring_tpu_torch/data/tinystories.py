"""TinyStories-style token stream.

The reference streams TinyStories through simplellm's loader:
``TinyStories(tokenizer, batch_size, seq_l, skip=rank*3000)`` yielding
``(B, L)`` token batches, with ``skip`` used to give DP ranks disjoint data
(``lab/tutorial_1b/DP/gradient_aggr/intro_DP_GA.py:29``).  This build keeps
that iterator contract.  Sources, in order:

1. a local text corpus (``DDL25_TINYSTORIES_TXT`` env var, or
   ``data/tinystories.txt``) — one story per ``<|endoftext|>``-separated
   block, as in the public dataset dump;
2. an offline deterministic story generator (template grammar over small
   word lists) — statistically simple enough that a small LLaMA's loss
   visibly falls, which is all the reference's convergence-by-eyeball
   verification observes (``out<rank>.txt`` prints, SURVEY §4).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_NAMES = ["Tom", "Lily", "Max", "Anna", "Ben", "Mia", "Sam", "Zoe"]
_ANIMALS = ["cat", "dog", "bird", "fox", "frog", "mouse", "bear", "duck"]
_OBJECTS = ["ball", "box", "kite", "cake", "hat", "boat", "drum", "book"]
_PLACES = ["park", "house", "garden", "forest", "beach", "school"]
_VERBS = ["found", "liked", "saw", "took", "made", "lost", "shared", "hid"]
_ADJ = ["red", "big", "small", "shiny", "soft", "funny", "old", "new"]


def generate_story(rng: np.random.Generator) -> str:
    n, a = rng.choice(_NAMES), rng.choice(_ANIMALS)
    o, p = rng.choice(_OBJECTS), rng.choice(_PLACES)
    v, adj = rng.choice(_VERBS), rng.choice(_ADJ)
    v2, o2 = rng.choice(_VERBS), rng.choice(_OBJECTS)
    return (
        f"One day {n} went to the {p}. {n} {v} a {adj} {o}. "
        f"A {a} came to play. The {a} {v2} the {o2}. "
        f"{n} and the {a} were happy. They played all day. The end."
    )


def _load_corpus(seed: int, min_chars: int) -> list[str]:
    for cand in (os.environ.get("DDL25_TINYSTORIES_TXT"), "data/tinystories.txt"):
        if cand and Path(cand).exists():
            text = Path(cand).read_text(errors="replace")
            stories = [s.strip() for s in text.split("<|endoftext|>") if s.strip()]
            if stories:
                return stories
    rng = np.random.default_rng(seed)
    stories, total = [], 0
    while total < min_chars:
        s = generate_story(rng)
        stories.append(s)
        total += len(s)
    return stories


class TinyStories:
    """Iterator over ``(batch_size, seq_l)`` int32 token batches.

    API parity with simplellm's loader: ``TinyStories(tokenizer, batch_size,
    seq_l, skip=...)``; ``skip`` drops that many *samples* from the head of
    the stream so DP replicas draw disjoint data.
    """

    def __init__(
        self,
        tokenizer,
        batch_size: int = 3,
        seq_l: int = 256,
        skip: int = 0,
        seed: int = 0,
        min_chars: int = 2_000_000,
    ):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_l = seq_l
        self.skip = skip
        stories = _load_corpus(seed, min_chars)
        ids: list[int] = []
        for s in stories:
            ids.extend(tokenizer.encode(s))
            ids.append(tokenizer.eos_id)
        self._stream = np.asarray(ids, dtype=np.int32)

    def __iter__(self):
        tok_per_sample = self.seq_l
        n_samples = len(self._stream) // tok_per_sample
        if n_samples < 1:
            raise ValueError(
                f"corpus too small: {len(self._stream)} tokens < seq_l={self.seq_l}"
            )
        i = self.skip
        while True:
            # modular indexing: always a full batch, any skip value valid
            # (infinite wrap-around stream, like the reference's)
            idx = np.arange(i, i + self.batch_size) % n_samples
            batch = np.stack(
                [
                    self._stream[j * tok_per_sample : (j + 1) * tok_per_sample]
                    for j in idx
                ]
            )
            i = (i + self.batch_size) % n_samples
            yield batch
