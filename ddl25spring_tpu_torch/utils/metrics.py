"""Experiment metrics.

Re-creation of the reference's ``RunResult`` harness
(``lab/tutorial_1a/hfl_complete.py:113-138``): per-round wall time
(componentized, modelling parallel clients by taking the max over client
update times — ``hfl_complete.py:294``), message counts
(``2*(round+1)*clients_per_round`` — ``hfl_complete.py:309,387``), and test
accuracy, exportable as a DataFrame with the reference's display conventions
(B == -1 rendered as infinity, lr column titled with a lowercase eta —
``hfl_complete.py:126-138``).  Extended with throughput counters
(samples/sec/chip) for the BASELINE metric.

The PyTorch port's copy of the JAX package's ``utils/metrics.py`` (standard
library only; :meth:`RunResult.as_df` imports pandas when it is called).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field

ETA = "\N{GREEK SMALL LETTER ETA}"


def fmt_bytes(b: float | None) -> str:
    """Human bytes (1.5 KiB / 44.7 MiB) — the one formatter the report
    tables and hazard findings share."""
    if b is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024
    return f"{b:.1f} GiB"
INF = "\N{INFINITY}"


@dataclass
class RunResult:
    algorithm: str
    n: int                # number of clients
    c: float              # client fraction
    b: int                # batch size; -1 means full-batch (rendered as inf)
    e: int                # local epochs
    lr: float             # displayed under an eta header
    wall_time: list[float] = field(default_factory=list)
    message_count: list[int] = field(default_factory=list)
    test_accuracy: list[float] = field(default_factory=list)
    samples_per_sec_per_chip: list[float] = field(default_factory=list)

    def as_df(self, skip_wall_time: bool = True):
        """Pandas export matching ``hfl_complete.py:126-138``: one row per
        round, hyperparameters repeated, wall time dropped by default."""
        import pandas as pd  # heavy import, keep local

        d = asdict(self)
        rounds = len(self.test_accuracy)

        def pad(xs, fill):
            xs = list(xs[:rounds])
            return xs + [fill] * (rounds - len(xs))

        df = pd.DataFrame(
            {
                "Algorithm": [self.algorithm] * rounds,
                "N": [self.n] * rounds,
                "C": [self.c] * rounds,
                "B": [INF if self.b == -1 else self.b] * rounds,
                "E": [self.e] * rounds,
                ETA: [self.lr] * rounds,
                "Round": list(range(1, rounds + 1)),
                "Message count": pad(d["message_count"], 0),
                "Test accuracy": d["test_accuracy"],
            }
        )
        if not skip_wall_time:
            df["Wall time"] = pad(d["wall_time"], 0.0)
        return df


class Timer:
    """Componentized ``perf_counter`` accounting (reference pattern:
    setup/update/aggregate segments summed into a per-round wall time,
    ``hfl_complete.py:274-307``)."""

    def __init__(self) -> None:
        self.segments: dict[str, float] = {}

    @contextmanager
    def segment(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.segments[name] = self.segments.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def add(self, name: str, seconds: float) -> None:
        self.segments[name] = self.segments.get(name, 0.0) + seconds

    def total(self) -> float:
        return sum(self.segments.values())


def fedavg_message_count(round_idx: int, clients_per_round: int) -> int:
    """The reference's message-count model: one down + one up per chosen
    client per round, cumulative (``hfl_complete.py:309,387``)."""
    return 2 * (round_idx + 1) * clients_per_round
