"""Seeded synthetic open-loop serving workload: a copy of the JAX package's
``serve/traffic.py``, code line for line, so one seed gives the identical
trace (byte for byte) in both packages.

Serving benchmarks need *open-loop* arrivals (requests land on their own
clock whether or not the engine kept up — the regime where admission
control and tail latency actually mean something), reproducibly: two
runs of ``bench.py --serve`` on the same seed must replay the identical
trace, or the continuous-vs-static A/B and the cross-run ledger trend
compare different workloads.

- **Poisson arrivals** with a time-varying rate: inter-arrival gaps are
  drawn by thinning a homogeneous process at the profile's peak rate
  (the standard non-homogeneous Poisson recipe), so any ramp profile
  stays a true Poisson process at every instant.
- **Ramp profiles**: ``flat`` (constant), ``ramp`` (linear 0.1x -> 1x —
  the warm-up shape the CI smoke drives), ``spike`` (1/3 at 0.3x, 1/3
  at 1x, 1/3 at 0.3x — the overload shape that exercises queue
  backpressure and rejections), ``shared`` (flat rate; the prefix-cache
  workload below).
- **Length mixes**: a categorical over ``(prompt_len, max_new)`` pairs
  (chat-style short-in/long-out next to retrieval-style long-in/
  short-out), prompt token ids drawn uniformly from ``[1, vocab)``
  (0 is pad by convention).
- **Shared-prefix profile** (``shared``): ``shared_prefixes``
  seeded "system prompts" of ``shared_prefix_len`` tokens are drawn
  ONCE; every arrival picks one uniformly and appends its own
  ``shared_suffix_len`` random tokens (``max_new`` still drawn from the
  mix's categorical, optionally jittered per request by
  ``max_new_jitter`` — the knob that gives the speculative A/B
  variable decode lengths).  Prompt length is therefore UNIFORM —
  page-granular radix matches land at one matched length, so the
  engine's start-homogeneous prefill batches never fragment — and at
  production-shaped traffic most arrivals repeat a recent prefix: the
  workload the radix prefix cache's cached-vs-cold A/B is gated on.

Everything is host-side numpy off one ``RandomState(seed)`` — no torch,
no device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

# (prompt_len, max_new_tokens, weight)
DEFAULT_MIX: tuple[tuple[int, int, float], ...] = (
    (4, 8, 0.5),    # chat-style: short prompt, longer generation
    (8, 4, 0.3),    # retrieval-style: longer prompt, short answer
    (6, 6, 0.2),
)

PROFILES = ("flat", "ramp", "spike", "shared")


@dataclass(frozen=True)
class TrafficSpec:
    """One reproducible workload: rate shape + length mix + seed."""

    seed: int = 0
    duration_s: float = 4.0
    rate_rps: float = 4.0          # peak arrival rate (requests/sec)
    profile: str = "ramp"
    mix: tuple[tuple[int, int, float], ...] = field(default=DEFAULT_MIX)
    vocab_size: int = 64
    # the shared-prefix profile's shape: K system prompts x Poisson
    # arrivals; prompt = prefix (shared_prefix_len) + per-request suffix
    # (shared_suffix_len).  6 + 2 = 8 fits the smoke engine's
    # max_prompt_len as exactly two full pages at the smoke page_len of
    # 4, so radix hits share the first page BY REFERENCE (matched = 4;
    # the second page mixes prefix tail with the per-request suffix and
    # never matches).  The copy-on-write path needs a prompt that ENDS
    # inside a page — it is pinned directly in
    # tests/test_serve_prefix.py rather than ridden through this trace.
    shared_prefixes: int = 2
    shared_prefix_len: int = 6
    shared_suffix_len: int = 2
    # shared-profile decode-length jitter: each arrival's
    # max_new moves by a seeded uniform draw in [-j, +j] (floored at 1)
    # so the speculative A/B exercises VARIABLE decode lengths — a
    # homogeneous length would let every slot complete on the same
    # round and hide the mid-flight accept/reject interleavings.  0
    # draws nothing, so existing seeds replay byte-identically.
    max_new_jitter: int = 0

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate lambda(t) of the profile."""
        if self.profile in ("flat", "shared"):
            return self.rate_rps
        frac = t / self.duration_s if self.duration_s > 0 else 0.0
        if self.profile == "ramp":
            return self.rate_rps * (0.1 + 0.9 * min(max(frac, 0.0), 1.0))
        if self.profile == "spike":
            return self.rate_rps * (1.0 if 1 / 3 <= frac < 2 / 3 else 0.3)
        raise ValueError(
            f"profile {self.profile!r} is not one of {PROFILES}"
        )


def synth_trace(spec: TrafficSpec) -> list[dict[str, Any]]:
    """Materialize the arrival trace: ``[{"t", "prompt", "max_new"}]``
    sorted by arrival time, deterministic in ``spec.seed``.

    Thinning: candidate gaps are exponential at the PEAK rate; each
    candidate is kept with probability ``lambda(t)/peak`` — the kept
    points are a Poisson process with intensity ``lambda(t)``."""
    if spec.rate_rps <= 0 or spec.duration_s <= 0:
        return []
    rng = np.random.RandomState(spec.seed)
    weights = np.asarray([w for _, _, w in spec.mix], np.float64)
    weights = weights / weights.sum()
    shared = spec.profile == "shared"
    # the jitter knob draws from its OWN seeded stream: arrivals,
    # prompts and thinning are byte-identical across jitter settings
    # (only max_new moves), so a jittered trace stays comparable to
    # its jitter=0 twin — and jitter=0 replays the pre-knob bytes
    jrng = (
        np.random.RandomState(spec.seed ^ 0x5BD1E995)
        if shared and spec.max_new_jitter > 0 else None
    )
    prefixes: list[list[int]] = []
    if shared:
        if spec.shared_prefixes < 1 or spec.shared_prefix_len < 1:
            raise ValueError(
                f"shared profile needs shared_prefixes="
                f"{spec.shared_prefixes} >= 1 and shared_prefix_len="
                f"{spec.shared_prefix_len} >= 1"
            )
        # the K "system prompts", drawn once up front so the whole
        # trace shares them (and so the draw order — prefixes first,
        # then arrivals — is part of the seeded contract)
        prefixes = [
            [int(x) for x in rng.randint(
                1, spec.vocab_size, size=spec.shared_prefix_len
            )]
            for _ in range(spec.shared_prefixes)
        ]
    out: list[dict[str, Any]] = []
    peak = max(spec.rate_at(t) for t in np.linspace(
        0.0, spec.duration_s, 64
    ))
    peak = max(peak, 1e-9)
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= spec.duration_s:
            break
        if rng.uniform() > spec.rate_at(t) / peak:
            continue  # thinned: the profile is below peak here
        if shared:
            _, max_new, _ = spec.mix[int(rng.choice(len(spec.mix),
                                                    p=weights))]
            if jrng is not None:
                max_new = max(1, max_new + int(jrng.randint(
                    -spec.max_new_jitter, spec.max_new_jitter + 1
                )))
            prefix = prefixes[int(rng.randint(spec.shared_prefixes))]
            suffix = rng.randint(
                1, spec.vocab_size, size=spec.shared_suffix_len
            )
            prompt = prefix + [int(x) for x in suffix]
        else:
            p_len, max_new, _ = spec.mix[int(rng.choice(len(spec.mix),
                                                        p=weights))]
            prompt = [int(x) for x in rng.randint(
                1, spec.vocab_size, size=int(p_len)
            )]
        out.append({
            "t": round(t, 6),
            "prompt": prompt,
            "max_new": int(max_new),
        })
    return out


def trace_tokens(trace: list[dict[str, Any]]) -> int:
    """Total prompt+output tokens the trace asks for — what the
    admission token budget is sized against."""
    return sum(len(r["prompt"]) + r["max_new"] for r in trace)
