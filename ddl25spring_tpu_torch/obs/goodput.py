"""Run-lineage goodput and SLO decomposition: the port's own copy of the
JAX package's ``obs/goodput.py`` (a stdlib module, kept here so the port
imports nothing of that package).

The top-line metric is **goodput**: the share of wall-clock card time spent
on useful, SLO-compliant work.  This module folds the run's measured windows
into one number and the decomposition behind it:

- **Run lineage.**  A retry parent mints a ``lineage_id``
  (:func:`mint_lineage_id`) and an attempt index, handed to each child
  through ``DDL25_LINEAGE`` / ``DDL25_ATTEMPT``; a resumed child carries the
  same id.  An in-process run is its own one-attempt lineage.
- **Badput taxonomy.**  :class:`GoodputMeter` splits one attempt's wall into
  the buckets of :data:`BUCKETS` from measured windows: ``useful_step``
  (timed dispatches), ``warmup_compile`` (each ``timed_run``'s warm-up),
  ``checkpoint_save``, ``replayed_steps`` (the durable gap re-run after a
  resume), ``stall`` (seconds only: a stall overlaps the step that later
  completed), ``recovery`` and ``reshape_window``.  The residual is
  ``other``, reported and never dropped; the attributed sum may exceed the
  wall by at most :data:`SUM_TOLERANCE`.
- **Lineage merge.**  :func:`merge_lineage` folds every attempt of a lineage
  onto one axis: the final attempt's decomposition, and for each failed one
  its durable steps as ``useful_step``, its lost tail and backoff as
  ``recovery``, the rest as ``other``.
- **Serving goodput.**  :func:`serve_goodput_cell` judges each completed
  request's TTFT and per-token latency against ``DDL25_SLO_TTFT_MS`` /
  ``DDL25_SLO_TOK_MS`` on the engine's clock (virtual on the deterministic
  arms), counts SLO-compliant tokens per second per card, and charges
  availability with every rejected, dropped or handed-off request.

Artifacts: ``goodput.json`` in the run dir (:func:`write_run_goodput`), the
``telemetry.goodput`` cell of a BENCH line (:func:`goodput_cell`) and
``record: "goodput"`` ledger rows (:func:`ledger_row`), keyed (strategy,
mesh, host, scope) and gated by ``tools/goodput_report.py --check``.

Everything here is host-side bookkeeping on the host's clocks: it never
touches a tensor, so a run with it on launches exactly the kernels of a run
without it.
"""

from __future__ import annotations

import json
import os
import time
import uuid

GOODPUT_BASENAME = "goodput.json"

#: decomposition buckets, in render order.  ``other`` is the residual
#: (total wall minus everything measured) — reported, never dropped.
BUCKETS = (
    "useful_step",
    "warmup_compile",
    "checkpoint_save",
    "replayed_steps",
    "stall",
    "recovery",
    "reshape_window",
    "other",
)

#: pinned tolerance: the measured (attributed) seconds may exceed the
#: total wall by at most this fraction — the buckets come from
#: independent perf_counter brackets, so float re-association earns a
#: hair of slack, and anything beyond it is a double-billed window.
SUM_TOLERANCE = 0.02

#: the sanctioned env boundary for lineage propagation (retry parent ->
#: child) and serving SLOs.  Read via utils.config helpers only.
ENV_LINEAGE = "DDL25_LINEAGE"
ENV_ATTEMPT = "DDL25_ATTEMPT"
ENV_SLO_TTFT_MS = "DDL25_SLO_TTFT_MS"
ENV_SLO_TOK_MS = "DDL25_SLO_TOK_MS"

#: window-list bound: a soak run's per-step windows must not grow
#: goodput.json without limit — past the cap, seconds still accumulate
#: (the decomposition stays exact) and the doc says it truncated.
MAX_WINDOWS = 4096

# CI-smoke SLO defaults: generous enough that a healthy tiny-model CPU
# smoke attains them (the ramp runs on the WALL clock of a loaded CI
# box), tight enough that a wedged engine misses.  Operators override
# through the env boundary.
DEFAULT_SLO_TTFT_MS = 2000.0
DEFAULT_SLO_TOK_MS = 500.0


def mint_lineage_id() -> str:
    """A fresh lineage id (12 hex chars — unique per retry lineage,
    short enough to read in a ledger row)."""
    return uuid.uuid4().hex[:12]


def lineage_from_env() -> tuple[str | None, int]:
    """``(lineage_id, attempt)`` from the sanctioned env boundary —
    ``(None, 1)`` when no retry parent minted one (an in-process run
    mints its own)."""
    from ddl25spring_tpu_torch.utils.config import env_int, env_str

    return env_str(ENV_LINEAGE), max(1, env_int(ENV_ATTEMPT, 1))


def serve_slo() -> dict:
    """The serving SLO thresholds, env boundary over smoke defaults."""
    from ddl25spring_tpu_torch.utils.config import env_float

    return {
        "ttft_ms": env_float(ENV_SLO_TTFT_MS, DEFAULT_SLO_TTFT_MS),
        "tok_ms": env_float(ENV_SLO_TOK_MS, DEFAULT_SLO_TOK_MS),
    }


# ------------------------------------------------------------------ meter


class GoodputMeter:
    """Per-attempt wall-clock decomposition accumulator.

    One meter per process, anchored at the driver's entry perf-counter
    (``t0_perf``) so ``recovery`` can bill process entry -> restored.
    Buckets accumulate through :meth:`add` (measured ``[t0, t1)``
    windows on the meter's own axis, disjoint by construction at every
    call site) and :meth:`add_seconds` (duration-only facts like
    watchdog idle time whose window would overlap a step's).
    :meth:`finalize` closes the attempt: the residual becomes
    ``other`` and the sum contract is self-checked.
    """

    def __init__(
        self,
        lineage_id: str,
        attempt: int = 1,
        *,
        t0_perf: float | None = None,
        chips: int = 1,
    ):
        self.lineage_id = lineage_id
        self.attempt = int(attempt)
        self._t0 = time.perf_counter() if t0_perf is None else t0_perf
        # unix anchor for the SAME instant as _t0, so lineage merging
        # and the trace exporter can shift windows across attempts
        self.t0_unix = time.time() - (time.perf_counter() - self._t0)
        self.chips = max(1, int(chips))
        self.seconds: dict[str, float] = {}
        self.chip_seconds: dict[str, float] = {}
        self.windows: list[dict] = []
        self.windows_truncated = 0
        self.step_counts: dict[str, int] = {}
        # global step indices a resumed attempt re-runs (the durable
        # gap): timed dispatches landing on them bill replayed_steps
        self.replay_steps: frozenset[int] = frozenset()

    def now(self) -> float:
        """Seconds since the meter origin (the decomposition axis)."""
        return time.perf_counter() - self._t0

    def set_replay_window(self, start_step: int, last_prev_step: int) -> None:
        """Declare the durable gap ``[start_step, last_prev_step]`` —
        the steps a resumed attempt re-runs.  Their count must equal
        the manifest durable gap exactly (pinned)."""
        self.replay_steps = frozenset(
            range(int(start_step), int(last_prev_step) + 1)
        )

    def add_seconds(self, bucket: str, seconds: float,
                    *, chips: int | None = None) -> None:
        """Accumulate a duration with no window (stalls: the idle time
        is real, but its span overlaps the step that eventually
        completed — emitting it as a window would break the
        no-overlap contract)."""
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r}")
        s = max(0.0, float(seconds))
        c = self.chips if chips is None else max(1, int(chips))
        self.seconds[bucket] = self.seconds.get(bucket, 0.0) + s
        self.chip_seconds[bucket] = (
            self.chip_seconds.get(bucket, 0.0) + s * c
        )

    def add(self, bucket: str, t0_s: float, t1_s: float,
            *, chips: int | None = None, **facts) -> None:
        """Accumulate one measured window ``[t0_s, t1_s)`` on the meter
        axis.  Call sites keep windows disjoint by construction; the
        exporter's ``--check`` refuses overlap after the fact."""
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r}")
        t0_s, t1_s = float(t0_s), float(t1_s)
        if t1_s < t0_s:
            t0_s, t1_s = t1_s, t0_s
        self.add_seconds(bucket, t1_s - t0_s, chips=chips)
        if len(self.windows) >= MAX_WINDOWS:
            self.windows_truncated += 1
            return
        self.windows.append({
            "bucket": bucket,
            "t0_s": round(t0_s, 6),
            "t1_s": round(t1_s, 6),
            **({"chips": chips} if chips is not None else {}),
            **facts,
        })

    def note_step(self, global_step: int, t0_s: float, t1_s: float,
                  *, chips: int | None = None,
                  resumable: bool = True) -> None:
        """One timed dispatch window, bucketed ``useful_step`` or
        ``replayed_steps`` by its GLOBAL step index (the durable-gap
        re-runs are the same walls, differently billed).  Only a
        ``resumable`` phase's indices share units with the durable
        steps (the flight-record marker): a secondary phase restarting
        its own count at 0 must not collide with the replay window."""
        bucket = (
            "replayed_steps"
            if resumable and global_step in self.replay_steps
            else "useful_step"
        )
        self.step_counts[bucket] = self.step_counts.get(bucket, 0) + 1
        self.add(bucket, t0_s, t1_s, chips=chips, step=int(global_step))

    # ---- closing the attempt -------------------------------------------

    def _coalesced_windows(self) -> list[dict]:
        """Merge touching same-bucket windows (per-step windows of one
        phase collapse to one span) so goodput.json stays readable."""
        out: list[dict] = []
        for w in sorted(self.windows, key=lambda w: (w["t0_s"], w["t1_s"])):
            if (
                out
                and out[-1]["bucket"] == w["bucket"]
                and out[-1].get("chips") == w.get("chips")
                and w["t0_s"] - out[-1]["t1_s"] <= 1e-4
            ):
                out[-1] = {
                    **out[-1],
                    "t1_s": max(out[-1]["t1_s"], w["t1_s"]),
                    "n": out[-1].get("n", 1) + 1,
                }
            else:
                out.append(dict(w))
        return out

    def finalize(self, total_wall_s: float | None = None,
                 *, scope: str = "train_attempt", **extra) -> dict:
        """Close the decomposition: residual -> ``other``, sum contract
        self-checked, windows coalesced.  Returns the goodput doc
        (what ``goodput.json`` holds and ``telemetry.goodput``
        summarizes)."""
        total = self.now() if total_wall_s is None else float(total_wall_s)
        attributed = sum(self.seconds.values())
        other = max(0.0, total - attributed)
        overrun = max(0.0, attributed - total)
        seconds = {b: round(self.seconds.get(b, 0.0), 6) for b in BUCKETS}
        seconds["other"] = round(seconds.get("other", 0.0) + other, 6)
        chip_seconds = {
            b: round(self.chip_seconds.get(b, 0.0), 6) for b in BUCKETS
        }
        chip_seconds["other"] = round(
            chip_seconds.get("other", 0.0) + other * self.chips, 6
        )
        total_chip = total * self.chips
        return {
            "record": "goodput",
            "scope": scope,
            "lineage_id": self.lineage_id,
            "attempt": self.attempt,
            "attempts": self.attempt,
            "chips": self.chips,
            "total_wall_s": round(total, 6),
            "total_chip_s": round(total_chip, 6),
            "seconds": seconds,
            "chip_seconds": chip_seconds,
            "fraction_useful": round(
                chip_seconds["useful_step"] / total_chip, 6
            ) if total_chip > 0 else None,
            "steps": dict(self.step_counts),
            "replayed_steps_count": self.step_counts.get(
                "replayed_steps", 0
            ),
            "sum_check": sum_check(seconds, total),
            **({"overrun_s": round(overrun, 6)} if overrun else {}),
            "time_origin_unix_s": self.t0_unix,
            "windows": self._coalesced_windows(),
            **(
                {"windows_truncated": self.windows_truncated}
                if self.windows_truncated else {}
            ),
            **extra,
        }


def sum_check(seconds: dict, total_wall_s: float,
              tolerance: float = SUM_TOLERANCE) -> dict:
    """The pinned decomposition contract: every bucket (incl. the
    ``other`` residual) sums to the total wall within ``tolerance``.
    Because ``other`` absorbs any shortfall, the only way to fail is
    OVER-attribution — a double-billed window."""
    s = sum(float(v or 0.0) for v in seconds.values())
    total = float(total_wall_s)
    dev = abs(s - total)
    return {
        "attributed_s": round(s, 6),
        "total_wall_s": round(total, 6),
        "tolerance": tolerance,
        "ok": dev <= tolerance * max(total, 1e-9),
    }


# ----------------------------------------------------------- lineage merge


def failed_attempt_facts(flight_doc: dict,
                         durable_step: int | None) -> dict:
    """Price a dead attempt from its flight dump: the resumable step
    walls at-or-below the durable checkpoint are vouched-for useful
    work; the walls past it are the lost tail the resume re-pays.
    The retry parent calls this BEFORE the next attempt's dump
    replaces the file."""
    useful = lost = 0.0
    n_useful = n_lost = 0
    for r in (flight_doc or {}).get("records", []):
        if r.get("kind") != "step" or not r.get("resumable"):
            continue
        w = r.get("wall_s")
        step = r.get("step")
        if not isinstance(w, (int, float)) or not isinstance(step, int):
            continue
        if durable_step is not None and step <= durable_step:
            useful += float(w)
            n_useful += 1
        else:
            lost += float(w)
            n_lost += 1
    return {
        "useful_wall_s": round(useful, 6),
        "lost_wall_s": round(lost, 6),
        "useful_steps": n_useful,
        "lost_steps": n_lost,
        **(
            {"durable_step": durable_step}
            if durable_step is not None else {}
        ),
    }


def merge_lineage(final: dict | None, failures: list[dict],
                  *, lineage_id: str | None = None) -> dict | None:
    """Fold every attempt of a lineage onto one wall-clock axis.

    ``final`` is the surviving attempt's goodput doc (its own
    decomposition); each entry of ``failures`` is a retry JSONL record,
    extended by the parent with a ``goodput`` sub-cell
    (:func:`failed_attempt_facts`) plus ``wall_s`` / ``backoff_s``.
    A failed attempt's durable-step walls count ``useful_step``; its
    lost tail and the backoff bill ``recovery`` (work the resume
    re-pays + dead waiting); its unattributed setup is ``other``.
    Returns None when there is nothing to merge (no final doc and no
    failures)."""
    failures = [f for f in (failures or []) if isinstance(f, dict)]
    if final is None and not failures:
        return None
    chips = int((final or {}).get("chips") or 1)
    seconds = {b: 0.0 for b in BUCKETS}
    windows: list[dict] = []
    attempts_detail: list[dict] = []
    cursor = 0.0  # lineage-axis seconds consumed by prior attempts
    for f in failures:
        wall = float(f.get("wall_s") or 0.0)
        backoff = float(f.get("backoff_s") or 0.0)
        gp = f.get("goodput") if isinstance(f.get("goodput"), dict) else {}
        useful = min(float(gp.get("useful_wall_s") or 0.0), wall)
        lost = min(float(gp.get("lost_wall_s") or 0.0), wall - useful)
        setup = max(0.0, wall - useful - lost)
        seconds["useful_step"] += useful
        seconds["recovery"] += lost + backoff
        seconds["other"] += setup
        # coarse windows for the trace: the dead attempt's span on the
        # lineage axis — setup, then the vouched-for useful run, then
        # the lost tail + backoff as one recovery window
        t = cursor
        if setup:
            windows.append({"bucket": "other", "t0_s": round(t, 6),
                            "t1_s": round(t + setup, 6),
                            "attempt": f.get("attempt")})
            t += setup
        if useful:
            windows.append({"bucket": "useful_step", "t0_s": round(t, 6),
                            "t1_s": round(t + useful, 6),
                            "attempt": f.get("attempt")})
            t += useful
        if lost + backoff:
            windows.append({"bucket": "recovery", "t0_s": round(t, 6),
                            "t1_s": round(t + lost + backoff, 6),
                            "attempt": f.get("attempt"),
                            "reason": f.get("reason")})
        attempts_detail.append({
            "attempt": f.get("attempt"),
            "outcome": "failed",
            "reason": f.get("reason"),
            "wall_s": round(wall, 6),
            "backoff_s": round(backoff, 6),
            **gp,
        })
        cursor += wall + backoff
    total = cursor
    if final is not None:
        for b in BUCKETS:
            seconds[b] += float((final.get("seconds") or {}).get(b) or 0.0)
        for w in final.get("windows") or []:
            windows.append({
                **w,
                "t0_s": round(w["t0_s"] + cursor, 6),
                "t1_s": round(w["t1_s"] + cursor, 6),
            })
        total = cursor + float(final.get("total_wall_s") or 0.0)
        attempts_detail.append({
            "attempt": final.get("attempt"),
            "outcome": "succeeded",
            "wall_s": final.get("total_wall_s"),
            "fraction_useful": final.get("fraction_useful"),
        })
    seconds = {b: round(seconds[b], 6) for b in BUCKETS}
    total_chip = total * chips
    chip_seconds = {b: round(seconds[b] * chips, 6) for b in BUCKETS}
    lineage_unix0 = None
    if final is not None and final.get("time_origin_unix_s") is not None:
        lineage_unix0 = final["time_origin_unix_s"] - cursor
    return {
        "record": "goodput",
        "scope": "train_lineage",
        # identity (strategy/mesh) rides through from the surviving
        # attempt so the parent can key the lineage's ledger row
        **{
            k: final[k] for k in ("strategy", "mesh")
            if final is not None and final.get(k) is not None
        },
        "lineage_id": lineage_id or (final or {}).get("lineage_id"),
        "attempts": len(failures) + (1 if final is not None else 0),
        "chips": chips,
        "total_wall_s": round(total, 6),
        "total_chip_s": round(total_chip, 6),
        "seconds": seconds,
        "chip_seconds": chip_seconds,
        "fraction_useful": round(
            chip_seconds["useful_step"] / total_chip, 6
        ) if total_chip > 0 else None,
        "replayed_steps_count": (final or {}).get(
            "replayed_steps_count", 0
        ),
        "sum_check": sum_check(seconds, total),
        **(
            {"time_origin_unix_s": lineage_unix0}
            if lineage_unix0 is not None else {}
        ),
        "attempts_detail": attempts_detail,
        "windows": windows,
    }


# --------------------------------------------------------- serving goodput


def serve_goodput_cell(
    done,
    *,
    clock: str,
    wall_s: float | None,
    n_chips: int = 1,
    offered: int = 0,
    rejected: int = 0,
    completed: int = 0,
    dropped: int = 0,
    drain_demand: int = 0,
    slo: dict | None = None,
) -> dict:
    """SLO-denominated serving goodput over COMPLETED requests.

    ``done`` is the engine's completed :class:`~ddl25spring_tpu_torch.
    serve.engine.Request` list (or dicts with the same fields): TTFT =
    ``first_token_t - arrival_t`` and per-token latency =
    ``(done_t - first_token_t) / (tokens - 1)`` are judged on the
    ENGINE clock ``clock`` ("virtual" on deterministic arms — exactly
    where wall is noise-bound, so attainment is reproducible on any
    host).  Goodput tokens/sec/chip counts the SLO-compliant completed
    tokens only; availability charges every request the engine turned
    away or failed to finish: rejects at the door, accepted-then-
    dropped, and the drain-window demand (handoff re-submissions —
    served capacity the reshape consumed twice)."""
    slo = dict(slo or serve_slo())
    ttft_max = float(slo["ttft_ms"]) / 1e3
    tok_max = float(slo["tok_ms"]) / 1e3

    def _get(r, name):
        return r.get(name) if isinstance(r, dict) else getattr(r, name, None)

    evaluated = compliant = 0
    compliant_tokens = completed_tokens = 0
    ttft_misses = tok_misses = 0
    for r in done or []:
        arr, ftk = _get(r, "arrival_t"), _get(r, "first_token_t")
        dne = _get(r, "done_t")
        toks = _get(r, "tokens")
        n_tok = len(toks) if toks is not None else 0
        if arr is None or ftk is None or dne is None or not n_tok:
            continue
        evaluated += 1
        completed_tokens += n_tok
        ttft = ftk - arr
        tok_lat = (dne - ftk) / max(1, n_tok - 1)
        ttft_ok = ttft <= ttft_max
        tok_ok = tok_lat <= tok_max
        ttft_misses += 0 if ttft_ok else 1
        tok_misses += 0 if tok_ok else 1
        if ttft_ok and tok_ok:
            compliant += 1
            compliant_tokens += n_tok
    offered = max(int(offered), 0)
    unavailable = int(rejected) + int(dropped) + int(drain_demand)
    return {
        "slo": {**slo, "clock": clock},
        "requests_evaluated": evaluated,
        "slo_compliant": compliant,
        "slo_attainment": (
            round(compliant / evaluated, 6) if evaluated else None
        ),
        "ttft_misses": ttft_misses,
        "tok_latency_misses": tok_misses,
        "completed_tokens": completed_tokens,
        "slo_compliant_tokens": compliant_tokens,
        "goodput_tokens_per_sec_per_chip": (
            round(compliant_tokens / wall_s / max(1, n_chips), 3)
            if wall_s else None
        ),
        "offered": offered,
        "rejected": int(rejected),
        "dropped": int(dropped),
        "drain_demand": int(drain_demand),
        "completed": int(completed),
        "availability": (
            round(max(0.0, 1.0 - unavailable / offered), 6)
            if offered else None
        ),
    }


# ---------------------------------------------------------------- artifacts


def write_run_goodput(doc: dict, run_dir: str) -> str:
    """Atomic ``goodput.json`` in the run dir (temp + rename, the
    repo's dump idiom).  The retry parent REWRITES it with the merged
    lineage view after the surviving child wrote its attempt view."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, GOODPUT_BASENAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str, allow_nan=False)
    os.replace(tmp, path)
    return path


def read_run_goodput(run_dir: str) -> dict | None:
    """``goodput.json`` from a run dir, or None when the run never
    wrote one (obs off / pre-PR-20 artifacts)."""
    path = os.path.join(run_dir, GOODPUT_BASENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def goodput_cell(doc: dict | None) -> dict:
    """The ``telemetry.goodput`` cell: the decomposition summary
    without the window list (BENCH lines stay one readable JSON
    line)."""
    if not isinstance(doc, dict):
        return {"enabled": False}
    return {
        k: doc.get(k)
        for k in (
            "scope", "lineage_id", "attempt", "attempts", "chips",
            "total_wall_s", "seconds", "fraction_useful",
            "replayed_steps_count", "sum_check", "slo_attainment",
            "availability", "goodput_tokens_per_sec_per_chip",
        )
        if doc.get(k) is not None
    } or {"enabled": False}


def ledger_row(
    doc: dict,
    *,
    strategy: str,
    mesh: dict | None,
    host: dict | str | None,
    git_sha: str | None = None,
    extra_key: dict | None = None,
) -> dict:
    """One ``record: "goodput"`` trend row for the perf ledger — keyed (strategy, mesh, host, scope) like every other
    ledger kind so ``goodput_report --check`` bands the fraction over
    run history; the lineage id rides as identity, never as part of
    the trend key (every lineage is unique — keying on it would orphan
    every group)."""
    return {
        "record": "goodput",
        "ts": time.time(),
        **({"git_sha": git_sha} if git_sha else {}),
        **({"host": host} if host else {}),
        "key": {
            "strategy": strategy,
            "mesh": dict(mesh or {}),
            "scope": doc.get("scope"),
            **(extra_key or {}),
        },
        "lineage_id": doc.get("lineage_id"),
        "attempts": doc.get("attempts"),
        "chips": doc.get("chips"),
        "total_wall_s": doc.get("total_wall_s"),
        "fraction_useful": doc.get("fraction_useful"),
        "seconds": doc.get("seconds"),
        "replayed_steps_count": doc.get("replayed_steps_count"),
        "sum_check": doc.get("sum_check"),
        **(
            {
                "slo_attainment": doc.get("slo_attainment"),
                "availability": doc.get("availability"),
                "goodput_tokens_per_sec_per_chip": doc.get(
                    "goodput_tokens_per_sec_per_chip"
                ),
            }
            if doc.get("scope") == "serve" else {}
        ),
    }


__all__ = [
    "BUCKETS",
    "ENV_ATTEMPT",
    "ENV_LINEAGE",
    "ENV_SLO_TOK_MS",
    "ENV_SLO_TTFT_MS",
    "GOODPUT_BASENAME",
    "GoodputMeter",
    "MAX_WINDOWS",
    "SUM_TOLERANCE",
    "failed_attempt_facts",
    "goodput_cell",
    "ledger_row",
    "lineage_from_env",
    "merge_lineage",
    "mint_lineage_id",
    "read_run_goodput",
    "serve_goodput_cell",
    "serve_slo",
    "sum_check",
    "write_run_goodput",
]
