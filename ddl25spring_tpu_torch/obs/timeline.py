"""The unified run timeline: one run, one ordered event log.

:class:`Timeline` gives every subsystem a single typed, append-only stream
to emit into, in the JAX package's file format (``timeline.jsonl``), so
``tools/trace_export.py`` merges either package's run directory with its
spans (``trace.json``) and flight ring (``flight.json``) into one Perfetto
trace.

- **Typed.**  Every event kind is declared in :data:`EVENT_KINDS` with
  its required payload fields; :meth:`Timeline.emit` refuses unknown
  kinds and missing fields loudly.  The table keeps every kind the JAX
  package declares, the serving engine's included, so the file format
  is the same.
- **Append-only JSONL + ring.**  When :meth:`Timeline.configure` names a
  run dir, events stream to ``timeline.jsonl`` (one strict-JSON object
  per line, flushed per write, NaN refused — the
  :func:`~ddl25spring_tpu_torch.obs.logger.read_jsonl` idiom).  A
  bounded ring (:data:`DEFAULT_CAPACITY`) always holds the tail
  regardless, so in-process consumers (reports, tests) never touch the
  filesystem.
- **Crash-flushed through the flight shutdown chain.**  ``configure``
  registers :meth:`Timeline.flush` via
  :meth:`~ddl25spring_tpu_torch.obs.recorder.FlightRecorder.
  register_shutdown` — bounded and idempotent per that contract — so an
  excepthook / SIGTERM / atexit dump carries the timeline's last
  buffered lines too.
- **Two clocks.**  Every event stamps ``t_wall_s`` (host wall, this
  timeline's perf-counter origin; ``time_origin_unix_s`` in the header
  anchors it to unix time for cross-artifact merging).  Serve events add
  ``vt_s``, the engine's clock.
- **Gated like everything in obs.**  :meth:`emit` is a no-op unless
  :func:`ddl25spring_tpu_torch.obs.state.enabled`; emission is host-side
  only.

Subsystems that narrate into the flight ring (watchdog stalls, sentinel
violations, and later chaos fires, reshapes and autosaves) are mirrored
into the timeline through a :meth:`~ddl25spring_tpu_torch.obs.recorder.
FlightRecorder.add_tap` hook — one wiring point instead of one per call
site.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable

from ddl25spring_tpu_torch.analysis.host_sanitizer import wrap_lock
from ddl25spring_tpu_torch.obs import state
from ddl25spring_tpu_torch.obs.recorder import _json_safe, flight

TIMELINE_BASENAME = "timeline.jsonl"
DEFAULT_CAPACITY = 4096

# ------------------------------------------------------------------ schema
#
# kind -> required payload fields.  Optional fields ride along freely
# (every event also carries record/seq/kind/t_wall_s, plus vt_s /
# engine / replica when the emitter supplies them); *required* fields
# are the contract reports and the trace exporter key on.
EVENT_KINDS: dict[str, tuple[str, ...]] = {
    # -- serve request lifecycle (the serving engine and its traffic runner) --
    "serve_submit": ("rid", "prompt_len", "max_new"),
    "serve_reject": ("rid", "reason"),
    "serve_admit": ("rid", "slot"),
    "serve_prefill": ("rid", "slot", "start", "prefix_hit_tokens"),
    "serve_first_token": ("rid", "ttft_s"),
    "serve_spec_round": ("rid", "round", "accepted", "rejected"),
    "serve_done": ("rid", "tokens"),
    "serve_drain": ("requeued",),
    "serve_drain_handoff": ("rid", "from_replica"),
    # -- reshape windows (elastic serving) --
    "reshape_end": ("reason", "t", "t_end"),
    # -- resource samples: live_bytes required; rss_bytes / pool_used /
    # queue_depth / tokens_per_s ride along and become Perfetto counter
    # tracks in tools/trace_export.py --
    "mem_sample": ("live_bytes",),
    # -- mirrored off the flight ring (FlightRecorder tap) --
    "mem": (),  # memory growth-detector violations
    "chaos": (),
    "reshape": (),
    "save": (),
    "save_skipped": (),
    "restore": (),
    "stall": (),
    "violation": (),
}

#: flight-ring kinds the tap mirrors into the timeline.  Serve flight
#: kinds (``serve_prefill``/``serve_tick``/``serve_spec``) are NOT
#: mirrored — the engine emits richer per-request events directly.
MIRRORED_FLIGHT_KINDS = frozenset(
    k for k, req in EVENT_KINDS.items() if not req
)


class Timeline:
    """Run-scoped structured event log: bounded ring + optional
    append-only JSONL stream, crash-flushed through the flight
    recorder's shutdown chain.  Thread-safe; a module singleton
    (:data:`timeline`) serves the whole process, like ``flight``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = wrap_lock("timeline._lock", threading.RLock())
        self._ring: deque = deque(maxlen=capacity)
        self._counts: dict[str, int] = {}
        self._seq = 0
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()
        self._stream = None
        self.path: str | None = None

    # ------------------------------------------------------- lifecycle

    def configure(self, run_dir: str | None = None,
                  capacity: int | None = None,
                  meta: dict | None = None) -> None:
        """(Re)target the timeline at a run directory.  Opens a fresh
        ``timeline.jsonl`` (header line first), resets seq/ring/clock
        origin — one configure == one run — and registers the crash
        flush with the flight shutdown chain.  ``run_dir=None`` closes
        the stream (events still ring in memory).  ``meta`` merges
        extra identity fields into the header line (a launcher stamps its
        retry ``lineage_id`` / ``attempt`` here so every attempt's
        timeline names the lineage it belongs to); reserved header
        keys win over collisions."""
        with self._lock:
            self.close()
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=int(capacity))
            self._ring.clear()
            self._counts = {}
            self._seq = 0
            self._t0 = time.perf_counter()
            self._t0_unix = time.time()
            if run_dir is None:
                return
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, TIMELINE_BASENAME)
            self._stream = open(self.path, "w")
            header = {
                **(meta or {}),
                "record": "timeline_header",
                "time_origin_unix_s": self._t0_unix,
                "capacity": self._ring.maxlen,
                "pid": os.getpid(),
            }
            self._stream.write(
                json.dumps(_json_safe(header), allow_nan=False) + "\n"
            )
            self._stream.flush()
            # every configure (re)registers: a flight.reset() between runs
            # clears the shutdown chain, and registration is idempotent
            flight.register_shutdown(self.flush, "timeline")

    def flush(self) -> None:
        """Flush the JSONL stream (bounded + idempotent: safe on the
        flight shutdown chain, safe to call twice, safe when closed)."""
        with self._lock:
            s = self._stream
            if s is not None and not s.closed:
                s.flush()
                try:
                    os.fsync(s.fileno())
                except OSError:  # pragma: no cover - exotic filesystems
                    pass

    def close(self) -> None:
        """Flush and close the stream; the ring stays readable."""
        with self._lock:
            if self._stream is not None:
                if not self._stream.closed:
                    self._stream.flush()
                    self._stream.close()
                self._stream = None
            self.path = None

    # --------------------------------------------------------- emission

    def emit(self, kind: str, *, vt: float | None = None,
             engine: str | None = None, replica: int | None = None,
             **fields: Any) -> dict | None:
        """Append one typed event.  No-op (``None``) when obs is
        disabled.  Raises ``ValueError`` on an unknown kind or a missing
        required field — the schema is a contract, not a convention.
        Reserved envelope keys win over payload collisions."""
        if not state.enabled():
            return None
        required = EVENT_KINDS.get(kind)
        if required is None:
            raise ValueError(
                f"unknown timeline event kind {kind!r} — declare it in "
                f"obs.timeline.EVENT_KINDS"
            )
        missing = [f for f in required if f not in fields]
        if missing:
            raise ValueError(
                f"timeline event {kind!r} missing required field(s) "
                f"{missing}"
            )
        with self._lock:
            rec = {
                **fields,
                "record": "event",
                "seq": self._seq,
                "kind": kind,
                "t_wall_s": round(time.perf_counter() - self._t0, 6),
            }
            if vt is not None:
                rec["vt_s"] = round(float(vt), 6)
            if engine is not None:
                rec["engine"] = engine
            if replica is not None:
                rec["replica"] = int(replica)
            self._seq += 1
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._ring.append(rec)
            if self._stream is not None and not self._stream.closed:
                self._stream.write(
                    json.dumps(_json_safe(rec), allow_nan=False) + "\n"
                )
                self._stream.flush()
            return rec

    # ------------------------------------------------------ inspection

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def events(self, kind: str | None = None) -> list[dict]:
        """The ring's current contents (oldest first), optionally
        filtered by kind."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "record": "timeline",
                "emitted": self._seq,
                "counts": dict(self._counts),
                "time_origin_unix_s": self._t0_unix,
                "path": self.path,
            }


#: process-wide singleton, mirroring ``obs.recorder.flight``.
timeline = Timeline()


def _flight_tap(rec: dict) -> None:
    """Mirror narrating flight kinds into the timeline (installed on the
    module-singleton ``flight`` at import).  Envelope keys from the
    flight record (seq / t_s) are renamed so the timeline's own
    envelope wins."""
    if rec.get("kind") not in MIRRORED_FLIGHT_KINDS:
        return
    payload = {
        ("flight_" + k if k in ("seq", "t_s", "kind", "record") else k): v
        for k, v in rec.items()
        if k != "kind"
    }
    timeline.emit(rec["kind"], **payload)


flight.add_tap(_flight_tap)


# ------------------------------------------------------------------ readers


def read_timeline(run_dir: str) -> tuple[dict, list[dict]]:
    """Load ``timeline.jsonl`` from a run dir: ``(header, events)``.
    Strict JSON (NaN/Infinity refused, matching the writer); raises
    ``FileNotFoundError`` when the run never configured a timeline."""
    path = os.path.join(run_dir, TIMELINE_BASENAME)
    header: dict = {}
    events: list[dict] = []

    def _reject(_):
        raise ValueError("non-finite constant in timeline.jsonl")

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line, parse_constant=_reject)
            if rec.get("record") == "timeline_header":
                header = rec
            else:
                events.append(rec)
    return header, events


__all__ = [
    "EVENT_KINDS",
    "MIRRORED_FLIGHT_KINDS",
    "TIMELINE_BASENAME",
    "Timeline",
    "read_timeline",
    "timeline",
]
