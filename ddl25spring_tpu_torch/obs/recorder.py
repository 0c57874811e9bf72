"""Crash-surviving flight recorder: the last N step records, dumpable.

A run that dies should leave more than its last line of output.  The
flight recorder is a thread-safe ring buffer of the last ``N`` step
records (step index, sentinel values, wall timings, strategy, plus
whatever run metadata — grid, layout, seed — the caller annotates),
persisted as a structured ``flight.json`` on

- **unhandled exception** (a chained ``sys.excepthook``),
- **SIGTERM** (the scheduler-kill path; the previous handler is chained),
- **interpreter exit** (``atexit``, skipped when a dump already covers
  the latest records),
- **explicit calls** — the sentinel ``halt`` policy and the stall
  watchdog both dump through here,

so a dead run is diagnosable from artifacts alone.  Recording is pure
host-side bookkeeping (a deque append under a lock) — nothing here ever
touches a tensor, so it is always on wherever a training loop calls it; the
handlers install only on request (:meth:`FlightRecorder.install`), never
at import.

The train steps' facts are computed on the card and reach the ring
later, when the card has finished the step (:mod:`~ddl25spring_tpu_torch.
obs.sentinels`).  Those producers register a *flusher*
(:meth:`FlightRecorder.add_flusher`); :meth:`FlightRecorder.snapshot`
and :meth:`FlightRecorder.dump` run every flusher first, so a snapshot
or a dump holds every step the card has run.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any

from ddl25spring_tpu_torch.analysis.host_sanitizer import wrap_lock
from ddl25spring_tpu_torch.utils.config import env_float

DEFAULT_CAPACITY = 256
FLIGHT_BASENAME = "flight.json"
_UNSET = object()  # configure() sentinel: "leave as is" vs "clear"


def default_flight_dir() -> str:
    """Where dumps land when no run dir was configured: the
    ``DDL25_FLIGHT_DIR`` env (through the sanctioned boundary's module —
    a plain read here since this is host-only code) or ``runs/flight``."""
    return os.environ.get("DDL25_FLIGHT_DIR") or os.path.join(
        "runs", "flight"
    )


def _memory_summary() -> dict[str, Any]:
    """The card's allocator counters (when torch has touched CUDA) and the
    host's peak RSS: what a dump says about memory."""
    import resource

    import torch

    out: dict[str, Any] = {
        "host_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if torch.cuda.is_initialized():
        out["cuda_memory"] = {
            "allocated_bytes": torch.cuda.memory_allocated(),
            "max_allocated_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
        }
    return out


def _json_safe(v: Any):
    """NaN/Inf are exactly what flight records carry on the day they
    matter — encode them as strings so the dump stays strict JSON.
    Foreign scalar types (numpy float32 losses, 0-dim tensors in
    annotate()) coerce through ``float``/``str``: a crash dump must never fail on
    the shape of what it is recording."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)  # 'nan', 'inf', '-inf'
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:  # numpy scalars, 0-dim tensors and anything float-like
        return _json_safe(float(v))
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """Thread-safe ring buffer of run-health records + dump machinery."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # REENTRANT on purpose: the SIGTERM handler runs on the main
        # thread and walks the shutdown hooks + dump() — both of which
        # take this lock — and the signal can land while that same
        # thread is inside record()'s critical section (it runs every
        # step).  A plain Lock would self-deadlock the preemption path;
        # reentrancy at worst lets the handler observe a half-applied
        # record update (an off-by-one "recorded" count in the dump),
        # which a dying process tolerates.  DDL25_SANITIZE=1 wraps it
        # in the graft-race order-recording proxy (a no-op pass-through
        # otherwise).
        self._lock = wrap_lock("flight._lock", threading.RLock())
        self._records: deque[dict] = deque(maxlen=capacity)
        self._meta: dict[str, Any] = {}
        self._seq = 0
        # cumulative per-kind counters, ring-eviction-proof: a violation
        # recorded 1000 steps ago must still fail --check-health even
        # after the ring rolled past it, and the recovery report counts
        # saves/restores the same way
        self._counts: dict[str, int] = {}
        self._last: dict[str, dict] = {}
        # shutdown hooks: callables the crash paths run BEFORE dumping
        # (checkpoint barriers, flushes) so the dump names what they
        # made durable — see register_shutdown
        self._shutdown_hooks: dict[str, Any] = {}
        self._run_dir: str | None = None
        self._t0 = time.perf_counter()
        self._t0_unix = time.time()
        self._last_beat = time.perf_counter()
        # taps: callables invoked with every record (outside the lock,
        # exceptions suppressed) — how obs.timeline mirrors narrating
        # kinds (chaos/reshape/save/stall/violation…) into the unified
        # event log without editing six call sites.  Taps survive
        # reset(): they are wiring, not run state.
        self._taps: list = []
        # flushers: callables that fold facts still on their way from the
        # card into the ring (obs.sentinels, obs.counters), run before
        # every snapshot, outside the lock.  Wiring, like the taps.
        self._flushers: list = []
        self._dumped_seq = -1
        self._installed = False
        self._prev_excepthook = None
        self._prev_sigterm = None

    # ---- recording ------------------------------------------------------

    def configure(self, run_dir=_UNSET, capacity: int | None = None) -> None:
        """Set the dump directory and/or ring capacity.  ``run_dir=None``
        CLEARS a previously-set directory (back to the
        :func:`default_flight_dir` fallback) — the distinction from
        "not passed" matters for anything resetting the shared
        recorder, or a stale test/run dir leaks into later dumps."""
        with self._lock:
            if run_dir is not _UNSET:
                self._run_dir = run_dir
            if capacity is not None and capacity != self._records.maxlen:
                self._records = deque(self._records, maxlen=capacity)

    def annotate(self, **meta: Any) -> None:
        """Attach run-level facts (strategy, mesh, layout, RNG seed…)
        that every dump should carry; last write per key wins."""
        with self._lock:
            self._meta.update(meta)

    def record(
        self, kind: str = "step", *, touch: bool = True, **fields: Any
    ) -> dict:
        """Append one record to the ring; returns it (with ``seq`` and
        wall-clock offsets assigned).  Cheap: one locked deque append.
        ``touch=False`` records WITHOUT counting as liveness — the
        stall watchdog uses it so its own stall record doesn't read as
        the progress that would re-arm it mid-stall."""
        now = time.perf_counter()
        with self._lock:
            rec = {
                "seq": self._seq,
                "kind": kind,
                "t_s": round(now - self._t0, 6),
                **fields,
            }
            self._seq += 1
            self._records.append(rec)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._last[kind] = rec
            if touch:
                self._last_beat = now
        # taps run OUTSIDE the lock: a tap appends into its own
        # lock-guarded structure (the timeline), and lock nesting across
        # modules is how shutdown-path deadlocks are born.  A tap must
        # never take down the subsystem that is narrating.
        for tap in list(self._taps):
            try:
                tap(rec)
            except Exception:  # noqa: BLE001 - observability stays passive
                pass
        return rec

    def add_tap(self, fn) -> None:
        """Subscribe ``fn(record)`` to every :meth:`record` call.
        Idempotent per callable; taps persist across :meth:`reset`."""
        with self._lock:
            if fn not in self._taps:
                self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    def add_flusher(self, fn) -> None:
        """Run ``fn(block)`` before every :meth:`snapshot` (and so every
        :meth:`dump`): ``block`` says whether it may wait for the card.
        Idempotent per callable; survives :meth:`reset`."""
        with self._lock:
            if fn not in self._flushers:
                self._flushers.append(fn)

    def _flush(self, block: bool) -> None:
        with self._lock:
            flushers = list(self._flushers)
        for fn in flushers:
            fn(block)

    def beat(self) -> None:
        """Liveness tick without a record — the watchdog's heartbeat."""
        with self._lock:
            self._last_beat = time.perf_counter()

    def seconds_since_beat(self) -> float:
        with self._lock:
            return time.perf_counter() - self._last_beat

    def last(self, n: int | None = None) -> list[dict]:
        with self._lock:
            recs = list(self._records)
        return recs if n is None else recs[-n:]

    def counts(self) -> dict[str, int]:
        """Cumulative per-kind record counts (O(kinds), no ring copy) —
        the cheap poll the autosave gate and telemetry cells use."""
        with self._lock:
            return dict(self._counts)

    def snapshot(self, block: bool = True) -> dict[str, Any]:
        """The ring and its summary.  The flushers run first; ``block=False``
        folds only what the card has finished (the stall watchdog's dump
        must not wait on a card that may be the thing that is stuck)."""
        self._flush(block)
        with self._lock:
            return {
                "meta": dict(self._meta),
                "capacity": self._records.maxlen,
                "recorded": self._seq,
                # anchors record t_s offsets to unix time so
                # tools/trace_export.py can merge the ring with the
                # span recorder and the timeline on one axis
                "time_origin_unix_s": self._t0_unix,
                "violations": self._counts.get("violation", 0),
                "stalls": self._counts.get("stall", 0),
                "counts": dict(self._counts),
                **{
                    f"last_{k}": dict(r) for k, r in self._last.items()
                },
                "records": [dict(r) for r in self._records],
            }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._meta.clear()
            self._seq = 0
            self._counts = {}
            self._last.clear()
            self._shutdown_hooks.clear()
            self._dumped_seq = -1
            self._t0 = time.perf_counter()
            self._t0_unix = time.time()
            self._last_beat = time.perf_counter()

    # ---- dumping --------------------------------------------------------

    def dump(
        self,
        path: str | None = None,
        reason: str = "manual",
        extra: dict | None = None,
        block: bool = True,
    ) -> str:
        """Write ``flight.json`` (atomically: temp file + rename, so a
        crash mid-dump never leaves a truncated artifact where a good
        one could have been) and return its path.  ``block`` as in
        :meth:`snapshot`."""
        if path is None:
            d = self._run_dir or default_flight_dir()
            path = os.path.join(d, FLIGHT_BASENAME)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = self.snapshot(block)
        doc["record"] = "flight"
        doc["reason"] = reason
        doc["dumped_at_unix"] = time.time()
        # violations/stalls ride the CUMULATIVE counters (snapshot), not
        # a recount of the bounded ring — a violation recorded hundreds
        # of steps before an end_of_run/atexit dump must still fail the
        # --check-health gate after the ring evicted it, and a later
        # dump must not erase an earlier watchdog fire.  The watchdog's
        # own dump overrides `stall` with its richer point-in-time info
        # (thread stacks) via ``extra``.
        last_stall = doc.pop("last_stall", None)
        if last_stall is not None:
            doc["stall"] = {
                k: v for k, v in last_stall.items()
                if k not in ("seq", "kind")
            }
        # every dump carries the card's allocator picture and the host
        # RSS, so an OOM-shaped death is diagnosable from flight.json
        # alone.  Suppressed wholesale: a crash dump must succeed even
        # with torch half-torn-down.
        with contextlib.suppress(Exception):
            doc.update(_memory_summary())
        if extra:
            doc.update(extra)
        # pid AND thread id: the watchdog's monitor thread and the main
        # thread's excepthook/halt can dump concurrently — two writers
        # sharing one temp name would interleave and break atomicity
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(_json_safe(doc), f, indent=1, allow_nan=False)
        os.replace(tmp, path)
        with self._lock:
            # mark only the SNAPSHOTTED records as dumped: a record
            # appended on another thread mid-write is not in this
            # artifact, and the atexit pending-check must still see it
            self._dumped_seq = max(self._dumped_seq, doc["recorded"])
        return path

    # ---- shutdown hooks -------------------------------------------------

    def register_shutdown(self, fn, name: str | None = None) -> str:
        """Chain ``fn`` into every crash path this recorder owns —
        excepthook, SIGTERM, atexit — running BEFORE the flight dump so
        the dump records what the hook made durable.  The canonical
        client is :meth:`ft.autosave.AutoSaver.close`: a SIGTERM'd run
        barriers its in-flight checkpoint instead of truncating it.

        Hooks must bound their own runtime (a wedged hook on the
        SIGTERM path would out-wait the scheduler's kill grace — the
        autosave barrier takes a timeout for exactly this reason) and
        be idempotent (the atexit pass runs them again after a SIGTERM
        that chose not to exit).  Returns the registration name for
        :meth:`unregister_shutdown`."""
        name = name or f"hook-{id(fn):x}"
        with self._lock:
            self._shutdown_hooks[name] = fn
        return name

    def unregister_shutdown(self, name: str) -> None:
        with self._lock:
            self._shutdown_hooks.pop(name, None)

    def _run_shutdown_hooks(self, reason: str) -> None:
        del reason  # all paths run all hooks; the arg documents call sites
        with self._lock:
            hooks = list(self._shutdown_hooks.values())
        for fn in hooks:
            # a failing hook must cost neither the dump nor its peers
            with contextlib.suppress(Exception):
                fn()

    # ---- crash handlers -------------------------------------------------

    def install(self, run_dir: str | None = None) -> None:
        """Arm the crash paths: excepthook + SIGTERM + atexit, each
        chaining to whatever was installed before.  Idempotent."""
        if run_dir is not None:
            self.configure(run_dir=run_dir)
        if self._installed:
            return
        self._installed = True

        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            # whatever the hooks or dump() hit, the original exception
            # must still reach the user
            self._run_shutdown_hooks("unhandled_exception")
            with contextlib.suppress(Exception):
                self.dump(
                    reason="unhandled_exception",
                    extra={"exception": f"{exc_type.__name__}: {exc}"},
                )
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook

        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                # barrier checkpoints FIRST (each hook bounds itself),
                # so the dump below names the truly durable step; a
                # failed dump must not break signal handling
                self._run_shutdown_hooks("sigterm")
                with contextlib.suppress(Exception):
                    self.dump(reason="sigterm")
                if prev is signal.SIG_IGN:
                    return  # the process chose to ignore TERM: dump only
                if callable(prev):
                    prev(signum, frame)
                else:
                    # exit NOW with the conventional 128+SIGTERM status
                    # (re-delivering through the default handler would
                    # require surviving another interpreter round-trip,
                    # and a dying process owes the world nothing more
                    # than its flight dump).  Caveat shared by any
                    # Python-level handler: a main thread wedged in
                    # native code that holds the GIL never runs this —
                    # the stall watchdog and an external hard kill
                    # cover that mode.
                    sys.stderr.flush()
                    os._exit(128 + signum)

            signal.signal(signal.SIGTERM, _on_term)
            self._prev_sigterm = prev
        except (ValueError, OSError):
            # not the main thread (or an exotic platform): the excepthook
            # and atexit paths still cover crashes
            self._prev_sigterm = None

        atexit.register(self._atexit_dump)

    def _atexit_dump(self) -> None:
        # hooks run UNCONDITIONALLY (they are idempotent by contract):
        # an exiting run whose records were already dumped still owes
        # its checkpoint barrier
        self._run_shutdown_hooks("atexit")
        with self._lock:
            pending = self._seq > self._dumped_seq and self._seq > 0
        if pending:
            with contextlib.suppress(Exception):  # exit must stay clean
                self.dump(reason="atexit")

    def uninstall(self) -> None:
        """Disarm the handlers (test harness); atexit's entry becomes a
        no-op via the dumped-seq check rather than unregistration."""
        if not self._installed:
            return
        self._installed = False
        sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
        with contextlib.suppress(Exception):  # best-effort disarm
            atexit.unregister(self._atexit_dump)
        with self._lock:
            self._dumped_seq = self._seq


flight = FlightRecorder()


def watchdog_deadline_default() -> float:
    """The stall watchdog's default deadline (seconds):
    ``DDL25_WATCHDOG_S`` or 900 s — long enough for the kernels' first
    build, far shorter than a wedged collective's forever."""
    return env_float("DDL25_WATCHDOG_S", 900.0)
