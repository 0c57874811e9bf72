"""Stall watchdog: turn a silent hang into a stack-attributed dump.

A run's worst failure mode is not a crash but a *wedge*: a collective
waiting for a rank that died, a card that stopped answering.  This
module is the detector: a daemon monitor thread that fires when no
progress beat arrives within a deadline, captures **every host thread's
Python stack** (``sys._current_frames`` — it sees the wedged thread
exactly where it is blocked), and persists it through the flight
recorder, so the post-mortem names the blocking frame instead of the
timeout.

Progress is whatever the caller defines: :meth:`StallWatchdog.beat`
directly, or any :meth:`~ddl25spring_tpu_torch.obs.recorder.
FlightRecorder.record`/``beat`` on the shared flight ring (the default
source) — the sentinels record or beat it for every step they fold, so
a guarded run gets stall coverage for free.

Host-only by construction: its dump folds only what the card has
finished (``flight.dump(block=False)``), so a stuck card cannot stall
the watchdog as well.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import traceback
import time
from typing import Any, Callable

from ddl25spring_tpu_torch.analysis.host_sanitizer import wrap_lock
from ddl25spring_tpu_torch.obs.recorder import (
    flight,
    watchdog_deadline_default,
)


def thread_stacks() -> dict[str, list[str]]:
    """Format every live host thread's current Python stack.  Keys are
    ``"name (tid)"``; values are ``file:line in func`` frame lists,
    innermost last — the shape a human reads."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')} (tid={tid})"
        out[label] = [
            f"{fs.filename}:{fs.lineno} in {fs.name}"
            + (f"\n    {fs.line}" if fs.line else "")
            for fs in traceback.extract_stack(frame)
        ]
    return out


#: how long :meth:`StallWatchdog.stop` waits for a dump in flight
STOP_WAIT_S = 30.0


class StallWatchdog:
    """Fire once when no step completes within ``deadline_s``.

    Usage — wrap any phase that must keep making progress::

        with StallWatchdog(deadline_s=600, name="train") as wd:
            for step in range(n):
                run_one_step()
                wd.beat()
        if wd.fired:
            ...  # wd.dump_path holds the stack-attributed flight dump

    ``source="flight"`` (default) also counts any activity on the shared
    flight recorder as progress, so guarded steps feed it without
    plumbing.  The monitor is a
    daemon thread: a fired (or forgotten) watchdog can never keep the
    process alive.  It fires ONCE per stall episode (the dump is not
    repeated while the same stall drags on) and re-arms as soon as real
    progress resumes — from ``beat()`` or any watched-source activity —
    so a second stall later in the same run fires again.
    """

    def __init__(
        self,
        deadline_s: float | None = None,
        run_dir: str | None = None,
        name: str = "run",
        source: str = "flight",
        on_fire: Callable[[dict], Any] | None = None,
        poll_s: float | None = None,
    ):
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else watchdog_deadline_default()
        )
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}"
            )
        self.name = name
        self.run_dir = run_dir
        self.source = source
        self.on_fire = on_fire
        self.poll_s = poll_s or min(1.0, self.deadline_s / 4)
        self.fired = False
        self.fire_count = 0
        self.dump_path: str | None = None
        # guards the beat/fired transitions: beat() runs on the main
        # thread, the re-arm and fire run on the monitor, and an
        # unsynchronized test-and-set would race.  Never held
        # across the dump (which can block on I/O for seconds).
        self._state_lock = wrap_lock(
            "watchdog._state_lock", threading.Lock()
        )
        self._last_beat = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()  # a stopped watchdog must be restartable
        self.beat()
        self._thread = threading.Thread(
            target=self._monitor,
            name=f"stall-watchdog[{self.name}]",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # the monitor wakes within a poll; a dump in flight (its census
            # of the live tensors takes a moment) is waited for, so
            # ``dump_path`` is set once a fired watchdog has stopped
            self._thread.join(timeout=max(2 * self.poll_s, STOP_WAIT_S))
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def beat(self) -> None:
        with self._state_lock:
            self._last_beat = time.perf_counter()
            self.fired = False  # re-arm after a fire

    # ---- monitor --------------------------------------------------------

    def _idle_s(self) -> float:
        with self._state_lock:
            idle = time.perf_counter() - self._last_beat
        if self.source == "flight":
            idle = min(idle, flight.seconds_since_beat())
        return idle

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            idle = self._idle_s()
            if self.fired:
                # one dump per stall episode; REAL progress (our stall
                # record doesn't touch the flight clock) re-arms so the
                # next stall in the same run fires again
                if idle < self.deadline_s:
                    with self._state_lock:
                        self.fired = False
                continue
            if idle >= self.deadline_s:
                self._fire()

    def _fire(self) -> None:
        with self._state_lock:
            self.fired = True
            self.fire_count += 1
        info = {
            "watchdog": self.name,
            "deadline_s": self.deadline_s,
            "idle_s": round(self._idle_s(), 3),
            "fired_at_unix": time.time(),
        }
        stacks = thread_stacks()
        flight.record(kind="stall", touch=False, **info,
                      threads=len(stacks))
        try:
            self.dump_path = flight.dump(
                path=(
                    None if self.run_dir is None
                    else f"{self.run_dir}/flight.json"
                ),
                reason="stall",
                extra={"stall": info, "thread_stacks": stacks},
                block=False,
            )
            where = self.dump_path
        except Exception as e:  # noqa: BLE001 — keep the stderr alert
            where = f"<dump failed: {e}>"
        print(
            f"[stall-watchdog:{self.name}] no step completed in "
            f"{self.deadline_s:.0f}s — {len(stacks)} host thread stacks "
            f"dumped to {where}",
            file=sys.stderr,
        )
        if self.on_fire is not None:
            with contextlib.suppress(Exception):
                self.on_fire(dict(info, dump_path=self.dump_path))
