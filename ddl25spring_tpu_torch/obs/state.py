"""The one global switch for run telemetry.

Everything in :mod:`ddl25spring_tpu_torch.obs` keys off this flag **when a
step is built**: the builders read it once (``instrument=None`` follows it)
and bake the answer into the step they return, so a step built with the
flag off runs exactly the operations of an uninstrumented one (pinned with
a ``TorchDispatchMode`` op log in ``tests/test_torch_obs.py``).  Flipping
the flag therefore needs the step rebuilt.

Enable via ``DDL25_OBS=1`` in the environment, :func:`enable`, or the
:func:`scoped` context manager (tests).
"""

from __future__ import annotations

import contextlib

from ddl25spring_tpu_torch.utils.config import env_flag

_enabled: bool = env_flag("DDL25_OBS")


def enabled() -> bool:
    """Is telemetry on?  Read by every builder when it builds a step."""
    return _enabled


def enable(on: bool = True) -> None:
    """Turn telemetry on/off globally (affects steps built afterwards)."""
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def scoped(on: bool = True):
    """Temporarily set the telemetry flag (test harness use)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev
