"""The autosave resume manifest and the durable-step scan, pure stdlib: the
counterpart of the JAX package's ``ft/manifest.py``, line for line.

Free of torch imports on purpose: the two readers of these facts must stay
light --

- a retry driver reads :func:`latest_durable_step` between relaunches to
  decide whether the next attempt can resume (it must not load
  ``torch.distributed.checkpoint`` into the parent process);
- a post-mortem report reads :func:`read_manifest`, and it must keep
  working where the checkpoint library is what broke.

:class:`~ddl25spring_tpu_torch.ft.autosave.AutoSaver` writes the manifest;
its module docstring says what it records and when a step becomes durable.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

MANIFEST_BASENAME = "manifest.json"


def write_manifest(directory: str | os.PathLike, doc: dict) -> str:
    """Atomically write ``manifest.json`` (temp + rename; pid and thread id in
    the temp name: the shutdown hook and the main loop may race)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / MANIFEST_BASENAME
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return str(path)


def read_manifest(directory: str | os.PathLike) -> dict | None:
    """Read ``manifest.json``; None when absent or unreadable (a truncated
    manifest must degrade to the directory scan, not kill the resume)."""
    path = Path(directory) / MANIFEST_BASENAME
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def latest_durable_step(directory: str | os.PathLike) -> int | None:
    """The newest COMMITTED checkpoint step, by directory scan alone.

    :class:`~ddl25spring_tpu_torch.utils.checkpoint.Checkpointer` writes a
    step into ``<step>.tmp-*`` and commits it by renaming that directory to
    the bare ``<step>``, so a digit-named directory IS a durable step and an
    interrupted save is invisible."""
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = [int(p.name) for p in d.iterdir() if p.is_dir() and p.name.isdigit()]
    return max(steps) if steps else None
