"""Structured metrics logger: append-only JSONL with a run-metadata header.

One line per record, flushed as written, so a killed run keeps everything
logged up to the kill.  The first line is a ``header`` record carrying the
run's identity (grid shape, layout, git sha, torch and CUDA versions, the
card's name and power limit); every later line is a ``step`` (or custom)
record:

    {"record": "header", "run_id": ..., "mesh": {"data": 2, "stage": 2},
     "layout": "dppp", "git_sha": "...", "torch_version": "...", ...}
    {"record": "step", "step": 0, "wall_s": 0.0312, "samples": 1024,
     "loss": 2.31, ...}

The same file format as the JAX package's, so its report tools read
either package's run directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Iterator


def git_sha(cwd: str | None = None) -> str | None:
    """Best-effort HEAD sha (None outside a repo / without git)."""
    try:
        r = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=10,
        )
        sha = r.stdout.strip()
        return sha if r.returncode == 0 and sha else None
    except Exception:
        return None


def _card() -> dict[str, Any] | None:
    """The first card's name and power limit as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit``), or None without one."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except Exception:
        return None
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines:
        return None
    name, _, limit = lines[0].rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def run_metadata(
    mesh: Any = None, layout: str | None = None, **extra: Any
) -> dict[str, Any]:
    """The header payload: everything needed to interpret the run later.

    ``mesh`` may be the port's :class:`~ddl25spring_tpu_torch.utils.mesh.
    Mesh` (its grid's axes and sizes, the rank and its coordinates are
    recorded) or a plain dict.  ``extra`` lands verbatim (batch size,
    flops_per_step, scan_steps, ...).
    """
    import torch

    shape, rank = None, None
    if mesh is not None:
        grid = getattr(mesh, "grid", None)
        if grid is not None:
            shape = dict(zip(grid.names, grid.shape))
            rank = {"rank": mesh.rank, "coords": list(mesh.coords)}
        else:
            shape = dict(mesh)
    device = None
    if torch.cuda.is_available():
        device = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "card": _card(),
        }
    return {
        "record": "header",
        "time_unix_s": time.time(),
        "mesh": shape,
        "rank": rank,
        "layout": layout,
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device,
        **extra,
    }


class MetricsLogger:
    """Append-only JSONL writer for one run directory.

    ``MetricsLogger(run_dir, meta=run_metadata(...))`` writes the header
    immediately; ``log(step=..., wall_s=..., ...)`` appends one ``step``
    record per call.  Values that are 0-dim tensors or numpy scalars are
    coerced to Python floats so the lines stay plain JSON.

    Passing ``meta`` marks a FRESH run: any previous ``metrics.jsonl`` in
    the directory is truncated, so re-running into a fixed run dir (e.g.
    a lab's default) never pools two runs' step records into one
    summary.  ``meta=None`` reopens in append mode — the
    crash-resume path, where the earlier records are the point.
    """

    def __init__(
        self,
        run_dir: str,
        meta: dict[str, Any] | None = None,
        filename: str = "metrics.jsonl",
    ):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        # long-lived handle, closed in close()/__exit__ — not a with-block
        self._f = open(  # noqa: SIM115
            self.path, "w" if meta is not None else "a"
        )
        self._n = 0
        if meta is not None:
            self._write(dict(meta, record=meta.get("record", "header")))

    @staticmethod
    def _coerce(v: Any) -> Any:
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, dict):
            return {k: MetricsLogger._coerce(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [MetricsLogger._coerce(x) for x in v]
        try:  # 0-dim tensor / numpy scalar
            return float(v)
        except Exception:
            return repr(v)

    def _write(self, rec: dict[str, Any]) -> None:
        self._f.write(json.dumps(self._coerce(rec)) + "\n")
        self._f.flush()
        self._n += 1

    def log(self, record: str = "step", **fields: Any) -> None:
        self._write({"record": record, **fields})

    @property
    def lines_written(self) -> int:
        return self._n

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list[dict[str, Any]]:
    """Load every record of a JSONL file (skipping blank lines)."""
    return list(iter_jsonl(path))


def iter_jsonl(path: str) -> Iterator[dict[str, Any]]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)
