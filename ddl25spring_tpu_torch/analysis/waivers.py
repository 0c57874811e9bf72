"""Waivers: justified exceptions to findings, kept in TOML; the counterpart
of the JAX package's ``analysis/waivers.py``.

``analysis/waivers.toml`` beside this module is the port's waiver file.
Each entry must carry a ``reason``; an entry without one is itself a
finding (W000, :func:`check_waivers`) and :func:`load_waivers` refuses it.
Schema::

    [[waiver]]
    rule = "S101"                              # required: exact rule id
    strategy = "zero3*"                        # optional fnmatch vs finding.strategy
    path = "ddl25spring_tpu_torch/ops/*.py"    # optional fnmatch vs finding.source path
    symbol = "cuda_home"                       # optional substring vs finding.op
    match = "CUDA_HOME"                        # optional substring vs finding.message
    reason = "why this is fine here"           # required

A waiver applies when every field it gives matches; a field it leaves out
matches everything.  Waived findings stay in every report, marked
``waived`` with the reason: a waiver silences the check, not the evidence.
The file is parsed by the standard library's ``tomllib`` (Python 3.11 and
later; the JAX module's fallback parser for 3.10 has no counterpart here).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass
from fnmatch import fnmatch
from typing import Any

from ddl25spring_tpu_torch.analysis.rules import Finding

DEFAULT_WAIVERS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "waivers.toml")
_KNOWN = {"rule", "reason", "strategy", "path", "symbol", "match"}


@dataclass(frozen=True)
class Waiver:
    rule: str
    reason: str
    strategy: str | None = None
    path: str | None = None
    symbol: str | None = None
    match: str | None = None

    def covers(self, f: Finding) -> bool:
        if self.rule != f.rule:
            return False
        if self.strategy is not None and not fnmatch(f.strategy or "", self.strategy):
            return False
        if self.path is not None:
            src_path = (f.source or "").rsplit(":", 1)[0]
            if not (fnmatch(src_path, self.path) or fnmatch(src_path, "*/" + self.path)):
                return False
        if self.symbol is not None and self.symbol not in (f.op or ""):
            return False
        if self.match is not None and self.match not in f.message:
            return False
        return True


def _entries(path: str) -> list[dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        return tomllib.load(f).get("waiver", [])


def check_waivers(path: str | None = None) -> list[Finding]:
    """W000 for every entry of the file without a ``rule`` or a ``reason``
    (an unexplained waiver defeats the audit trail), and for unknown keys."""
    path = path or DEFAULT_WAIVERS_PATH
    out = []
    for i, entry in enumerate(_entries(path)):
        missing = [k for k in ("rule", "reason") if not entry.get(k)]
        unknown = sorted(set(entry) - _KNOWN)
        if missing or unknown:
            out.append(Finding(
                rule="W000", severity="error", op=f"waiver #{i + 1}",
                source=f"{os.path.basename(path)}:#{i + 1}",
                message=(f"waiver #{i + 1} ({entry.get('rule', '?')})"
                         + (f" lacks {' and '.join(missing)}" if missing else "")
                         + (f" has unknown keys {unknown}" if unknown else "")),
                fix_hint="every waiver names its rule and says why the finding is fine",
            ))
    return out


def load_waivers(path: str | None = None) -> list[Waiver]:
    """The waivers of ``path`` (default: the port's ``analysis/waivers.toml``).
    A missing file is an empty set; an entry without ``rule``/``reason``, or
    with a key the schema does not know, raises ``ValueError``."""
    path = path or DEFAULT_WAIVERS_PATH
    bad = check_waivers(path)
    if bad:
        raise ValueError(f"{path}: " + "; ".join(f.message for f in bad))
    return [Waiver(**{k: e[k] for k in _KNOWN & set(e)}) for e in _entries(path)]


def apply_waivers(findings: list[Finding], waivers: list[Waiver]) -> list[Finding]:
    """Mark each finding a waiver covers (the first that matches wins); the
    findings change in place and the list is returned for chaining."""
    for f in findings:
        for w in waivers:
            if w.covers(f):
                f.waived = True
                f.waived_reason = w.reason
                break
    return findings
