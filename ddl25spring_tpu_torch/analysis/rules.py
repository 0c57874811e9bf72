"""The finding record that every analysis of the port reports: the
counterpart of the record half of the JAX package's ``analysis/rules.py``
(``Finding``, ``severity_rank``, ``worst_severity``) and of
``analysis/engine.summarize``.

The source rules (S101-S103 in :mod:`~ddl25spring_tpu_torch.analysis.
source_lint`, S201-S205 in :mod:`~ddl25spring_tpu_torch.analysis.
host_safety`) emit these records, and the shared waiver file
(:mod:`~ddl25spring_tpu_torch.analysis.waivers`) marks them.  The JAX
module's hazard rules H001-H013, which read compiled XLA programs, are not
here: they wait for the port's analyzers over ``torch.profiler`` traces.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Iterable

SEVERITIES = ("info", "warn", "error")


def severity_rank(sev: str | None) -> int:
    """info < warn < error; unknown severities sort below info."""
    try:
        return SEVERITIES.index(sev)
    except ValueError:
        return -1


def worst_severity(sevs: Iterable[str]) -> str | None:
    """The highest-ranked severity in ``sevs`` (None when empty)."""
    best: str | None = None
    for s in sevs:
        if best is None or severity_rank(s) > severity_rank(best):
            best = s
    return best


@dataclass
class Finding:
    """One hazard an analysis established.

    ``op`` anchors it (the Python symbol, e.g. ``make_dp_train_step.step``);
    ``bytes`` is the payload it taxes, when byte-denominated; ``source`` a
    ``file:line``; ``fix_hint`` the one sentence a reader needs to start
    fixing.  A waiver sets ``waived`` and ``waived_reason`` instead of
    dropping the record: a waived finding stays in every report and stops
    gating the check."""

    rule: str
    severity: str
    message: str
    strategy: str | None = None
    op: str | None = None
    bytes: int | None = None
    fix_hint: str = ""
    source: str | None = None
    waived: bool = False
    waived_reason: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    def key(self) -> str:
        """The identity used in waiver bookkeeping and dedup."""
        return f"{self.rule}:{self.strategy or '-'}:{self.op or self.source or '-'}"


def summarize(findings: list[Finding | dict]) -> dict[str, Any]:
    """The counts a check reads: total, unwaived, waived, the worst
    unwaived severity and the tally per rule."""
    dicts = [f.to_dict() if isinstance(f, Finding) else f for f in findings]
    unwaived = [f for f in dicts if not f.get("waived")]
    by_rule: dict[str, int] = {}
    for f in dicts:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    return {
        "findings": len(dicts),
        "unwaived": len(unwaived),
        "waived": len(dicts) - len(unwaived),
        "worst": worst_severity(f["severity"] for f in unwaived),
        "by_rule": by_rule,
    }
