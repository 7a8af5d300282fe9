"""Typed findings for the static-analysis subsystem (DESIGN.md §16).

Every analyzer in ``repro.analysis`` reports through one record type: a
:class:`Finding` names the *rule* that fired (a stable ``family/slug`` id
from the :data:`RULES` catalog), the *site* it fired at (a human-readable
path: a candidate describe string, a spec-tree leaf, a row_map cell), a
``severity``, and free-form ``detail``.  Analyzers never raise on the code
under analysis — they return findings; only callers decide whether errors
are fatal (the CLI exits nonzero, the paged engine's debug sanitizer
raises, the tuner skips the candidate).

Severity contract:

  * ``error``   — the artifact is statically wrong: it would fail, corrupt
    state, or silently produce garbage at runtime.  Error rules must hold
    the zero-false-positive bar on everything the repo ships.
  * ``warning`` — legal but suspicious: padding waste, replication of a
    large tensor, a missed donation.  Reported, never gating.
  * ``info``    — context the analyzer wants on the record (skipped checks,
    missing introspection support).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

SEVERITIES = ("info", "warning", "error")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}

#: Rule catalog: rule id -> one-line description.  Analyzers register their
#: rules at import time via :func:`rule`; the catalog is what DESIGN.md §16
#: documents and what ``python -m repro.analysis --rules`` prints.
RULES: dict[str, str] = {}


def rule(rule_id: str, description: str) -> str:
    """Register a rule id in the catalog (idempotent) and return it."""
    if "/" not in rule_id:
        raise ValueError(f"rule id {rule_id!r} must be 'family/slug'")
    RULES[rule_id] = description
    return rule_id


@dataclass(frozen=True)
class Finding:
    """One analyzer observation: (severity, rule, site, detail)."""

    severity: str
    rule: str
    site: str
    detail: str

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.site}: {self.detail}"


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]


def warnings(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "warning"]


def max_severity(findings: list[Finding]) -> str | None:
    """Highest severity present, or None for a clean report."""
    if not findings:
        return None
    return max(findings, key=lambda f: _RANK[f.severity]).severity


def to_json(findings: list[Finding]) -> list[dict]:
    return [f.to_dict() for f in findings]


def summarize(findings: list[Finding]) -> dict[str, int]:
    out = {s: 0 for s in SEVERITIES}
    for f in findings:
        out[f.severity] += 1
    return out
