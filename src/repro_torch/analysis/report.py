"""Verifier report IR: findings + per-plan metrics, JSON-serializable.

A copy of ``src/repro/analysis/report.py`` (the port imports nothing of
the JAX package).  Every pass of the static analyzer — here the plan
checker (:mod:`repro_torch.analysis.plan_verifier`) — speaks in
:class:`Finding`\\ s collected into a :class:`VerifierReport`.  A
finding carries a stable machine-readable ``code`` (the defect class),
a severity, a ``where`` locating the defect inside the plan, and a
human-actionable message.  Reports serialize to JSON.

Severities:

* ``"error"``   — the plan/lowering is unsound or will fail at
  runtime; certification fails.
* ``"warning"`` — legal but suspicious (e.g. replication-rate gap far
  above the Afrati–Ullman floor); certification still succeeds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"

_SEVERITIES = (ERROR, WARNING)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect (or suspicion) detected by a verifier pass.

    code:     stable identifier of the defect class
              (e.g. ``"CAPS_UNDERSIZED"``, ``"KEY_DTYPE_NARROWED"``).
    severity: ``"error"`` or ``"warning"``.
    where:    locator inside the checked object — a hop ("hop 2"), a
              cap field ("caps.mid"), …
    message:  human-readable diagnosis *and* suggested remedy.
    """

    code: str
    severity: str
    where: str
    message: str

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class VerifierReport:
    """All findings for one verification target, plus derived metrics.

    target:   name of the verified object (bench target, plan label,
              traced lowering).
    findings: every :class:`Finding`, in detection order.
    metrics:  numeric facts the checks derived on the way — replication
              floor, chosen cost, gap, worst-case pair index … kept so
              a passing report still documents *how much* headroom the
              plan has.
    """

    target: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        """True iff no error-severity finding (warnings don't fail)."""
        return not any(f.severity == ERROR for f in self.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(f.code for f in self.findings)

    def add(self, code: str, severity: str, where: str, message: str) -> None:
        self.findings.append(Finding(code, severity, where, message))

    def extend(self, other: "VerifierReport") -> None:
        self.findings.extend(other.findings)
        for k, v in other.metrics.items():
            self.metrics.setdefault(k, v)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "target": self.target,
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "metrics": self.metrics,
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        """One status line per report, for the CLI."""
        n_err = len(self.errors)
        n_warn = len(self.findings) - n_err
        status = "OK" if self.ok else "FAIL"
        return (f"[{status}] {self.target}: {n_err} error(s), "
                f"{n_warn} warning(s)")


def reports_to_json(reports: List[VerifierReport],
                    indent: Optional[int] = 2) -> str:
    """Serialize a batch of reports as one JSON document."""
    payload = {
        "ok": all(r.ok for r in reports),
        "reports": [r.to_dict() for r in reports],
    }
    return json.dumps(payload, indent=indent, sort_keys=True)
