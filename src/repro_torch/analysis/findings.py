"""Finding/report types shared by every static-analysis pass
(``repro/analysis/findings.py``).

A *finding* is one diagnosed fact about a plan (or the repo, for lint
rules): a stable machine-readable ``code`` (``"<pass>/<defect>"``), a
severity, a human explanation, and an optional anchor (the
``named_stages`` name of the stage it points at).

Severities:

* ``error``: the plan violates an invariant the runtime relies on
  (communication hidden in a local stage, a donated argument read after
  the stage that overwrites it, a donation the executor refuses).
  ``AnalysisReport.ok`` is False.
* ``warning``: legal but almost certainly not what the author wants (an
  unused donation, a fingerprint-unstable capture). Does not flip
  ``ok``: the oracle programs must analyze *clean of errors*, while
  hazard heuristics stay visible.
* ``info``: structural notes (a flat-to-nested regroup boundary, a large
  constant, a loop of unknown trip count).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str  # "<pass>/<defect>", e.g. "placement/comm-in-local"
    severity: str  # error | warning | info
    message: str
    stage: Optional[str] = None  # named_stages anchor, e.g. "stage_2_b0_1"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def pass_name(self) -> str:
        return self.code.split("/", 1)[0]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        where = f" [{self.stage}]" if self.stage else ""
        return f"{self.severity}: {self.code}{where}: {self.message}"


@dataclasses.dataclass
class AnalysisReport:
    """Aggregated result of ``plan.analyze()``.

    ``findings`` holds every pass's findings in pass order;
    ``comm_cost`` is the communication-cost pass's structured output
    (:class:`repro_torch.analysis.commcost.CommCostReport`) when that
    pass ran.
    """

    findings: List[Finding] = dataclasses.field(default_factory=list)
    comm_cost: Optional[Any] = None

    @property
    def ok(self) -> bool:
        """True when no *error*-severity finding was produced."""
        return not self.errors

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def raise_if_errors(self) -> None:
        if self.errors:
            raise AssertionError(
                "plan analysis failed:\n"
                + "\n".join(f"  {f}" for f in self.errors)
            )

    def to_json(self) -> str:
        payload: Dict[str, Any] = {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
        }
        if self.comm_cost is not None:
            payload["comm_cost"] = self.comm_cost.to_dict()
        return json.dumps(payload, indent=2)

    def __str__(self) -> str:
        if not self.findings:
            return "AnalysisReport: clean"
        head = "AnalysisReport: " + (
            "OK" if self.ok else f"{len(self.errors)} error(s)"
        )
        return head + "\n" + "\n".join(f"  {f}" for f in self.findings)
