"""Static analysis for MapReduce plans and the port's lint registry
(``repro/analysis``).

Two halves:

* **Plan-IR analyses**: passes that run on a :class:`MapReducePlan`
  without executing it, surfaced as ``plan.analyze()``:

  - :func:`check_placement_safety`: the full placement-lattice pass
    (comm-free local stages at all depths, broadcast/reduce monotonicity
    and pairing, placement kinds of comm and local stages, transfer
    operands, loop-carry stability);
  - :func:`analyze_donation`: what ``compile_plan(...,
    donate_argnums=...)`` does with a donation (refused donations with
    the why, unused ones, loop-carry eligibility); ``CompiledPlan`` runs
    it and raises on its errors;
  - :func:`analyze_retrace`: fingerprint-unstable captures, a donated
    plan keyed by a mesh elastic events resize, and
    :func:`explain_fingerprint_mismatch` for two plans that should share
    an executable and do not;
  - :func:`estimate_comm_cost`: per-stage wire bytes from the IR (DCN vs
    ICI by placement level, int8 ``compress`` tags applied, stage
    transfers on ICI), with
    :func:`cross_validate_comm_cost` holding the model against the bytes
    each comm stage carries when the plan runs.

* **Lint registry**: ``repro_torch.analysis.lints`` (``python -m
  repro_torch.analysis.lints``), the port's conventions as rules with
  per-line suppression and JSON output.

The submodules load lazily (PEP 562), so ``from repro_torch.analysis
import lints`` imports no torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .findings import AnalysisReport, Finding

__all__ = [
    "AnalysisReport",
    "Finding",
    "analyze_donation",
    "analyze_plan",
    "analyze_retrace",
    "check_placement_safety",
    "cross_validate_comm_cost",
    "donation_report",
    "estimate_comm_cost",
    "explain_fingerprint_mismatch",
    "lints",
]

_LAZY = {
    "check_placement_safety": ("placement_safety", "check_placement_safety"),
    "analyze_donation": ("donation", "analyze_donation"),
    "analyze_retrace": ("retrace", "analyze_retrace"),
    "explain_fingerprint_mismatch": ("retrace", "explain_fingerprint_mismatch"),
    "estimate_comm_cost": ("commcost", "estimate_comm_cost"),
    "cross_validate_comm_cost": ("commcost", "cross_validate"),
    "lints": ("lints", None),
}

if TYPE_CHECKING:  # pragma: no cover - typing only
    from . import lints  # noqa: F401
    from .commcost import cross_validate as cross_validate_comm_cost  # noqa: F401
    from .commcost import estimate_comm_cost  # noqa: F401
    from .donation import analyze_donation  # noqa: F401
    from .placement_safety import check_placement_safety  # noqa: F401
    from .retrace import analyze_retrace  # noqa: F401
    from .retrace import explain_fingerprint_mismatch  # noqa: F401


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{entry[0]}", __name__)
    value = module if entry[1] is None else getattr(module, entry[1])
    globals()[name] = value
    return value


def analyze_plan(plan, *, donate_argnums=(), cross_validate: bool = False,
                 comm_cost: bool = True, device: str = "cuda",
                 args=None) -> AnalysisReport:
    """Run every plan-IR pass over ``plan`` and aggregate the findings.

    ``donate_argnums`` feeds the donation pass (the tuple you would hand
    ``compile_plan``). ``cross_validate=True`` also runs the plan once on
    ``args`` (zeros on ``device``, the card unless the caller asks for the
    CPU, when None) and holds the comm model to the bytes each comm stage
    carried (:func:`cross_validate_comm_cost`). The report's
    :attr:`~AnalysisReport.ok` is True iff no pass produced an *error*;
    warnings and infos are hazard heuristics and structural notes.
    """
    from . import commcost, donation, placement_safety, retrace

    report = AnalysisReport()
    report.findings.extend(placement_safety.check_placement_safety(plan))
    report.findings.extend(
        donation.analyze_donation(plan, donate_argnums=donate_argnums))
    report.findings.extend(
        retrace.analyze_retrace(plan, donate_argnums=donate_argnums))
    if comm_cost:
        cost = commcost.estimate_comm_cost(plan)
        report.comm_cost = cost
        report.findings.extend(cost.findings)
    if cross_validate:
        report.findings.extend(commcost.cross_validate(plan, args,
                                                       device=device))
    return report


def donation_report(compiled_plan) -> AnalysisReport:
    """The donation report of a ``CompiledPlan`` (its argnums applied)."""
    from . import donation

    report = AnalysisReport()
    report.findings.extend(donation.analyze_donation(
        compiled_plan.plan, donate_argnums=compiled_plan.donate_argnums))
    return report
