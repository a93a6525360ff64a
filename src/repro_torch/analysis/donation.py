"""Donation analysis for the port's compiled plans
(``repro/analysis/donation.py``).

The port's executor (``runtime/executor.py``) donates by position: the plan
returns its carry first, and donated argument ``i`` takes output ``i`` in
place, written after the plan's last stage. Outputs that share memory
with a donated argument (an input passed through) are copied before the
first write. ``CompiledPlan`` runs this pass when it is built and raises
on its errors, before any write, so the pass reports statically exactly
what the executor would do with the same ``donate_argnums``:

* ``donation/bad-argnum`` (error): the argnum does not name a plan input;
* ``donation/unused`` (warning): a donated input that nothing reads; it
  still takes its output;
* ``donation/dropped`` (error): output ``i`` is missing, not a tensor, or
  of another shape or dtype than argument ``i``, with the why. The
  reference's XLA drops such a donation with a warning; this executor
  refuses it;
* ``donation/carry-not-eligible`` (warning): a loop carry's initial value
  is read again after the loop (or returned), so the carry cannot be
  updated in place across the loop. Checked for every loop at every depth,
  independent of ``donate_argnums``.

The reference models XLA's first-fit matching on (shape, dtype) over all
outputs; the port's executor has no such search, so neither has this pass.

Reference codes that cannot arise here:

=============================  ==========================================
reference code                 why it cannot arise here
=============================  ==========================================
``donation/use-after-donate``  the executor writes a donated argument
                               only after every stage has run, so no
                               stage can read the overwritten buffer; an
                               output that passes the argument through is
                               copied before the write
=============================  ==========================================
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.fx as fx

from ..core import interpreter as interp
from ..core.interpreter import CondStage, LoopStage
from .findings import Finding

# Codes of the reference's pass that cannot arise in the port (see the
# table above); the parity tests leave them out of the reference's side.
NOT_PORTED = ("donation/use-after-donate",)


def _val(atom):
    return atom.meta.get("val") if isinstance(atom, fx.Node) else atom


def describe(atom) -> str:
    """``f32[2,3]`` for a tensor or a node of one; a type name else."""
    v = _val(atom)
    if isinstance(v, torch.Tensor):
        dt = interp._DTYPES.get(v.dtype, str(v.dtype).replace("torch.", ""))
        return f"{dt}[{','.join(str(d) for d in v.shape)}]"
    return "no output" if atom is None else type(v).__name__


def analyze_donation(plan, donate_argnums: Sequence[int] = ()) -> List[Finding]:
    findings: List[Finding] = []
    invars = plan.invars
    outs = ", ".join(describe(a) for a in plan.out_atoms)
    for d in sorted(set(int(x) for x in donate_argnums)):
        if d < 0 or d >= len(invars):
            findings.append(Finding(
                "donation/bad-argnum", "error",
                f"donate_argnums includes {d} but the plan has only "
                f"{len(invars)} flat inputs",
            ))
            continue
        v = invars[d]
        if not v.users:
            findings.append(Finding(
                "donation/unused", "warning",
                f"donated input {d} ({describe(v)}) is never read: the "
                "donation frees nothing the program was going to keep",
            ))
        o = plan.out_atoms[d] if d < len(plan.out_atoms) else None
        vv, ov = _val(v), _val(o)
        if not (isinstance(ov, torch.Tensor) and isinstance(vv, torch.Tensor)
                and ov.shape == vv.shape and ov.dtype == vv.dtype):
            findings.append(Finding(
                "donation/dropped", "error",
                f"donated argument {d} takes output {d}, which must be a "
                f"tensor of its shape and dtype: got {describe(v)} and "
                f"{describe(o)} (outputs: [{outs}]). Return the "
                "argument's updated value at its own index, or stop "
                "donating it",
            ))
    findings.extend(_check_carries(plan))
    return findings


def _check_carries(plan) -> List[Finding]:
    """Donate-eligibility of every loop carry, at every nesting depth."""
    findings: List[Finding] = []
    _walk_carries(plan, "", findings)
    return findings


def _walk_carries(plan, prefix: str, findings: List[Finding]) -> None:
    last_read: Dict[Any, int] = {}
    for i, (_stage, reads, _outs) in enumerate(plan.stage_io()):
        for a in reads:
            last_read[a] = i
    final = {a for a in plan.out_atoms if isinstance(a, fx.Node)}
    for idx, stage in enumerate(plan.stages):
        if isinstance(stage, LoopStage):
            sname = f"stage_{prefix}{idx}"
            for j, a in enumerate(stage.carry):
                if not isinstance(a, fx.Node) or interp._is_const_attr(a):
                    continue
                reasons = []
                if last_read.get(a, -1) > idx:
                    reasons.append(
                        f"read again at stage_{prefix}{last_read[a]}")
                if a in final:
                    reasons.append("returned as a plan output")
                if reasons:
                    findings.append(Finding(
                        "donation/carry-not-eligible", "warning",
                        f"loop carry {j} init ({describe(a)}) is "
                        f"{' and '.join(reasons)}: the loop cannot update "
                        "the carry buffer in place, so every call pays a "
                        "copy of it",
                        stage=sname,
                    ))
            if stage.cond_plan is not None:
                _walk_carries(stage.cond_plan, f"{prefix}{idx}_c_", findings)
            _walk_carries(stage.body_plan, f"{prefix}{idx}_", findings)
        elif isinstance(stage, CondStage):
            for b, bp in enumerate(stage.branch_plans):
                _walk_carries(bp, f"{prefix}{idx}_b{b}_", findings)
