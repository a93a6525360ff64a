"""Retrace-hazard detector: fingerprint-unstable captures, found statically
(``repro/analysis/retrace.py``).

The executor's cache keys on ``plan_fingerprint``, which hashes, beside
the structural components, the generated code of every graph and the
bytes of every tensor constant (``runtime/executor.py:fingerprint_parts``).
That keeps the cache sound (two plans with different baked-in values do
not share an executable), and it is also what makes a per-round value
captured by the trace re-trace and re-capture every round.

A traced graph holds values in two ways. A tensor the program closes over
is a *captured* constant (a ``get_attr`` node read directly). A tensor the
program makes from a literal (``torch.tensor(0.5)``) is a ``get_attr``
read only by ``lift_fresh_copy``, and a Python number is written into the
graph's code: both are the program's literals, as the reference's
``Literal`` atoms are, and are not flagged. This pass walks the captured
constants of a plan and of all its sub-plans and flags:

* ``retrace/unstable-const`` (warning): a captured constant of at most one
  element, the classic round counter or learning rate. If it varies per
  round, every round misses the cache; pass it as a plan input instead;
* ``retrace/large-const`` (info): a tensor constant above 1 MiB, hashed on
  every compile and baked into the executable.
* ``retrace/mesh-keyed-leg`` (warning, needs ``donate_argnums``): a
  donated plan spanning two or more replica placement levels. Its
  executable is keyed by a mesh (``runtime.executor._mesh_key``) that an
  elastic event resizes, and donated inputs cannot be replayed on the new
  mesh: split the round so that only the small cross-pod leg is donated
  (``runtime.elastic.make_elastic_hierarchical_round``). Only replica
  levels count (``plan.placement_kinds``): an elastic event does not
  resize a stage level.

:func:`explain_fingerprint_mismatch` is the differential half: given two
plans that should share an executable and do not, it names the component
that differs, the constant whose value changed, or the line of generated
code that holds a changed number.

Reference codes that cannot arise here:

=============================  ==========================================
reference code                 why it cannot arise here
=============================  ==========================================
``retrace/object-const``       a torch tensor has no object dtype, and a
                               graph's other attributes are its sub-graphs,
                               hashed by their code
``retrace/weak-type-input``    torch has no weak types: a Python number is
                               a constant of the code, not an input
=============================  ==========================================
"""

from __future__ import annotations

import difflib
from typing import List

import torch

from ..core import interpreter as interp
from .findings import Finding

NOT_PORTED = ("retrace/object-const", "retrace/weak-type-input")

_LARGE_CONST_BYTES = 1 << 20
_LIFT = "lift_fresh_copy"


def _captured(node) -> bool:
    """Is this constant read as a value the program closed over (and not
    only lifted, as a literal the program wrote)?"""
    return any(interp._op_name(u) != _LIFT for u in node.users)


def analyze_retrace(plan, donate_argnums=()) -> List[Finding]:
    findings: List[Finding] = []
    n_replica_levels = sum(1 for k in plan.placement_kinds if k != "stages")
    if donate_argnums and n_replica_levels >= 2:
        findings.append(Finding(
            "retrace/mesh-keyed-leg", "warning",
            f"plan donates argnums {tuple(donate_argnums)} but spans "
            f"{n_replica_levels} replica placement levels: its executable "
            "is keyed by a mesh that elastic events (pod dropout/regrowth) "
            "can change, and donated buffers cannot be replayed on the new "
            "mesh; split the round so only the cross-pod leg is donated "
            "(see runtime.elastic.make_elastic_hierarchical_round)",
        ))
    for pi, p in enumerate(interp._all_plans(plan)):
        where = "top-level plan" if pi == 0 else f"sub-plan {pi}"
        for ci, (node, val) in enumerate(p.const_env().items()):
            dt = interp._DTYPES.get(val.dtype, str(val.dtype))
            label = (f"const {ci} ({node.target}) of the {where} "
                     f"({dt}{list(val.shape)})")
            nbytes = val.numel() * val.element_size()
            if val.numel() <= 1 and _captured(node):
                shown = (val.reshape(-1)[0].item() if val.numel()
                         else "<empty>")
                findings.append(Finding(
                    "retrace/unstable-const", "warning",
                    f"{label} is a captured scalar (value {shown}): "
                    "plan_fingerprint hashes constant VALUES, so if it "
                    "varies per call every call misses the executable "
                    "cache and retraces; pass it as a plan input instead",
                ))
            elif nbytes > _LARGE_CONST_BYTES:
                findings.append(Finding(
                    "retrace/large-const", "info",
                    f"{label} is {nbytes} bytes: fingerprinting hashes it "
                    "on every compile and the value is baked into the "
                    "executable; consider passing it as a plan input",
                ))
    return findings


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def explain_fingerprint_mismatch(plan_a, plan_b) -> List[str]:
    """Why do two plans not share an executable? One line per difference.

    Compares the components ``plan_fingerprint`` hashes
    (``runtime.executor.fingerprint_parts``), names the line of generated
    code where the graphs differ (a number written into the code), and
    compares the constants pairwise, so a fingerprint-unstable capture is
    named precisely. Returns ``[]`` iff the fingerprints are equal."""
    from ..runtime import executor  # lazy: no analysis -> runtime cycle

    parts_a = dict(executor.fingerprint_parts(plan_a))
    parts_b = dict(executor.fingerprint_parts(plan_b))
    diffs: List[str] = []
    for k in parts_a:
        if k.startswith("const[") or parts_a.get(k) == parts_b.get(k):
            continue
        if k == "graph":
            lines = [ln for ln in difflib.unified_diff(
                parts_a[k].decode().splitlines(),
                parts_b[k].decode().splitlines(), lineterm="", n=0)
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
            shown = "; ".join(ln.strip() for ln in lines[:2])
            diffs.append(f"component 'graph' differs: {shown}: a number "
                         "written into the program changed")
        else:
            diffs.append(f"component {k!r} differs")
    consts_a = [v for _, v in interp._const_table(plan_a)]
    consts_b = [v for _, v in interp._const_table(plan_b)]
    if len(consts_a) != len(consts_b):
        diffs.append(f"captured const count differs: {len(consts_a)} vs "
                     f"{len(consts_b)}")
    for i, (va, vb) in enumerate(zip(consts_a, consts_b)):
        if va.shape != vb.shape or va.dtype != vb.dtype:
            diffs.append(f"const[{i}] differs in shape or dtype: "
                         f"{va.dtype}{list(va.shape)} vs "
                         f"{vb.dtype}{list(vb.shape)}")
        elif not torch.equal(_bytes(va), _bytes(vb)):
            label = f"const[{i}] ({str(va.dtype).replace('torch.', '')}" \
                    f"{list(va.shape)})"
            if va.numel() <= 4:
                diffs.append(
                    f"{label} VALUE differs: {va.tolist()} vs {vb.tolist()}"
                    ": a fingerprint-unstable capture; pass it as a plan "
                    "input")
            else:
                diffs.append(f"{label} value bytes differ: a "
                             "fingerprint-unstable capture")
    return diffs
