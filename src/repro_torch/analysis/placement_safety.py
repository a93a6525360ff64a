"""Placement-safety verifier: the full static pass behind ``check_locality``
(``repro/analysis/placement_safety.py``).

``plan.check_locality()`` asserts one invariant (no communication op
hidden inside a LocalCompute stage). This pass re-propagates the placement
lattice over the *whole* plan (every stage, at every nesting depth,
``CondStage`` branches and a ``while``'s predicate ``cond_plan`` included)
and verifies:

* **comm-free local stages** (the ``check_locality`` invariant, reported as
  a finding instead of an assertion, so one run surfaces every violation);
* **lattice monotonicity**: a Broadcast moves its operand exactly one level
  *down* the placement stack (depth i -> i+1) and a Reduce exactly one level
  *up* (depth i+1 -> i); re-broadcasting a level a value already carries,
  or reducing an outer level of a deeper value, leaves the stack-prefix
  lattice and is an error (``build_plan`` raises on these at construction;
  the pass re-derives them so edited plans are covered);
* **broadcast/reduce placement pairing**: ``Broadcast.source`` /
  ``Reduce.dest`` must name the addressed level's parent (``"server"`` at
  the outermost level). MapReduce AD transposes a broadcast into a reduce
  *at the same level* and vice versa, so a mispaired stage would transpose
  into communication on the wrong link;
* **placement-kind agreement** (``placement/wrong-kind-comm``): a
  broadcast or reduce may address only a replica-kind level and a stage
  transfer only a stage-kind level, read off the node's own stack
  argument. The primitives refuse these when called and when traced, so a
  violation means the plan was edited; a ``Transfer`` also gets the
  operand-depth check (``placement/transfer-operand``) and the tag
  pairing of the other comm stages (its transpose is the reverse transfer
  at the same level);
* **local-stage kind** (``placement/local-kind-mismatch``): a node whose
  inputs join to a group placement sits in a ``GROUP_COMPUTE`` stage, a
  server-placed one in a ``SERVER_COMPUTE`` stage; one finding per stage,
  naming the first such node and their count (the reference reports each
  eqn, but a map that is one eqn there is a ``map_groups`` node and its
  ``getitem`` here). Nodes of constants only are exempt: ``build_plan``
  moves them into the stage of their first consumer (as the reference's
  literals need no stage), so a group stage holds them by design;
* **loop-carry stability**: a loop carry's body-output placement may not
  sit deeper on the lattice than its body-input placement (``build_plan``
  solves carries to a fixed point; instability means the plan was edited
  after construction);
* a ``while`` predicate that does not land at the server (the driver owns
  control flow; a partitioned predicate cannot steer it), and ``while``
  operands placed deeper than the body expects.

The flat-API ``hierarchical_reduce_mean`` regroups ``(n, ...)`` to ``(P,
n/P, ...)`` and its ``drjax`` nodes address a derived two-level stack whose
names differ from the plan's. At that boundary the operand-depth checks
carry no information (the lattice chains are incomparable by
construction), so the pass reports one ``placement/regroup-boundary`` info
finding per plan and propagates placements as ``build_plan`` does.
"""

from __future__ import annotations

from typing import Dict, List

import torch.fx as fx

from ..core import interpreter as interp
from ..core import primitives as prims
from ..core.interpreter import (
    Broadcast,
    CondStage,
    LocalCompute,
    LoopStage,
    PlacementSet,
    Reduce,
    Transfer,
)
from .findings import Finding

# Codes of the reference's pass that cannot arise in the port; the parity
# tests leave them out of the reference's side. Every code is ported.
NOT_PORTED = ()


def check_placement_safety(plan) -> List[Finding]:
    """Run the placement-safety pass over ``plan`` and all sub-plans."""
    findings: List[Finding] = []
    _check_plan(plan, "", findings)
    return findings


def _join_all(pls) -> PlacementSet:
    p: PlacementSet = ()
    for q in pls:
        p = interp._join(p, q)
    return p


def _tag(pl: PlacementSet) -> str:
    return "/".join(pl) or "server"


def _node_kind(node) -> str:
    """Kind of the level a comm node addresses, from its own stack
    argument (which also covers a derived stack)."""
    return prims.parse_placements(node.args[1])[int(node.args[2])].kind


def _wrong_kind(stage, node, enames, i, sname) -> List[Finding]:
    expect = "stages" if isinstance(stage, Transfer) else "replicas"
    if _node_kind(node) == expect:
        return []
    if isinstance(stage, Transfer):
        what = (f"stage_transfer@{enames[i]} addresses a replica-kind "
                "level: replicas communicate by broadcast/reduce, not "
                "neighbour transfer")
    else:
        op = "broadcast" if isinstance(stage, Broadcast) else stage.op
        what = (f"{op}@{enames[i]} addresses a stage-kind level: pipeline "
                "stages communicate by stage_transfer, not broadcast/reduce")
    return [Finding("placement/wrong-kind-comm", "error", what, stage=sname)]


def _check_plan(plan, prefix: str, findings: List[Finding]) -> None:
    names = tuple(n for n, _ in plan.placements)
    env: Dict[fx.Node, PlacementSet] = dict(zip(plan.invars,
                                                plan.invar_placements))

    def pl(a) -> PlacementSet:
        return env.get(a, ()) if isinstance(a, fx.Node) else ()

    regroup = [False]

    def boundary(enames, sname):
        if not regroup[0]:
            regroup[0] = True
            findings.append(Finding(
                "placement/regroup-boundary", "info",
                f"comm nodes address a derived stack {'/'.join(enames)} "
                f"inside a {'/'.join(names) or 'server'} plan (flat-API "
                "hierarchical regroup); operand-depth checks are relaxed at "
                "this boundary",
                stage=sname,
            ))

    constant: set = set()  # nodes computed from constants only
    for idx, stage in enumerate(plan.stages):
        sname = f"stage_{prefix}{idx}"
        if isinstance(stage, LocalCompute):
            misplaced = []
            for node in stage.nodes:
                name = interp._comm_name(node)
                if name is not None or any(
                        interp._contains_comm(g)
                        for g in interp._subgraphs(node, plan.gm)):
                    findings.append(Finding(
                        "placement/comm-in-local", "error",
                        f"communication ({name or interp._op_name(node)}) "
                        f"inside a {stage.kind} stage: this control flow is "
                        "not staged as explicit MapReduce communication",
                        stage=sname,
                    ))
                env[node] = _join_all(pl(a) for a in node.all_input_nodes)
                if all(interp._is_const_attr(a) or a in constant
                       for a in node.all_input_nodes):
                    constant.add(node)
                elif stage.at_groups != bool(env[node]):
                    misplaced.append(node)
            if misplaced:
                node = misplaced[0]
                findings.append(Finding(
                    "placement/local-kind-mismatch", "warning",
                    f"node {node.name} ({interp._op_name(node)}) joins to "
                    f"lattice depth {len(env[node])} but sits in a "
                    f"{stage.kind} stage ({len(misplaced)} such node(s))",
                    stage=sname,
                ))
        elif isinstance(stage, Transfer):
            node = stage.node
            enames, i = interp._node_placement(node)
            in_pl = pl(node.args[0])
            findings.extend(_wrong_kind(stage, node, enames, i, sname))
            if enames == names and in_pl != enames[:i + 1]:
                findings.append(Finding(
                    "placement/transfer-operand", "warning",
                    f"stage_transfer@{enames[i]} expects its operand at "
                    f"{_tag(enames[:i + 1])}, lattice says {_tag(in_pl)}",
                    stage=sname,
                ))
            if stage.placement != enames[i]:
                findings.append(Finding(
                    "placement/pairing", "error",
                    f"Transfer stage tagged @{stage.placement} but its node "
                    f"addresses level {enames[i]}; the transpose would emit "
                    "the reverse transfer at the wrong level",
                    stage=sname,
                ))
            env[node] = enames[:i + 1]
        elif isinstance(stage, Broadcast):
            node = stage.node
            enames, i = interp._node_placement(node)
            in_pl = pl(node.args[0])
            findings.extend(_wrong_kind(stage, node, enames, i, sname))
            if enames != names:
                boundary(enames, sname)
            elif len(in_pl) > i and in_pl[:i + 1] == enames[:i + 1]:
                findings.append(Finding(
                    "placement/rebroadcast", "error",
                    f"broadcast@{enames[i]} of a value already placed at "
                    f"{_tag(in_pl)}: duplicates a level the value carries, "
                    "leaving the prefix lattice",
                    stage=sname,
                ))
            elif in_pl != enames[:i]:
                findings.append(Finding(
                    "placement/broadcast-operand", "warning",
                    f"broadcast@{enames[i]} expects its operand at "
                    f"{_tag(enames[:i])}, lattice says {_tag(in_pl)}",
                    stage=sname,
                ))
            expected = "server" if i == 0 else enames[i - 1]
            if stage.placement != enames[i] or stage.source != expected:
                findings.append(Finding(
                    "placement/pairing", "error",
                    f"Broadcast stage tagged {stage.source}->"
                    f"{stage.placement} but its node addresses level "
                    f"{enames[i]} (parent {expected}); the AD transpose "
                    "would emit a reduce at the wrong level",
                    stage=sname,
                ))
            env[node] = enames[:i + 1]
        elif isinstance(stage, Reduce):
            node = stage.node
            enames, i = interp._node_placement(node)
            in_pl = pl(node.args[0])
            findings.extend(_wrong_kind(stage, node, enames, i, sname))
            if enames != names:
                boundary(enames, sname)
            elif len(in_pl) > i + 1 and in_pl[:i + 1] == enames[:i + 1]:
                findings.append(Finding(
                    "placement/outer-reduce", "error",
                    f"{stage.op}@{enames[i]} reduces an outer level of a "
                    f"value placed at {_tag(in_pl)}: the result (inner "
                    "levels without their parent) is not a stack prefix",
                    stage=sname,
                ))
            elif in_pl != enames[:i + 1]:
                findings.append(Finding(
                    "placement/reduce-operand", "warning",
                    f"{stage.op}@{enames[i]} expects its operand at "
                    f"{_tag(enames[:i + 1])}, lattice says {_tag(in_pl)}",
                    stage=sname,
                ))
            expected = "server" if i == 0 else enames[i - 1]
            if stage.placement != enames[i] or stage.dest != expected:
                findings.append(Finding(
                    "placement/pairing", "error",
                    f"Reduce stage tagged {stage.placement}->{stage.dest} "
                    f"but its node addresses level {enames[i]} (parent "
                    f"{expected}); the AD transpose would emit a broadcast "
                    "at the wrong level",
                    stage=sname,
                ))
            env[node] = enames[:i]
        elif isinstance(stage, LoopStage):
            out_pl = _check_loop(stage, idx, prefix, pl, findings)
            for g in stage.getitems:
                env[g] = out_pl[g.args[1]]
        elif isinstance(stage, CondStage):
            for b, bp in enumerate(stage.branch_plans):
                _check_plan(bp, f"{prefix}{idx}_b{b}_", findings)
            for g in stage.getitems:
                env[g] = _join_all(bp.outvar_placements[g.args[1]]
                                   for bp in stage.branch_plans)


def _check_loop(stage, idx: int, prefix: str, pl, findings) -> list:
    """Check one loop stage and its sub-plans; returns the placements of
    the loop's outputs. Torch's loops put the carry first in the body's
    inputs and outputs."""
    sname = f"stage_{prefix}{idx}"
    body = stage.body_plan
    n_carry = len(stage.carry)
    carry_in = body.invar_placements[:n_carry]
    carry_out = body.outvar_placements[:n_carry]
    if stage.loop_kind == "scan":
        out_pl = list(carry_in) + [()] * (len(body.out_atoms) - n_carry)
    else:
        out_pl = list(carry_in)
        cond = stage.cond_plan
        if cond is not None:
            _check_plan(cond, f"{prefix}{idx}_c_", findings)
            if cond.outvar_placements[0] != ():
                findings.append(Finding(
                    "placement/while-pred-placed", "warning",
                    f"while predicate lands at "
                    f"{_tag(cond.outvar_placements[0])}, not the server: "
                    "the driver cannot steer a partitioned predicate",
                    stage=sname,
                ))
        operands = stage.carry + stage.additional
        for j, (a, exp) in enumerate(zip(operands, body.invar_placements)):
            if interp._join(pl(a), exp) != exp:
                findings.append(Finding(
                    "placement/loop-input", "warning",
                    f"while operand {j} placed at {_tag(pl(a))} but the "
                    f"body expects at most {_tag(exp)}",
                    stage=sname,
                ))
    for j, (ci, co) in enumerate(zip(carry_in, carry_out)):
        if interp._join(ci, co) != ci:
            findings.append(Finding(
                "placement/loop-carry-unstable", "error",
                f"loop carry {j} enters the body at {_tag(ci)} but exits "
                f"at {_tag(co)}: the carry climbs the lattice per iteration "
                "(build_plan's fixed point was not applied)",
                stage=sname,
            ))
    _check_plan(body, f"{prefix}{idx}_", findings)
    return out_pl
