"""Communication-cost pass: per-stage wire bytes read off the plan IR
(``repro/analysis/commcost.py``).

For every Broadcast/Reduce stage the pass derives, from its node's operand
and output shapes and its placement arguments:

* the **link**: the addressed stack index splits the fabric; level 0 (the
  outermost, e.g. ``pods``) crosses the slow DCN leg, deeper levels ride
  ICI within a pod;
* the **endpoints**: a reduce at index i collects from ``prod(shape[:i+1])``
  groups, a broadcast at index i fans out to ``prod(shape[:i+1])``
  destinations;
* the **per-endpoint payload** in its wire format: a reduce tagged
  ``compress="int8"`` (the fused reduce+compress, K3b) marks its output as
  int8 on the wire, so the next comm stage over that value costs one byte
  per value plus one f32 scale per ``INT8_BLOCK`` (``PACK_COLS``, 256)
  values, the packed rows ``ops.reduce_compress`` (K3a) ships, instead of
  the f32 bytes. (The unfused roundtrip materializes f32 in the IR, so its
  cost is f32 here: compression the IR cannot see, a static pass cannot
  count.)

A Transfer stage (a pipeline's neighbour exchange) rides ICI wherever
its stage level sits in the stack: each stage ships its slot to its
neighbour, the ``|shift|`` boundary stages of each outer group send
nothing unless ``wrap`` (a ring keeps every stage sending), and the
payload is the native bytes of one stage's slot.

A loop stage multiplies its body's (and a ``while`` predicate's) costs by
its trip count; a ``while`` counts one trip and gives
``commcost/unknown-trip``. A cond stage adds its most expensive branch to
the totals (a static upper bound); every branch's stages are itemized, the
others with ``counted=False``.

:func:`cross_validate` holds the model against what the plan's
communication really carries: it runs the plan once (``run_plan``) and
measures, each time a Broadcast, Reduce or Transfer stage runs, the
slices of the value that crosses its link, one per endpoint of the op's own group
stack, in the wire format (an int8-tagged value packed by the wire's own
kernel, K1a). Each stage's measured bytes a run must equal its modeled
``endpoints x payload``, and its number of runs its trip multiplier.
``model_scale`` exists for fault injection: any scale but 1.0 must
produce a mismatch finding.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.fx as fx

from ..compression import PACK_COLS
from ..core import interpreter as interp
from ..core import primitives as prims
from ..core.interpreter import Broadcast, CondStage, LoopStage, Reduce, Transfer
from .findings import Finding

# One f32 scale per this many int8 values: the packed rows' width.
INT8_BLOCK = PACK_COLS


def int8_wire_payload(values: int, block: int = INT8_BLOCK) -> float:
    """Wire bytes of ``values`` f32 numbers in the packed int8 format."""
    return values * 1.0 + math.ceil(values / block) * 4.0


@dataclasses.dataclass
class CommStageCost:
    stage: str  # named_stages anchor
    kind: str  # BROADCAST | REDUCE | TRANSFER
    op: str  # broadcast | reduce_sum | reduce_mean | reduce_max | stage_transfer
    placement: str  # addressed placement name
    link: str  # "dcn" (outermost level) | "ici" (inner levels)
    endpoints: int  # senders (reduce) / receivers (broadcast)
    payload_bytes: float  # per-endpoint wire payload
    wire_format: str  # "native" | "int8+scales"
    multiplier: float  # loop-trip multiplier applied
    wire_bytes: float  # endpoints * payload * multiplier
    counted: bool = True  # False: a non-max cond branch (itemized only)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CommCostReport:
    per_stage: List[CommStageCost]
    dcn_bytes: float
    ici_bytes: float
    unknown_trips: bool
    findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return self.dcn_bytes + self.ici_bytes

    def to_dict(self) -> Dict[str, Any]:
        return {
            "dcn_bytes": self.dcn_bytes,
            "ici_bytes": self.ici_bytes,
            "total_bytes": self.total_bytes,
            "unknown_trips": self.unknown_trips,
            "per_stage": [c.to_dict() for c in self.per_stage],
        }


def _nbytes(val: torch.Tensor, start: int = 0) -> Tuple[int, float]:
    """(element count, native bytes) of ``val.shape[start:]``."""
    values = math.prod(val.shape[start:])
    return values, float(values * val.element_size())


def estimate_comm_cost(plan) -> CommCostReport:
    """Static per-stage wire bytes for a plan (recursive, trip-multiplied)."""
    per_stage: List[CommStageCost] = []
    findings: List[Finding] = []
    state = {"unknown": False}
    dcn, ici = _walk(plan, "", 1.0, True, per_stage, findings, state)
    return CommCostReport(per_stage=per_stage, dcn_bytes=dcn, ici_bytes=ici,
                          unknown_trips=state["unknown"], findings=findings)


def _walk(plan, prefix: str, mult: float, counted: bool,
          per_stage: List[CommStageCost], findings: List[Finding],
          state) -> Tuple[float, float]:
    dcn = ici = 0.0
    # Wire format of values within THIS plan: outputs of int8-tagged
    # reduces are int8+scales until local compute touches them again.
    fmt: Dict[fx.Node, str] = {}
    for idx, stage in enumerate(plan.stages):
        sname = f"stage_{prefix}{idx}"
        if isinstance(stage, (Broadcast, Reduce, Transfer)):
            cost = _comm_cost(stage, sname, mult, counted, fmt)
            per_stage.append(cost)
            if cost.counted:
                if cost.link == "dcn":
                    dcn += cost.wire_bytes
                else:
                    ici += cost.wire_bytes
        elif isinstance(stage, LoopStage):
            if stage.trip_count is None:
                state["unknown"] = True
                findings.append(Finding(
                    "commcost/unknown-trip", "info",
                    "while-loop trip count is data-dependent; its body and "
                    "predicate are counted once (scale externally by the "
                    "expected iteration count)",
                    stage=sname,
                ))
                m2 = mult
            else:
                m2 = mult * stage.trip_count
            subs = [(stage.cond_plan, f"{prefix}{idx}_c_"),
                    (stage.body_plan, f"{prefix}{idx}_")]
            for sub, pre in subs:
                if sub is not None:
                    d, i = _walk(sub, pre, m2, counted, per_stage, findings,
                                 state)
                    dcn += d
                    ici += i
        elif isinstance(stage, CondStage):
            totals, marks = [], []
            for b, bp in enumerate(stage.branch_plans):
                start = len(per_stage)
                totals.append(_walk(bp, f"{prefix}{idx}_b{b}_", mult,
                                    counted, per_stage, findings, state))
                marks.append((start, len(per_stage)))
            if totals:
                best = max(range(len(totals)), key=lambda b: sum(totals[b]))
                dcn += totals[best][0]
                ici += totals[best][1]
                for b, (lo, hi) in enumerate(marks):
                    if b != best:
                        for c in per_stage[lo:hi]:
                            c.counted = False
    return dcn, ici


def _comm_cost(stage, sname: str, mult: float, counted: bool,
               fmt) -> CommStageCost:
    node = stage.node
    _, i = interp._node_placement(node)
    operand = node.args[0]
    if isinstance(stage, Transfer):
        val = interp._val(operand)
        endpoints = math.prod(val.shape[:i]) * _senders(
            val.shape[i], stage.shift, stage.wrap)
        _, native = _nbytes(val, i + 1)
        return CommStageCost(
            stage=sname, kind="TRANSFER", op="stage_transfer",
            placement=stage.placement, link="ici", endpoints=endpoints,
            payload_bytes=native, wire_format="native", multiplier=mult,
            wire_bytes=endpoints * native * mult, counted=counted)
    if isinstance(stage, Reduce):
        val = interp._val(operand)
        if stage.compress == "int8":
            fmt[node] = "int8+scales"
        kind, op = "REDUCE", stage.op
    else:
        val = interp._val(node)
        kind, op = "BROADCAST", "broadcast"
    endpoints = math.prod(val.shape[:i + 1])
    values, native = _nbytes(val, i + 1)
    wire_format = fmt.get(operand, "native")
    payload = (int8_wire_payload(values) if wire_format == "int8+scales"
               else native)
    return CommStageCost(
        stage=sname, kind=kind, op=op, placement=stage.placement,
        link="dcn" if i == 0 else "ici", endpoints=endpoints,
        payload_bytes=payload, wire_format=wire_format, multiplier=mult,
        wire_bytes=endpoints * payload * mult, counted=counted)


def _senders(size: int, shift: int, wrap: bool) -> int:
    """Stages of one outer group that send in a transfer: all of them in a
    ring, else those whose destination ``j + shift`` is a stage."""
    return size if wrap else max(size - min(abs(shift), size), 0)


def _contexts(plan, under_cond: bool, under_while: bool, out) -> None:
    """For each stage at any depth: (under a cond branch, under a while)."""
    for stage in plan.stages:
        out[id(stage)] = (under_cond, under_while)
        if isinstance(stage, LoopStage):
            w = under_while or stage.loop_kind == "while"
            for sub in (stage.cond_plan, stage.body_plan):
                if sub is not None:
                    _contexts(sub, under_cond, w, out)
        elif isinstance(stage, CondStage):
            for bp in stage.branch_plans:
                _contexts(bp, True, under_while, out)


def _wire_bytes(stage, operand, out, int8: bool) -> Tuple[int, float]:
    """(endpoints, bytes) that one run of a comm stage put on its link:
    the value that crosses it (a reduce's operand, each sender's slice; a
    broadcast's output, each receiver's copy) cut into one slice per
    group of the op's stack up to its addressed level (a transfer: the
    slices of its operand that leave their stage); an int8-tagged
    value is packed slice by slice by K1a, its int8 values and f32 scales
    counted."""
    from ..kernels import ops

    stack = prims.parse_stack(stage.node.args[1])
    level = int(stage.node.args[2])
    if isinstance(stage, Transfer):
        # The slices that leave their stage: stage j of each outer group
        # sends when j + shift lands on a stage (always, in a ring).
        size = operand.shape[level]
        sent = [j for j in range(size)
                if stage.wrap or 0 <= j + stage.shift < size]
        outer = tuple(operand.shape[:level])
        total = 0.0
        for idx in itertools.product(*(range(g) for g in outer)):
            for j in sent:
                part = operand[idx + (j,)]
                total += part.numel() * part.element_size()
        return math.prod(outer) * len(sent), total
    groups = tuple(size for _, size in stack[:level + 1])
    value = operand if isinstance(stage, Reduce) else out
    if tuple(value.shape[:len(groups)]) != groups:
        raise ValueError(f"a value of shape {tuple(value.shape)} crossed a "
                         f"link to the groups {groups}")
    total = 0.0
    for idx in itertools.product(*(range(g) for g in groups)):
        part = value[idx]
        if not int8:
            total += part.numel() * part.element_size()
            continue
        rows = part.reshape(-1).float()
        if rows.numel() % INT8_BLOCK:
            rows = torch.nn.functional.pad(rows,
                                           (0, -rows.numel() % INT8_BLOCK))
        q, scales = ops.quantize(rows.reshape(-1, INT8_BLOCK))
        total += (q.numel() * q.element_size()
                  + scales.numel() * scales.element_size())
    return math.prod(groups), total


def cross_validate(plan, args=None, *, device: str = "cuda",
                   tol: float = 0.0, model_scale: float = 1.0
                   ) -> List[Finding]:
    """Hold the modeled bytes to what the plan's communication carries.

    The plan runs once on ``args`` (its flat inputs; zeros of their
    shapes and dtypes on ``device`` when None, which a plan holding a
    ``while`` refuses: zeros may never end it). Each run of a Broadcast,
    Reduce or Transfer stage is measured by :func:`_wire_bytes`. A stage
    fails when a run's measured bytes differ from its modeled ``endpoints
    x payload`` (times ``model_scale``) by more than ``tol``, when its
    endpoints differ, or when it ran another number of times than its trip
    multiplier: fewer under a cond is allowed, and a ``while`` sets no
    count. ``tol`` is 0 by default: both sides count bytes exactly, and
    the f32 scales are 1.6% of an int8 payload. ``model_scale``
    multiplies the modeled side; anything but 1.0 is fault injection for
    testing the check itself. Emits
    ``commcost/model-mismatch`` (error) per failing stage."""
    if args is None:
        if any(isinstance(s, LoopStage) and s.loop_kind == "while"
               for p in interp._all_plans(plan) for s in p.stages):
            raise ValueError("cross_validate: a plan with a while loop "
                             "needs its args")
        args = [torch.zeros(v.meta["val"].shape, dtype=v.meta["val"].dtype,
                            device=device) for v in plan.invars]
    cost = estimate_comm_cost(plan)
    stages = {n: s for n, s, _ in plan.named_stages()}
    names = {id(s): n for n, s in stages.items()}
    contexts: Dict[int, Tuple[bool, bool]] = {}
    _contexts(plan, False, False, contexts)
    # The values an int8-fused reduce returned (kept, so no id is reused):
    # on the wire in int8 when a comm stage reads them next.
    int8_values: Dict[int, Any] = {}
    runs: Dict[str, List[Tuple[int, float]]] = {}

    def observe(stage, operand, out):
        runs.setdefault(names[id(stage)], []).append(_wire_bytes(
            stage, operand, out, id(operand) in int8_values))
        if isinstance(stage, Reduce) and stage.compress == "int8":
            int8_values[id(out)] = out

    with torch.no_grad():
        interp.run_plan(plan, *args, observe=observe)
    findings: List[Finding] = []
    for c in cost.per_stage:
        seen = runs.get(c.stage, [])
        under_cond, under_while = contexts[id(stages[c.stage])]
        modeled = c.payload_bytes * c.endpoints * model_scale
        problems = []
        if not under_while and (len(seen) > c.multiplier or (
                not under_cond and len(seen) != c.multiplier)):
            problems.append(f"ran {len(seen)} times, modeled "
                            f"{c.multiplier:g}")
        for endpoints, measured in seen:
            rel = abs(modeled - measured) / max(measured, 1.0)
            if endpoints != c.endpoints or rel > tol:
                problems.append(
                    f"modeled {c.endpoints} endpoints, {modeled:.0f} bytes "
                    f"a run vs {endpoints} endpoints, {measured:.0f} bytes "
                    f"carried ({rel * 100:.1f}% off, tolerance "
                    f"{tol * 100:.0f}%)")
                break
        if problems:
            findings.append(Finding(
                "commcost/model-mismatch", "error",
                f"{c.op}@{c.placement} ({c.wire_format}): "
                + "; ".join(problems),
                stage=c.stage,
            ))
    return findings
