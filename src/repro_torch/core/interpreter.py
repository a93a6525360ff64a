"""Traced DrJAX programs -> MapReduce plans (``repro/core/interpreter.py``,
paper §5).

Because the DrJAX building blocks are registered ops, they survive into a
traced graph. This module recovers the communication structure of a
program from that graph (which values are partitioned, where broadcasts
and reductions happen) and translates it into a plan whose cross-machine
communication is explicit and whose processing in between is local: the
form that maps onto batch systems such as Apache Beam.

* :func:`trace` is the counterpart of ``jax.make_jaxpr``: ``make_fx`` in
  fake mode with the primitives recording (``primitives.recording``), so
  autograd is traced through (a gradient program shows its backward, with
  ``drjax.reduce_sum`` as the transpose of ``drjax.broadcast``), a
  ``map_fn`` is one ``map_groups`` node with its group body as a
  sub-graph, and every kernel is one ``repro`` node.
* :func:`build_plan` segments the graph into stages on the reference's
  placement lattice: every value carries the stack prefix of placements
  whose group axes lead it (``()`` = server), ``drjax`` nodes move values
  on it (``BROADCAST``/``REDUCE``, tagged with the addressed placement;
  a ``TRANSFER`` between pipeline stages keeps the value where it is),
  local nodes join their inputs' placements, and loop carries are solved
  to a fixed point. Nodes that depend on constants only (``torch.tensor``
  literals, factories) join the stage of their first consumer, as the
  reference's literals and constvars do. Control flow is walked into:
  ``torch.ops.higher_order.while_loop``/``scan`` whose bodies communicate
  become :class:`LoopStage` stages and ``cond`` a :class:`CondStage` (its
  branches ordered ``[false, true]``, as ``lax.cond`` orders them), while
  control flow with no communication inside stays one opaque local node.
* :class:`MapReducePlan` has the reference's surface: ``to_text``,
  ``to_beam`` (an Apache Beam pipeline whose local stages call the real
  callables of ``stage_fns``), ``stage_io``, ``beam_consts``,
  ``subplans``, ``communication_stages``, ``check_locality``,
  ``analyze`` and ``comm_cost`` (``repro_torch.analysis``) and ``compile``
  (``runtime.executor``).
* :func:`run_plan` is the oracle: it runs the plan stage by stage, the
  driver owning control flow, and frees each value after its last use.

What is left of JAX's variable mechanics (sub-jaxpr inlining with fresh
variables) has no counterpart: ``make_fx`` inlines every call and every
checkpoint region as it traces, so a plan's atoms are the graph's nodes.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.fx as fx
from torch.utils import _pytree as pytree

from . import api
from . import placement as placement_lib
from . import primitives as prims

PlacementSet = Tuple[str, ...]

_COMM = {getattr(torch.ops.drjax, name).default: name
         for name in prims.COMM_OPS}


def _hop(name: str):
    return getattr(torch.ops.higher_order, name, None)


_COND, _WHILE, _SCAN = _hop("cond"), _hop("while_loop"), _hop("scan")


def _join(a: PlacementSet, b: PlacementSet) -> PlacementSet:
    """Lattice join: the deeper of two stack prefixes."""
    return a if len(a) >= len(b) else b


def _normalize_placements(spec) -> Tuple[Tuple[str, int, str], ...]:
    """An int (one "clients" placement), an ordered mapping name -> size, a
    ``PlacementContext`` (which alone carries stage kinds), or a (name,
    size[, kind]) sequence -> (name, size, kind) triples, outermost
    first."""
    if isinstance(spec, (int, np.integer)):
        return (("clients", int(spec), "replicas"),)
    if isinstance(spec, placement_lib.PlacementContext):
        return tuple((p.name, p.size, p.kind) for p in spec.placements)
    if isinstance(spec, Mapping):
        return tuple((str(n), int(s), "replicas") for n, s in spec.items())
    return tuple((str(e[0]), int(e[1]), str(e[2]) if len(e) > 2
                  else "replicas") for e in spec)


def _comm_name(node) -> Optional[str]:
    if isinstance(node, fx.Node) and node.op == "call_function":
        return _COMM.get(node.target)
    return None


def _node_placement(node) -> Tuple[Tuple[str, ...], int]:
    """(stack names, addressed index) of a ``drjax`` node, from its args."""
    names = tuple(n for n, _ in prims.parse_stack(node.args[1]))
    return names, int(node.args[2])


def _attr(root: torch.nn.Module, target: str):
    for part in target.split("."):
        root = getattr(root, part)
    return root


def _subgraphs(node, root) -> List[fx.GraphModule]:
    """The graph modules a node applies (a map body, loop and branch
    bodies)."""
    out = []
    for a in pytree.tree_leaves((node.args, node.kwargs)):
        if isinstance(a, fx.Node) and a.op == "get_attr":
            v = _attr(root, a.target)
            if isinstance(v, fx.GraphModule):
                out.append(v)
    return out


def _contains_comm(gm: fx.GraphModule) -> bool:
    """Does this graph run a ``drjax`` op, at any nesting depth?"""
    for n in gm.graph.nodes:
        if _comm_name(n) is not None:
            return True
        if any(_contains_comm(sub) for sub in _subgraphs(n, gm)):
            return True
    return False


def _is_const_attr(node) -> bool:
    return isinstance(node, fx.Node) and node.op == "get_attr"


def _output_atoms(gm: fx.GraphModule) -> Tuple[Any, ...]:
    (out,) = [n for n in gm.graph.nodes if n.op == "output"]
    return tuple(pytree.tree_leaves(out.args[0]))


def _placeholders(gm: fx.GraphModule) -> List[fx.Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _val(node):
    return node.meta.get("val") if isinstance(node, fx.Node) else None


# ---------------------------------------------------------------------------
# plan IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stage:
    """Base class for plan stages."""


@dataclasses.dataclass
class LocalCompute(Stage):
    """A maximal run of non-communication nodes at a single placement."""

    at_groups: bool
    nodes: List[fx.Node] = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return "GROUP_COMPUTE" if self.at_groups else "SERVER_COMPUTE"


@dataclasses.dataclass
class Broadcast(Stage):
    """``drjax.broadcast@placement``: one level down the placement stack;
    ``source`` is where the operand lives (``"server"`` or the next-outer
    placement)."""

    node: fx.Node = None
    kind: str = "BROADCAST"
    placement: str = "clients"
    source: str = "server"


@dataclasses.dataclass
class Reduce(Stage):
    """``drjax.reduce_*@placement``: one level up the placement stack;
    ``dest`` is where the result lands. ``compress`` is the int8 tag of
    the fused reduce (``None`` for a plain one)."""

    op: str = "reduce_sum"
    node: fx.Node = None
    kind: str = "REDUCE"
    placement: str = "clients"
    dest: str = "server"
    compress: Optional[str] = None


@dataclasses.dataclass
class Transfer(Stage):
    """``drjax.stage_transfer@placement``: the neighbour exchange along a
    stage-kind level. Each stage ships its slice ``shift`` stages on
    (neighbour traffic between stage shards); the vacated stages are
    zero-filled unless ``wrap``. Unlike a broadcast or a reduce it does not
    move on the lattice: operand and result sit at the stage level's
    depth."""

    node: fx.Node = None
    kind: str = "TRANSFER"
    placement: str = "stages"
    shift: int = 1
    wrap: bool = False


@dataclasses.dataclass
class LoopStage(Stage):
    """A ``while_loop``/``scan`` whose body communicates: a sub-plan run per
    iteration. ``trip_count`` is the scan length, ``None`` for a while.
    The body's inputs are ``carry ++ additional`` (while) or ``carry ++
    xs slices ++ additional`` (scan), torch's convention; ``getitems`` are
    the nodes that pick the loop's outputs."""

    node: fx.Node = None
    body_plan: Optional["MapReducePlan"] = None
    trip_count: Optional[int] = None
    loop_kind: str = "scan"
    cond_plan: Optional["MapReducePlan"] = None
    getitems: List[fx.Node] = dataclasses.field(default_factory=list)
    kind: str = "LOOP"

    @property
    def carry(self) -> List[Any]:
        return list(self.node.args[1] if self.loop_kind == "scan"
                    else self.node.args[2])

    @property
    def xs(self) -> List[Any]:
        return list(self.node.args[2]) if self.loop_kind == "scan" else []

    @property
    def additional(self) -> List[Any]:
        return list(self.node.args[3])


@dataclasses.dataclass
class CondStage(Stage):
    """A ``cond`` whose branches communicate: one sub-plan per branch,
    ``[false, true]`` (index = the predicate, as in ``lax.cond``)."""

    node: fx.Node = None
    branch_plans: List["MapReducePlan"] = dataclasses.field(default_factory=list)
    getitems: List[fx.Node] = dataclasses.field(default_factory=list)
    kind: str = "COND"


_CONTROL = (LoopStage, CondStage)
_COMM_STAGES = (Broadcast, Reduce, Transfer)


@dataclasses.dataclass
class MapReducePlan:
    gm: fx.GraphModule
    partition_size: int  # total innermost groups
    stages: List[Stage]
    # Lattice depth of each input/output: its number of leading group axes.
    partitioned_invars: Tuple[int, ...]
    partitioned_outvars: Tuple[int, ...]
    placements: Tuple[Tuple[str, int], ...]
    invar_placements: Tuple[PlacementSet, ...]
    outvar_placements: Tuple[PlacementSet, ...]
    out_atoms: Tuple[Any, ...]
    # Kind per level ("replicas" | "stages"), parallel to ``placements``.
    placement_kinds: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.placement_kinds:
            self.placement_kinds = tuple("replicas" for _ in self.placements)

    @property
    def invars(self) -> List[fx.Node]:
        return _placeholders(self.gm)

    @property
    def placement_sizes(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.placements)

    # -- constants ----------------------------------------------------------

    def const_env(self) -> Dict[fx.Node, Any]:
        """The plan's tensor constants (``get_attr`` nodes -> values)."""
        env = {}
        for n in self.gm.graph.nodes:
            if n.op == "get_attr":
                v = _attr(self.gm, n.target)
                if isinstance(v, torch.Tensor):
                    env[n] = v
        return env

    def beam_consts(self) -> List[Any]:
        """Constant values for ``build_pipeline(..., consts=...)``, in the
        order of the ``consts[i]`` indices of :meth:`to_beam` (all plans
        depth-first, first occurrence of a value wins)."""
        return [v for _, v in _const_table(self)]

    # -- stage naming / traversal ------------------------------------------

    def named_stages(self, _prefix: str = ""):
        """Yield ``(name, stage, owner_plan)`` depth-first: ``stage_0``,
        a loop body's ``stage_2_0``, its predicate's ``stage_2_c_0``, a
        branch's ``stage_3_b0_0``."""
        for i, s in enumerate(self.stages):
            yield f"stage_{_prefix}{i}", s, self
            if isinstance(s, LoopStage):
                if s.cond_plan is not None:
                    yield from s.cond_plan.named_stages(f"{_prefix}{i}_c_")
                yield from s.body_plan.named_stages(f"{_prefix}{i}_")
            elif isinstance(s, CondStage):
                for b, bp in enumerate(s.branch_plans):
                    yield from bp.named_stages(f"{_prefix}{i}_b{b}_")

    def subplans(self) -> List["MapReducePlan"]:
        """This plan and every nested sub-plan, depth-first."""
        return list(_all_plans(self))

    def stage_io(self) -> List[Tuple[Stage, List[Any], List[Any]]]:
        """For each top-level stage: (stage, input nodes, output nodes).
        Inputs are the nodes a stage reads and does not define (constants
        excluded, first-read order); outputs are the nodes it defines that
        a later stage reads or that are plan outputs."""
        reads = [_stage_reads(s) for s in self.stages]
        final = {a for a in self.out_atoms if isinstance(a, fx.Node)}
        out = []
        for i, s in enumerate(self.stages):
            later = set()
            for r in reads[i + 1:]:
                later.update(r)
            outs = [w for w in _stage_writes(s) if w in later or w in final]
            out.append((s, reads[i], outs))
        return out

    def stage_fns(self) -> Dict[str, Callable]:
        """A real callable (an FX ``GraphModule``) for every LocalCompute
        stage, keyed as :meth:`named_stages`: it takes the stage's inputs
        (:meth:`stage_io`) positionally, partitioned ones stacked along
        their group axes, closes over the constants, and returns the
        stage's outputs as a tuple."""
        fns: Dict[str, Callable] = {}
        io: Dict[int, Dict[int, Tuple[List[Any], List[Any]]]] = {}
        for name, stage, owner in self.named_stages():
            if not isinstance(stage, LocalCompute):
                continue
            if id(owner) not in io:
                io[id(owner)] = {id(s): (i, o) for s, i, o in owner.stage_io()}
            ins, outs = io[id(owner)][id(stage)]
            fns[name] = stage_module(owner.gm, stage.nodes, ins, outs)
        return fns

    # -- execution ----------------------------------------------------------

    def compile(self, **kwargs):
        """Lower the plan for repeated rounds: ``runtime.executor``'s
        :class:`CompiledPlan` (one CUDA graph on the card)."""
        from ..runtime import executor  # lazy: no core -> runtime cycle

        return executor.compile_plan(self, **kwargs)

    # -- static analysis ----------------------------------------------------

    def analyze(self, **kwargs):
        """Run the static passes (``repro_torch.analysis.analyze_plan``):
        placement safety, donation, retrace hazards and the comm cost."""
        from ..analysis import analyze_plan  # lazy: no core -> analysis cycle

        return analyze_plan(self, **kwargs)

    def comm_cost(self):
        """Per-stage wire bytes (``analysis.commcost.estimate_comm_cost``)."""
        from ..analysis import commcost

        return commcost.estimate_comm_cost(self)

    # -- emitters -----------------------------------------------------------

    def to_text(self) -> str:
        pp = _Namer()
        if len(self.placements) > 1 or "stages" in self.placement_kinds:
            header = ("MapReducePlan(placements=" + "/".join(
                f"{n}:{s}" + ("[stages]" if k == "stages" else "")
                for (n, s), k in zip(self.placements, self.placement_kinds))
                + ")")
        else:
            header = f"MapReducePlan(partition_size={self.partition_size})"

        def tag(pl: PlacementSet) -> str:
            if not pl:
                return "SERVER"
            if len(self.placements) == 1 and len(pl) == 1:
                return "GROUPS"
            return "/".join(pl)

        lines = [header, "  inputs: " + ", ".join(
            f"{pp(v)}:{_short(_val(v))} @{tag(pl)}"
            for v, pl in zip(self.invars, self.invar_placements))]
        lines.extend(_stage_text_lines(self.stages, 2, pp))
        lines.append("  outputs: " + ", ".join(pp(a) for a in self.out_atoms))
        return "\n".join(lines)

    def to_beam(self) -> str:
        """An Apache Beam pipeline for this plan: partitioned values are
        keyed PCollections ``(group path, value)``, server values singleton
        PCollections, broadcasts side inputs (flat) or re-keyed collections
        (nested), reductions ``CombinePerKey``/``CombineGlobally``; local
        stages call ``fns = plan.stage_fns()``. Every referenced name is
        defined before use. Beam is not a dependency: the text is built,
        never run, here."""
        return _BeamEmitter(self).emit()

    # -- structural checks --------------------------------------------------

    def communication_stages(self, recursive: bool = False) -> List[Stage]:
        return [s for name, s, _ in self.named_stages()
                if isinstance(s, _COMM_STAGES)
                and (recursive or "_" not in name[len("stage_"):])]

    def check_locality(self) -> None:
        """No communication may hide inside a local stage, at any depth: a
        node whose sub-graph communicates where the builder cannot stage it
        (a map body that reduces, say) fails loudly here."""
        for _, s, owner in self.named_stages():
            if not isinstance(s, LocalCompute):
                continue
            for n in s.nodes:
                if _comm_name(n) is not None or any(
                        _contains_comm(g) for g in _subgraphs(n, owner.gm)):
                    raise AssertionError(
                        f"communication primitive inside {s.kind} stage "
                        f"(node {n.name}): this control-flow structure is "
                        "not representable as a MapReduce plan yet")


def _all_plans(plan: MapReducePlan):
    yield plan
    for s in plan.stages:
        if isinstance(s, LoopStage):
            if s.cond_plan is not None:
                yield from _all_plans(s.cond_plan)
            yield from _all_plans(s.body_plan)
        elif isinstance(s, CondStage):
            for bp in s.branch_plans:
                yield from _all_plans(bp)


def _const_table(plan: MapReducePlan) -> List[Tuple[fx.Node, Any]]:
    """(get_attr node, value) of every plan, one entry per distinct value
    (a constant shared by an inlined helper is listed once)."""
    seen, out = {}, []
    for p in _all_plans(plan):
        for node, val in p.const_env().items():
            key = id(val)
            if key not in seen:
                seen[key] = len(out)
                out.append((node, val))
    return out


def _control_inputs(stage) -> List[Any]:
    return [a for a in stage.node.all_input_nodes if not _is_const_attr(a)]


def _stage_reads(stage: Stage) -> List[fx.Node]:
    if isinstance(stage, LocalCompute):
        defined, seen, reads = set(stage.nodes), set(), []
        for n in stage.nodes:
            for a in n.all_input_nodes:
                if a in defined or a in seen or _is_const_attr(a):
                    continue
                seen.add(a)
                reads.append(a)
        return reads
    return _control_inputs(stage)


def _stage_writes(stage: Stage) -> List[fx.Node]:
    if isinstance(stage, LocalCompute):
        return list(stage.nodes)
    if isinstance(stage, _CONTROL):
        return [stage.node] + list(stage.getitems)
    return [stage.node]


def stage_module(root: fx.GraphModule, nodes: Sequence[fx.Node],
                 ins: Sequence[fx.Node], outs: Sequence[fx.Node]
                 ) -> fx.GraphModule:
    """A GraphModule of ``nodes`` (constants copied in from ``root``):
    ``(*ins) -> tuple(outs)``."""
    g = fx.Graph()
    env: Dict[fx.Node, fx.Node] = {}
    for n in ins:
        env[n] = g.placeholder(n.name)
        env[n].meta = dict(n.meta)

    def arg(a):
        if a not in env:
            if not _is_const_attr(a):
                raise KeyError(f"stage reads {a.name}, which is not an input")
            env[a] = g.get_attr(a.target)
        return env[a]

    for n in nodes:
        env[n] = g.node_copy(n, arg)
    g.output(tuple(arg(o) for o in outs))
    gm = fx.GraphModule(root, g)
    gm.input_vars, gm.output_vars = list(ins), list(outs)
    return gm


class _Namer:
    """Stable short names (a, b, ..., aa, ...) for nodes in ``to_text``."""

    def __init__(self):
        self._names: Dict[Any, str] = {}

    def __call__(self, atom) -> str:
        if not isinstance(atom, fx.Node):
            return repr(atom)
        if atom not in self._names:
            i, name = len(self._names), ""
            while True:
                name = chr(ord("a") + i % 26) + name
                i = i // 26 - 1
                if i < 0:
                    break
            self._names[atom] = name
        return self._names[atom]


_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float64: "f64", torch.int64: "i64", torch.int32: "i32",
           torch.int8: "i8", torch.bool: "bool"}


def _short(val) -> str:
    if not isinstance(val, torch.Tensor):
        return type(val).__name__
    dt = _DTYPES.get(val.dtype, str(val.dtype).replace("torch.", ""))
    return f"{dt}[{','.join(str(d) for d in val.shape)}]"


def _op_name(node: fx.Node) -> str:
    t = node.target
    if t is api.map_groups:
        return "map_groups"
    if t is operator.getitem:
        return "getitem"
    if isinstance(t, torch._ops.OpOverload):
        return t.overloadpacket.__name__
    return getattr(t, "__name__", str(t))


def _stage_text_lines(stages, indent: int, pp: _Namer) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    for i, s in enumerate(stages):
        if isinstance(s, LocalCompute):
            ops = ", ".join(_op_name(n) for n in s.nodes)
            lines.append(f"{pad}stage {i}: {s.kind} [{ops}]")
        elif isinstance(s, Broadcast):
            route = ("server->groups" if s.source == "server"
                     else f"{s.source}->{s.placement}")
            lines.append(f"{pad}stage {i}: BROADCAST {route} @{s.placement} "
                         f"({pp(s.node.args[0])} -> {pp(s.node)})")
        elif isinstance(s, Reduce):
            route = ("groups->server" if s.dest == "server"
                     else f"{s.placement}->{s.dest}")
            tag = f" [{s.compress}]" if s.compress else ""
            lines.append(f"{pad}stage {i}: {s.op.upper()} {route} "
                         f"@{s.placement}{tag} ({pp(s.node.args[0])} -> "
                         f"{pp(s.node)})")
        elif isinstance(s, Transfer):
            shift = f"{s.shift:+d}" + (" wrap" if s.wrap else "")
            lines.append(f"{pad}stage {i}: TRANSFER shift={shift} "
                         f"@{s.placement} ({pp(s.node.args[0])} -> "
                         f"{pp(s.node)})")
        elif isinstance(s, LoopStage):
            trip = "?" if s.trip_count is None else str(s.trip_count)
            lines.append(f"{pad}stage {i}: LOOP[{s.loop_kind}] "
                         f"trip_count={trip}:")
            if s.cond_plan is not None and s.cond_plan.stages:
                lines.append(f"{pad}  cond:")
                lines.extend(_stage_text_lines(s.cond_plan.stages,
                                               indent + 4, pp))
                lines.append(f"{pad}  body:")
            lines.extend(_stage_text_lines(s.body_plan.stages, indent + 4, pp))
        elif isinstance(s, CondStage):
            lines.append(f"{pad}stage {i}: COND over {len(s.branch_plans)} "
                         "branches:")
            for b, bp in enumerate(s.branch_plans):
                lines.append(f"{pad}  branch {b}:")
                lines.extend(_stage_text_lines(bp.stages, indent + 4, pp))
    return lines


# ---------------------------------------------------------------------------
# tracing and plan construction
# ---------------------------------------------------------------------------


def trace(fn: Callable, *args) -> fx.GraphModule:
    """The traced graph of ``fn(*args)`` (``fn`` carries its drjax
    context, as a ``@drjax.program`` does): ``make_fx`` in fake mode with
    the primitives recording. The graph's inputs are the tensor leaves of
    ``args`` in ``pytree`` order (other leaves are baked in), its outputs
    the tensor leaves of the result; ``gm.in_spec``/``gm.out_spec`` keep
    the trees. Autograd is traced through, so a gradient program shows
    its backward."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_spec = pytree.tree_flatten(args)
    is_t = [isinstance(x, torch.Tensor) for x in leaves]
    out_box = []

    def flat_fn(*tensors):
        it = iter(tensors)
        full = [next(it) if t else x for x, t in zip(leaves, is_t)]
        out = fn(*pytree.tree_unflatten(full, in_spec))
        flat, spec = pytree.tree_flatten(out)
        out_box.append(spec)
        return flat

    with prims.recording():
        gm = make_fx(flat_fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(
            *[x for x, t in zip(leaves, is_t) if t])
    gm.graph.eliminate_dead_code()
    gm.recompile()
    gm.in_spec, gm.out_spec = in_spec, out_box[0]
    return gm


def _placement_depth(shape, sizes: Tuple[int, ...]) -> int:
    """Largest k such that the k leading dims match the k outermost
    placement sizes (the depth heuristic for undeclared inputs)."""
    k = 0
    while k < len(sizes) and k < len(shape) and shape[k] == sizes[k]:
        k += 1
    return k


def build_plan(gm: fx.GraphModule, placements,
               partitioned_invars: Optional[Sequence[Any]] = None
               ) -> MapReducePlan:
    """Segment a traced graph into MapReduce stages, recursing into
    control flow.

    ``placements`` is an int (one "clients" placement), an ordered mapping
    ``{"pods": P, "clients": m}``, a ``PlacementContext`` (the spec that
    carries stage kinds: a pipeline's ``round_fn.drjax_context``) or
    (name, size[, kind]) entries. ``partitioned_invars[i]`` places input i on the lattice: a bool
    (server / fully partitioned), an int depth or a name-prefix tuple; by
    default the longest prefix of placement sizes that matches its leading
    dims.
    """
    triples = _normalize_placements(placements)
    pairs = tuple((n, s) for n, s, _ in triples)
    kinds = tuple(k for _, _, k in triples)
    names = tuple(n for n, _ in pairs)
    sizes = tuple(s for _, s in pairs)

    def norm(entry) -> PlacementSet:
        if isinstance(entry, tuple):
            return entry
        if entry is True:
            return names
        if entry is False or entry is None:
            return ()
        return names[:int(entry)]

    invars = _placeholders(gm)
    if partitioned_invars is None:
        invar_pl = tuple(names[:_placement_depth(tuple(_val(v).shape), sizes)]
                         if isinstance(_val(v), torch.Tensor) else ()
                         for v in invars)
    else:
        invar_pl = tuple(norm(e) for e in partitioned_invars)
        if len(invar_pl) != len(invars):
            raise ValueError(f"partitioned_invars has {len(invar_pl)} "
                             f"entries for {len(invars)} graph inputs")

    placed: Dict[fx.Node, PlacementSet] = dict(zip(invars, invar_pl))
    constlike: Dict[fx.Node, None] = {}  # pending nodes of constants only
    control_of: Dict[fx.Node, Stage] = {}
    stages: List[Stage] = []

    def pl_of(a) -> PlacementSet:
        return placed.get(a, ()) if isinstance(a, fx.Node) else ()

    def pull_consts(node) -> List[fx.Node]:
        """The pending constant-only nodes ``node`` needs, in graph order."""
        need, todo = set(), [a for a in node.all_input_nodes if a in constlike]
        while todo:
            a = todo.pop()
            if a not in need:
                need.add(a)
                todo.extend(b for b in a.all_input_nodes if b in constlike)
        out = [a for a in constlike if a in need]
        for a in out:
            del constlike[a]
        return out

    def append_local(nodes: List[fx.Node], at_groups: bool):
        if not nodes:
            return
        if (stages and isinstance(stages[-1], LocalCompute)
                and stages[-1].at_groups == at_groups):
            stages[-1].nodes.extend(nodes)
        else:
            stages.append(LocalCompute(at_groups=at_groups, nodes=list(nodes)))

    def sub_plan(sub: fx.GraphModule, parts) -> "MapReducePlan":
        return build_plan(sub, triples, partitioned_invars=list(parts))

    def fixed_point(make, carry_p: List[PlacementSet], n_carry: int):
        plan = None
        for _ in range(n_carry + 1):
            plan = make(carry_p)
            out_p = list(plan.outvar_placements[:n_carry])
            new = [_join(a, b) for a, b in zip(carry_p, out_p)]
            if new == carry_p:
                break
            carry_p = new
        return plan, carry_p

    def emit_while(node):
        cond_g, body_g = _attr(gm, node.args[0].target), _attr(gm, node.args[1].target)
        carry = list(node.args[2])
        add_p = [pl_of(a) for a in node.args[3]]
        body_plan, carry_p = fixed_point(
            lambda cp: sub_plan(body_g, cp + add_p),
            [pl_of(a) for a in carry], len(carry))
        stage = LoopStage(node=node, body_plan=body_plan, trip_count=None,
                          loop_kind="while",
                          cond_plan=sub_plan(cond_g, carry_p + add_p))
        stages.append(stage)
        return stage, carry_p

    def emit_scan(node):
        body_g = _attr(gm, node.args[0].target)
        carry, xs = list(node.args[1]), list(node.args[2])
        add_p = [pl_of(a) for a in node.args[3]]
        binders = _placeholders(body_g)
        xs_p = [names[:_placement_depth(tuple(_val(b).shape), sizes)]
                for b in binders[len(carry):len(carry) + len(xs)]]
        body_plan, carry_p = fixed_point(
            lambda cp: sub_plan(body_g, cp + xs_p + add_p),
            [pl_of(a) for a in carry], len(carry))
        trip = int(_val(xs[0]).shape[0]) if xs else None
        stage = LoopStage(node=node, body_plan=body_plan, trip_count=trip,
                          loop_kind="scan")
        stages.append(stage)
        # stacked ys are server-placed: the time axis leads them
        n_ys = len(body_plan.out_atoms) - len(carry)
        return stage, carry_p + [()] * n_ys

    def emit_cond(node):
        ops_p = [pl_of(a) for a in node.args[3]]
        branches = [_attr(gm, node.args[2].target), _attr(gm, node.args[1].target)]
        plans = [sub_plan(b, ops_p) for b in branches]
        stage = CondStage(node=node, branch_plans=plans)
        stages.append(stage)
        outs = []
        for i in range(len(plans[0].out_atoms)):
            p = ()
            for bp in plans:
                p = _join(p, bp.outvar_placements[i])
            outs.append(p)
        return stage, outs

    out_pl: Dict[fx.Node, List[PlacementSet]] = {}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "get_attr":
            placed[node] = ()
            continue
        if node.op != "call_function":
            raise TypeError(f"build_plan: unexpected node {node.op} "
                            f"{node.name}")
        src = node.args[0] if node.target is operator.getitem else None
        if isinstance(src, fx.Node) and src in control_of:
            control_of[src].getitems.append(node)
            placed[node] = out_pl[src][node.args[1]]
            continue
        inputs = [a for a in node.all_input_nodes if not _is_const_attr(a)]
        if all(a in constlike for a in inputs) and _comm_name(node) is None \
                and not _subgraphs(node, gm):
            constlike[node] = None
            placed[node] = ()
            continue
        name = _comm_name(node)
        has_comm = any(_contains_comm(g) for g in _subgraphs(node, gm))
        pre = pull_consts(node)
        if name is not None or (has_comm and node.target in (_COND, _WHILE,
                                                             _SCAN)):
            append_local(pre, False)
        if name == "broadcast":
            enames, i = _node_placement(node)
            in_pl = pl_of(node.args[0])
            if len(in_pl) > i and in_pl[:i + 1] == enames[:i + 1]:
                raise ValueError(
                    f"broadcast@{enames[i]} over a value already partitioned "
                    f"at {in_pl}: only the next level of a value's placement "
                    "prefix can be broadcast")
            stages.append(Broadcast(node=node, placement=enames[i],
                                    source=enames[i - 1] if i else "server"))
            placed[node] = enames[:i + 1]
        elif name == "stage_transfer":
            # No lattice movement: a transfer permutes values among the
            # stage groups, so the result stays at the level's depth.
            enames, i = _node_placement(node)
            stages.append(Transfer(node=node, placement=enames[i],
                                   shift=int(node.args[3]),
                                   wrap=bool(node.args[4])))
            placed[node] = enames[:i + 1]
        elif name is not None:
            enames, i = _node_placement(node)
            in_pl = pl_of(node.args[0])
            if len(in_pl) > i + 1 and in_pl[:i + 1] == enames[:i + 1]:
                raise ValueError(
                    f"{name}@{enames[i]} reduces an outer level of a value "
                    f"partitioned at {in_pl}: only the innermost level of a "
                    f"value's placement prefix can be reduced (reduce "
                    f"{in_pl[-1]!r} first)")
            compress = node.args[3] if len(node.args) > 3 else None
            stages.append(Reduce(op=name, node=node, placement=enames[i],
                                 dest=enames[i - 1] if i else "server",
                                 compress=compress))
            placed[node] = enames[:i]
        elif has_comm and node.target is _WHILE:
            control_of[node], out_pl[node] = emit_while(node)
        elif has_comm and node.target is _SCAN:
            control_of[node], out_pl[node] = emit_scan(node)
        elif has_comm and node.target is _COND:
            control_of[node], out_pl[node] = emit_cond(node)
        else:
            p = ()
            for a in node.all_input_nodes:
                p = _join(p, pl_of(a))
            placed[node] = p
            append_local(pre + [node], bool(p))

    out_atoms = _output_atoms(gm)
    append_local(list(constlike), False)  # constants the outputs read
    for node in out_atoms:
        if isinstance(node, fx.Node) and node in control_of:
            raise NotImplementedError(
                "build_plan: a control-flow node's whole output list is a "
                "program output; return its elements instead")
    outvar_pl = tuple(pl_of(a) for a in out_atoms)
    plan = MapReducePlan(
        gm=gm,
        partition_size=math.prod(sizes),
        stages=stages,
        partitioned_invars=tuple(len(p) for p in invar_pl),
        partitioned_outvars=tuple(len(p) for p in outvar_pl),
        placements=pairs,
        invar_placements=invar_pl,
        outvar_placements=outvar_pl,
        out_atoms=out_atoms,
        placement_kinds=kinds,
    )
    plan.check_locality()
    return plan


# ---------------------------------------------------------------------------
# the oracle: run a plan stage by stage
# ---------------------------------------------------------------------------


def _eval_node(node: fx.Node, read: Callable):
    args = fx.node.map_arg(node.args, read)
    kwargs = fx.node.map_arg(node.kwargs, read)
    return node.target(*args, **kwargs)


class _Env:
    """Values of one plan run, each dropped after its last reader ran."""

    def __init__(self, plan: MapReducePlan, args: Sequence[Any]):
        self.root = plan.gm
        self.vals: Dict[fx.Node, Any] = {}
        self.left: Dict[fx.Node, int] = {}
        self.keep = {a for a in plan.out_atoms if isinstance(a, fx.Node)}
        invars = plan.invars
        if len(args) != len(invars):
            raise TypeError(f"plan expects {len(invars)} flat args, got "
                            f"{len(args)}")
        for v, x in zip(invars, args):
            self.write(v, x)

    def read(self, a):
        if not isinstance(a, fx.Node):
            return a
        if a.op == "get_attr":
            return _attr(self.root, a.target)
        return self.vals[a]

    def write(self, node: fx.Node, val):
        self.vals[node] = val
        self.left[node] = len(node.users)

    def consumed(self, node: fx.Node):
        """``node`` ran: release the inputs it was the last reader of."""
        for a in node.all_input_nodes:
            if a in self.left:
                self.left[a] -= 1
                if self.left[a] == 0 and a not in self.keep:
                    del self.vals[a]

    def run(self, node: fx.Node):
        self.write(node, _eval_node(node, self.read))
        self.consumed(node)


def run_plan(plan: MapReducePlan, *args, observe=None) -> List[Any]:
    """Execute ``plan`` stage by stage on flat ``args`` (the graph's
    inputs), the driver owning control flow: local and communication
    stages run their nodes, loop stages iterate their body sub-plan (a
    ``while`` asks its predicate sub-plan on the host), cond stages run
    the branch the predicate picks. Returns the flat outputs.
    ``observe(stage, operand, out)``, when given, is called each time a
    communication stage ran, at any depth, with the values it read and
    wrote."""
    return _execute_plan(plan, list(args), observe)


def _execute_plan(plan: MapReducePlan, args: List[Any],
                  observe=None) -> List[Any]:
    env = _Env(plan, args)
    execute = (None if observe is None else
               lambda p, a: _execute_plan(p, a, observe))
    for stage in plan.stages:
        if isinstance(stage, LocalCompute):
            for node in stage.nodes:
                env.run(node)
        elif isinstance(stage, _COMM_STAGES):
            operand = env.read(stage.node.args[0])
            env.run(stage.node)
            if observe is not None:
                observe(stage, operand, env.read(stage.node))
        elif isinstance(stage, LoopStage):
            _finish_control(env, stage, _run_loop(stage, env.read, execute))
        elif isinstance(stage, CondStage):
            _finish_control(env, stage, _run_cond(stage, env.read, execute))
        else:  # pragma: no cover - future stage kinds
            raise TypeError(f"unknown stage kind: {stage!r}")
    return [env.read(a) for a in plan.out_atoms]


def _finish_control(env: _Env, stage, outs: List[Any]):
    env.write(stage.node, outs)
    env.consumed(stage.node)
    for g in stage.getitems:
        env.run(g)


def _run_loop(stage: LoopStage, read, execute=None) -> List[Any]:
    """One loop stage: ``execute(sub_plan, args)`` runs a sub-plan (the
    oracle's by default, a compiled unit's in the executor)."""
    execute = execute or _execute_plan
    carry = [read(a) for a in stage.carry]
    add = [read(a) for a in stage.additional]
    if stage.loop_kind == "while":
        while bool(execute(stage.cond_plan, carry + add)[0]):
            carry = list(execute(stage.body_plan, carry + add))
        return carry
    xs = [read(a) for a in stage.xs]
    ys: List[List[Any]] = []
    for t in range(stage.trip_count):
        outs = execute(stage.body_plan, carry + [x.select(0, t) for x in xs]
                       + add)
        carry, y = list(outs[:len(carry)]), list(outs[len(carry):])
        ys.append(y)
    return carry + [torch.stack(parts) for parts in zip(*ys)]


def _run_cond(stage: CondStage, read, execute=None) -> List[Any]:
    execute = execute or _execute_plan
    idx = int(bool(read(stage.node.args[0])))
    ops = [read(a) for a in stage.node.args[3]]
    return list(execute(stage.branch_plans[idx], ops))


def count_primitives(gm: fx.GraphModule) -> Dict[str, int]:
    """Histogram of ``drjax`` nodes in a graph, sub-graphs included, keyed
    as the reference's primitives (``drjax_broadcast``, ...)."""
    counts: Dict[str, int] = {}

    def visit(g):
        for n in g.graph.nodes:
            name = _comm_name(n)
            if name is not None:
                key = f"drjax_{name}"
                counts[key] = counts.get(key, 0) + 1
            for sub in _subgraphs(n, g):
                visit(sub)

    visit(gm)
    return counts


# ---------------------------------------------------------------------------
# Apache Beam emitter
# ---------------------------------------------------------------------------


_BEAM_PREAMBLE = """\
# Apache Beam pipeline generated from a MapReducePlan.
# `fns` are the real Python callables of the plan's local stages:
#   fns = plan.stage_fns()
# Partitioned values are keyed PCollections of (group_id, value); server
# values are singleton PCollections; broadcasts are named side inputs.
# Group stages apply the stage's graph to a 1-row stack per element.
import apache_beam as beam
import numpy as np


def _reduce_sum(vals):
  return np.sum(np.stack(list(vals)), axis=0)


def _reduce_mean(vals):
  vs = np.stack(list(vals))
  return np.sum(vs, axis=0) / vs.shape[0]


def _reduce_max(vals):
  return np.max(np.stack(list(vals)), axis=0)


def _lift(v, k):
  # One group's element -> a rank-(k + v.ndim) stack slice.
  v = np.asarray(v)
  return v.reshape((1,) * k + v.shape)


def _unkey(rows, shape):
  # (key_tuple, value) pairs -> one stacked array with the placement-stack
  # axes restored (row-major over the sorted key tuples).
  arr = np.stack([v for _, v in sorted(rows)])
  return arr.reshape(tuple(shape) + arr.shape[1:])


def _stage_shift(v, axis, shift, wrap):
  # stage_transfer on a stacked (non-keyed) value: roll the stage axis,
  # zero-filling the slots the shift vacated unless wrapping.
  out = np.roll(np.asarray(v), shift, axis=axis)
  if not wrap and shift != 0:
    idx = [slice(None)] * out.ndim
    idx[axis] = slice(0, shift) if shift > 0 else slice(shift, None)
    out[tuple(idx)] = 0
  return out
"""


class _BeamEmitter:
    """Emit a Beam pipeline where every referenced name is defined: the
    reference's emitter (``repro/core/interpreter.py:1271-2068``) over
    graph nodes and torch's loop conventions."""

    def __init__(self, plan: MapReducePlan):
        self.plan = plan
        self.lines: List[str] = []
        self.names: Dict[Any, str] = {}
        self.kinds: Dict[str, str] = {}  # identifier -> plain|server|group|side
        self._n = 0
        self._labels = 0
        self._indent = 1
        self._loop_vars: List[str] = []
        self.side_src: Dict[str, Tuple[str, str]] = {}
        self.nested = len(plan.placements) > 1
        self.depths: Dict[str, int] = {}
        table = _const_table(plan)
        index = {id(v): i for i, (_, v) in enumerate(table)}
        self._const_index: Dict[fx.Node, int] = {}
        for p in _all_plans(plan):
            for node, val in p.const_env().items():
                self._const_index[node] = index[id(val)]

    # -- low-level helpers --------------------------------------------------

    def line(self, text: str):
        self.lines.append("  " * self._indent + text)

    def fresh(self, prefix: str = "t") -> str:
        self._n += 1
        return f"{prefix}{self._n}"

    def label(self) -> str:
        self._labels += 1
        base = f"S{self._labels}"
        if self._loop_vars:
            return "f'" + base + "_" + "_".join(
                "{%s}" % v for v in self._loop_vars) + "'"
        return f"'{base}'"

    def assign(self, name: str, rhs: str, kind: str, comment: str = ""):
        tail = f"  # {comment}" if comment else ""
        self.line(f"{name} = {rhs}{tail}")
        self.kinds[name] = kind

    def name_of(self, atom) -> str:
        if not isinstance(atom, fx.Node):
            name = self.fresh("lit")
            self.assign(name, _literal_src(atom), "plain", "literal")
            return name
        if atom in self.names:
            return self.names[atom]
        if atom in self._const_index:
            name = self.fresh("c")
            self.assign(name, f"np.asarray(consts[{self._const_index[atom]}])",
                        "plain", "captured constant (see plan.beam_consts())")
            self.names[atom] = name
            return name
        name = self.fresh("undef")
        self.assign(name, "None", "plain", f"unbound node {atom} (bug?)")
        self.names[atom] = name
        return name

    def bind(self, atom, name: str):
        self.names[atom] = name

    def to_group(self, name: str) -> str:
        kind = self.kinds.get(name, "plain")
        if kind == "group":
            return name
        out = self.fresh("g")
        n0 = self.plan.placement_sizes[0]
        if kind == "plain":
            rhs = (f"p | {self.label()} >> beam.Create([((j,), {name}[j]) for "
                   f"j in range({n0})])" if self.nested else
                   f"p | {self.label()} >> beam.Create(list(enumerate({name})))")
        elif kind == "server":
            rhs = (f"{name} | {self.label()} >> beam.FlatMap(lambda v: "
                   f"[((j,), v[j]) for j in range({n0})])" if self.nested else
                   f"{name} | {self.label()} >> "
                   "beam.FlatMap(lambda v: list(enumerate(v)))")
        else:
            rhs = name
        self.assign(out, rhs, "group", "key by group")
        self.depths[out] = 1
        return out

    def to_server(self, name: str) -> str:
        kind = self.kinds.get(name, "plain")
        if kind in ("server", "plain", "side"):
            return name
        out = self.fresh("s")
        depth = self.depths.get(name, 1)
        if self.nested or depth > 1:
            sizes = self.plan.placement_sizes[:depth]
            tail = f"beam.Map(lambda rows: _unkey(rows, {tuple(sizes)!r}))"
        else:
            tail = "beam.Map(lambda rows: np.stack([v for _, v in sorted(rows)]))"
        self.assign(out, f"{name} | {self.label()} >> beam.combiners.ToList() "
                         f"| {self.label()} >> {tail}",
                    "server", "collect groups to a stacked server value")
        return out

    # -- emission -----------------------------------------------------------

    def emit(self) -> str:
        plan = self.plan
        self.lines = _BEAM_PREAMBLE.splitlines() + ["", ""]
        self.lines.append("def build_pipeline(p, args, fns, consts=()):")
        if self.nested:
            all_sizes = tuple(plan.placement_sizes)
            self.assign("groups", f"p | 'Groups' >> beam.Create([(idx, ()) "
                                  f"for idx in np.ndindex(*{all_sizes!r})])",
                        "group", "one element per innermost group")
            self.depths["groups"] = len(all_sizes)
        else:
            self.assign("groups", f"p | 'Groups' >> beam.Create([(g, ()) for "
                                  f"g in range({plan.partition_size})])",
                        "group", "one element per group")
            self.depths["groups"] = 1
        for i, (v, k) in enumerate(zip(plan.invars, plan.partitioned_invars)):
            name = self.fresh("in_")
            tag = "/".join(plan.invar_placements[i])
            if k and (self.nested or k > 1):
                sizes = tuple(plan.placement_sizes[:k])
                self.assign(name, f"p | {self.label()} >> beam.Create([(idx, "
                                  f"args[{i}][idx]) for idx in "
                                  f"np.ndindex(*{sizes!r})])",
                            "group", f"plan input {i} @{tag}")
                self.depths[name] = k
            elif k:
                self.assign(name, f"p | {self.label()} >> "
                                  f"beam.Create(list(enumerate(args[{i}])))",
                            "group", f"plan input {i} @GROUPS")
                self.depths[name] = 1
            else:
                self.assign(name, f"p | {self.label()} >> "
                                  f"beam.Create([args[{i}]])",
                            "server", f"plan input {i} @SERVER")
            self.bind(v, name)
        self.emit_plan_stages(plan, "")
        outs = [self.name_of(a) for a in plan.out_atoms]
        self.line(f"return [{', '.join(outs)}]")
        return "\n".join(self.lines)

    def emit_plan_stages(self, plan: MapReducePlan, prefix: str):
        for i, (stage, _, outs) in enumerate(plan.stage_io()):
            sname = f"stage_{prefix}{i}"
            if isinstance(stage, Broadcast):
                self.emit_broadcast(stage)
            elif isinstance(stage, Reduce):
                self.emit_reduce(stage)
            elif isinstance(stage, Transfer):
                self.emit_transfer(stage)
            elif isinstance(stage, LocalCompute):
                self.emit_local(stage, plan, sname, outs)
            elif isinstance(stage, LoopStage):
                self.emit_loop(stage, f"{prefix}{i}", outs)
            elif isinstance(stage, CondStage):
                self.emit_cond(stage, f"{prefix}{i}")

    def emit_broadcast(self, stage: Broadcast):
        src = self.name_of(stage.node.args[0])
        out = self.fresh("bc")
        names, i = _node_placement(stage.node)
        size = self.plan.placement_sizes[i]
        kind = self.kinds.get(src, "plain")
        if self.nested or i > 0:
            tag = f"BROADCAST {stage.source}->{stage.placement}"
            if kind == "group":
                self.assign(out, f"{src} | {self.label()} >> beam.FlatMap("
                                 f"lambda kv: [(kv[0] + (j,), kv[1]) for j in "
                                 f"range({size})])",
                            "group", f"{tag} (extend placement path)")
                self.depths[out] = self.depths.get(src, 1) + 1
            elif kind == "server":
                self.assign(out, f"p | {self.label()} >> beam.Create([(j,) "
                                 f"for j in range({size})]) | {self.label()} "
                                 f">> beam.Map(lambda k, _v: ((k,) if not "
                                 f"isinstance(k, tuple) else k, _v), "
                                 f"beam.pvalue.AsSingleton({src}))",
                            "group", f"{tag} (materialized per group)")
                self.depths[out] = 1
            else:
                self.assign(out, f"p | {self.label()} >> beam.Create([((j,), "
                                 f"{src}) for j in range({size})])",
                            "group", f"{tag} (materialized per group)")
                self.depths[out] = 1
            self.bind(stage.node, out)
            return
        if kind == "server":
            self.assign(out, f"beam.pvalue.AsSingleton({src})", "side",
                        "BROADCAST server->groups (side input)")
            self.side_src[out] = (src, "server")
        else:
            self.assign(out, src, "plain", "BROADCAST (replicated value)")
            self.side_src[out] = (src, "plain")
        self.bind(stage.node, out)

    def emit_reduce(self, stage: Reduce):
        src = self.name_of(stage.node.args[0])
        combiner = f"_{stage.op}"
        out = self.fresh("r")
        kind = self.kinds.get(src, "plain")
        _, i = _node_placement(stage.node)
        n = self.plan.placement_sizes[i]
        op = stage.op.upper() + (f" [{stage.compress}]" if stage.compress
                                 else "")
        if kind == "group" and self.depths.get(src, 1) >= 2:
            self.assign(out, f"{src} | {self.label()} >> beam.Map(lambda kv: "
                             f"(kv[0][:-1], kv[1])) | {self.label()} >> "
                             f"beam.CombinePerKey({combiner})",
                        "group", f"{op} {stage.placement}->{stage.dest} "
                                 f"(combine per {stage.dest})")
            self.depths[out] = self.depths[src] - 1
        elif src in self.side_src:
            base, bkind = self.side_src[src]
            if bkind == "server":
                self.assign(out, f"{base} | {self.label()} >> beam.Map("
                                 f"lambda v: {combiner}([v] * {n}))",
                            "server", f"{op} over {n} broadcast replicas")
            else:
                self.assign(out, f"{combiner}([{base}] * {n})", "plain",
                            f"{op} over {n} broadcast replicas")
        elif kind == "group":
            self.assign(out, f"{src} | {self.label()} >> beam.Values() | "
                             f"{self.label()} >> beam.CombineGlobally({combiner})",
                        "server", f"{op} groups->server")
        else:
            self.assign(out, f"{combiner}(list({src}))", "plain",
                        f"{op} over a stacked local value")
        self.bind(stage.node, out)

    def emit_transfer(self, stage: Transfer):
        """A transfer on a keyed collection re-keys each element to its
        destination stage (rotating with ``wrap``, else dropping the ones
        that fall off the edge and creating zero elements for the vacated
        stages); on a stacked value it rolls the stage axis."""
        src = self.name_of(stage.node.args[0])
        out = self.fresh("tx")
        _, i = _node_placement(stage.node)
        size = self.plan.placement_sizes[i]
        shift, wrap = stage.shift, stage.wrap
        kind = self.kinds.get(src, "plain")
        tag = f"TRANSFER shift={shift:+d} @{stage.placement}"
        if kind != "group":
            if kind == "server":
                self.assign(out, f"{src} | {self.label()} >> beam.Map("
                                 f"lambda v: _stage_shift(v, {i}, {shift}, "
                                 f"{wrap}))", "server", tag)
            else:
                self.assign(out, f"_stage_shift({src}, {i}, {shift}, {wrap})",
                            "plain", tag)
            self.bind(stage.node, out)
            return
        depth = self.depths.get(src, 1)
        tuple_keys = self.nested or depth > 1
        mod = f" % {size}" if wrap else ""
        if tuple_keys:
            rekey = (f"lambda kv: (kv[0][:{i}] + ((kv[0][{i}] + {shift})"
                     f"{mod},) + kv[0][{i + 1}:], kv[1])")
            in_range = f"lambda kv: 0 <= kv[0][{i}] < {size}"
        else:
            rekey = f"lambda kv: ((kv[0] + {shift}){mod}, kv[1])"
            in_range = f"lambda kv: 0 <= kv[0] < {size}"
        if wrap:
            self.assign(out, f"{src} | {self.label()} >> beam.Map({rekey})",
                        "group", f"{tag} (rotate stage keys)")
        else:
            moved = self.fresh("mv")
            self.assign(moved, f"{src} | {self.label()} >> beam.Map({rekey}) "
                               f"| {self.label()} >> beam.Filter({in_range})",
                        "group", f"{tag} (shift stage keys)")
            val = _val(stage.node)
            elem = tuple(val.shape[depth:])
            dt = str(val.dtype).replace("torch.", "")
            dt = "float32" if dt == "bfloat16" else dt
            zeros_expr = f"np.zeros({elem!r}, np.dtype({dt!r}))"
            vac = (f"range({min(shift, size)})" if shift > 0
                   else f"range({max(size + shift, 0)}, {size})")
            if tuple_keys:
                sizes = tuple(self.plan.placement_sizes[:depth])
                keys = (f"[k0 + (j,) + k1 for k0 in np.ndindex(*{sizes[:i]!r}) "
                        f"for j in {vac} for k1 in "
                        f"np.ndindex(*{sizes[i + 1:]!r})]")
            else:
                keys = f"[j for j in {vac}]"
            zeros = self.fresh("zf")
            self.assign(zeros, f"p | {self.label()} >> beam.Create("
                               f"[(k, {zeros_expr}) for k in {keys}])",
                        "group", f"{tag} (zero-fill vacated stages)")
            self.assign(out, f"({moved}, {zeros}) | {self.label()} >> "
                             "beam.Flatten()", "group", tag)
        self.depths[out] = depth
        self.bind(stage.node, out)

    def emit_local(self, stage: LocalCompute, plan, sname: str, outs):
        in_names = [self.name_of(a) for a in _stage_reads(stage)]
        raw = self.fresh("o")
        if stage.at_groups:
            self.emit_group_stage(sname, in_names, raw)
            k = self.depths.get(raw, 1)
            unwrap = repr((0,) * k)
            project = "lambda kv, _j={j}: (kv[0], kv[1][_j][" + unwrap + "])"
        else:
            self.emit_server_stage(sname, in_names, raw)
            project = "lambda _t, _j={j}: _t[_j]"
        for j, o in enumerate(outs):
            name = self.fresh("t")
            if self.kinds[raw] == "plain":
                self.assign(name, f"{raw}[{j}]", "plain")
            else:
                self.assign(name, f"{raw} | {self.label()} >> "
                                  f"beam.Map({project.format(j=j)})",
                            self.kinds[raw])
                self.depths[name] = self.depths.get(raw, 1)
            self.bind(o, name)

    def emit_server_stage(self, sname: str, in_names: List[str], raw: str):
        kinds = [self.kinds.get(n, "plain") for n in in_names]
        if "server" not in kinds:
            self.assign(raw, f"fns['{sname}']({', '.join(in_names)})", "plain",
                        f"SERVER_COMPUTE {sname} (driver-side)")
            return
        main = kinds.index("server")
        params, extras, exprs = ["_v"], [], [""] * len(in_names)
        exprs[main] = "_v"
        for i, (n, k) in enumerate(zip(in_names, kinds)):
            if i == main:
                continue
            params.append(f"_a{i}")
            exprs[i] = f"_a{i}"
            extras.append(f"beam.pvalue.AsSingleton({n})" if k == "server"
                          else n)
        extra = (", " + ", ".join(extras)) if extras else ""
        self.assign(raw, f"{in_names[main]} | {self.label()} >> beam.Map("
                         f"lambda {', '.join(params)}: fns['{sname}']"
                         f"({', '.join(exprs)}){extra})",
                    "server", f"SERVER_COMPUTE {sname}")

    def emit_group_stage(self, sname: str, in_names: List[str], raw: str):
        """Keyed on the deepest group input; shallower group inputs join by
        key prefix, server values are singleton side inputs, and each group
        element is lifted to its own number of leading group axes."""
        kinds = [self.kinds.get(n, "plain") for n in in_names]
        depths = [self.depths.get(n, 1) if k == "group" else 0
                  for n, k in zip(in_names, kinds)]
        main, main_depth = None, 0
        for n, k, d in zip(in_names, kinds, depths):
            if k == "group" and d > main_depth:
                main, main_depth = n, d
        if main is None:
            main, main_depth = "groups", self.depths["groups"]
        params, extras, exprs = ["kv"], [], []
        used = False
        for n, k, d in zip(in_names, kinds, depths):
            if n == main and not used:
                used = True
                exprs.append(f"_lift(kv[1], {main_depth})")
            elif k == "group":
                p = f"_d{len(params)}"
                params.append(p)
                key = f"kv[0][:{d}]" if (self.nested or main_depth > 1) \
                    else "kv[0]"
                exprs.append(f"_lift({p}[{key}], {d})")
                extras.append(f"beam.pvalue.AsDict({n})")
            elif k == "server":
                p = f"_s{len(params)}"
                params.append(p)
                exprs.append(p)
                extras.append(f"beam.pvalue.AsSingleton({n})")
            else:
                p = f"_x{len(params)}"
                params.append(p)
                exprs.append(p)
                extras.append(n)
        extra = (", " + ", ".join(extras)) if extras else ""
        self.assign(raw, f"{main} | {self.label()} >> beam.Map(lambda "
                         f"{', '.join(params)}: (kv[0], fns['{sname}']"
                         f"({', '.join(exprs)})){extra})",
                    "group", f"GROUP_COMPUTE {sname} (per group)")
        self.depths[raw] = main_depth

    def _bind_body(self, binders, names):
        for b, nm in zip(binders, names):
            self.bind(b, nm)

    def _loop_carries(self, atoms, path: str, what: str) -> List[str]:
        out = []
        for a in atoms:
            nm = self.fresh(f"carry{path}_")
            src = self.name_of(a)
            self.assign(nm, src, self.kinds.get(src, "plain"),
                        f"{what} {path} carry init")
            out.append(nm)
        return out

    def _group_binders(self, body: MapReducePlan, n: int):
        """Rebind the first ``n`` body inputs the body treats as
        partitioned to keyed per-group collections."""
        for b, part in zip(body.invars[:n], body.partitioned_invars[:n]):
            if part and self.kinds.get(self.names[b]) != "group":
                self.bind(b, self.to_group(self.names[b]))

    def emit_loop(self, stage: LoopStage, path: str, outs):
        body = stage.body_plan
        loop_var = f"i{path.replace('_', '')}"
        carry_names = self._loop_carries(stage.carry, path, "loop")
        add_names = [self.name_of(a) for a in stage.additional]
        nc = len(carry_names)
        if stage.loop_kind == "scan":
            ys_names = []
            for _ in range(len(body.out_atoms) - nc):
                nm = self.fresh(f"ys{path}_")
                self.line(f"{nm} = []  # (iteration, value) pairs")
                self.kinds[nm] = "plain"
                ys_names.append(nm)
            xs_names = [self.name_of(a) for a in stage.xs]
            self.line(f"for {loop_var} in range({stage.trip_count}):  # "
                      f"LOOP[scan] {path}: one communication round per "
                      "iteration")
        else:
            ys_names, xs_names = [], []
            iters = f"num_iters_{path}"
            self.line(f"{iters} = 1  # LOOP[while] {path}: dynamic trip count "
                      "- resolve at driver time and rebuild")
            self.line(f"for {loop_var} in range({iters}):")
        self._indent += 1
        self._loop_vars.append(loop_var)
        saved = dict(self.names)
        slice_names = []
        xs_binders = body.invars[nc:nc + len(xs_names)]
        for b, xs_name in zip(xs_binders, xs_names):
            nm = self.fresh("x")
            kind = self.kinds.get(xs_name)
            if kind == "group":
                self.assign(nm, f"{xs_name} | {self.label()} >> beam.Map("
                                f"lambda kv, _i={loop_var}: (kv[0], "
                                "kv[1][_i]))", "group",
                            "xs slice for this iteration")
            elif kind == "server":
                self.assign(nm, f"{xs_name} | {self.label()} >> beam.Map("
                                f"lambda v, _i={loop_var}: v[_i])", "server",
                            "xs slice for this iteration")
            else:
                self.assign(nm, f"{xs_name}[{loop_var}]", "plain",
                            "xs slice for this iteration")
            slice_names.append(nm)
        self._bind_body(body.invars, carry_names + slice_names + add_names)
        self._group_binders(body, len(body.invars))
        self.emit_plan_stages(body, f"{path}_")
        new = [self.name_of(a) for a in body.out_atoms[:nc]]
        for nm, val in zip(carry_names, new):
            self.assign(nm, val, self.kinds.get(val, "plain"), "carry update")
        ys_kinds = []
        for nm, a in zip(ys_names, body.out_atoms[nc:]):
            val = self.name_of(a)
            if self.kinds.get(val) == "group":
                val = self.to_server(val)
            k = self.kinds.get(val, "plain")
            ys_kinds.append(k)
            if k == "server":
                self.line(f"{nm}.append({val} | {self.label()} >> beam.Map("
                          f"lambda v, _i={loop_var}: (_i, v)))")
            else:
                self.line(f"{nm}.append(({loop_var}, {val}))")
        self._loop_vars.pop()
        self._indent -= 1
        self.names = saved
        results = carry_names + ys_names
        self.bind(stage.node, f"[{', '.join(results)}]")
        for g in stage.getitems:
            j = g.args[1]
            if j < nc:
                self.bind(g, carry_names[j])
                continue
            nm, k = ys_names[j - nc], ys_kinds[j - nc]
            st = self.fresh("t")
            if k == "server":
                self.assign(st, f"(tuple({nm}) | {self.label()} >> "
                                f"beam.Flatten() | {self.label()} >> "
                                f"beam.combiners.ToList() | {self.label()} >> "
                                "beam.Map(lambda rows: np.stack([v for _, v in "
                                "sorted(rows)])))", "server",
                            "stack per-iteration outputs")
            else:
                self.assign(st, f"np.stack([v for _, v in sorted({nm})])",
                            "plain", "stack per-iteration outputs")
            self.bind(g, st)

    def emit_cond(self, stage: CondStage, path: str):
        idx = self.name_of(stage.node.args[0])
        self.line(f"# COND {path}: branch index lives in {idx}; a real "
                  "driver materializes it and builds one branch")
        ops = list(stage.node.args[3])
        branch_outs: List[List[str]] = []
        for b, bp in enumerate(stage.branch_plans):
            self.line(f"# -- branch {b} --")
            saved = dict(self.names)
            self._bind_body(bp.invars, [self.name_of(a) for a in ops])
            self.emit_plan_stages(bp, f"{path}_b{b}_")
            branch_outs.append([self.name_of(a) for a in bp.out_atoms])
            self.names = saved
        for g in stage.getitems:
            j = g.args[1]
            nm = self.fresh("t")
            picks = ", ".join(outs[j] for outs in branch_outs)
            self.assign(nm, f"[{picks}][int(np.asarray({idx}))] if not "
                            f"isinstance({idx}, beam.pvalue.PCollection) "
                            f"else [{picks}][0]",
                        self.kinds.get(branch_outs[0][j], "plain"),
                        "cond output (select branch)")
            self.bind(g, nm)


def _literal_src(val) -> str:
    if isinstance(val, bool) or val is None:
        return repr(val)
    if isinstance(val, int):
        return f"np.int64({val})"
    if isinstance(val, float):
        return f"np.float32({val!r})"
    if isinstance(val, torch.Tensor):
        arr = val.detach().to(torch.float32).cpu().numpy() \
            if val.dtype == torch.bfloat16 else val.detach().cpu().numpy()
        return f"np.asarray({arr.tolist()!r}, dtype=np.{arr.dtype})"
    return repr(val)
