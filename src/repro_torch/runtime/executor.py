"""Compiled plan executor (``repro/runtime/executor.py``).

``run_plan`` (the §5 oracle) walks a plan node by node from Python, the
host owning control flow: the reference semantics, and on one card a
round whose device waits on the host between launches. This module
compiles a plan for repeated rounds:

* :func:`fuse_stages`: adjacent ``GROUP_COMPUTE``/``SERVER_COMPUTE``
  stages merge into one :class:`FusedCompute` unit, as the reference
  fuses them inside one executable.
* :func:`compile_plan` / ``plan.compile()`` -> :class:`CompiledPlan`. The
  plan's stages split into units: a run of local and communication stages
  is one unit, an FX ``GraphModule`` over the run's nodes; a loop
  (``while`` or ``scan``) or a ``cond`` is a host unit that runs its
  sub-plans' units, a loop's body once per iteration. On the CPU the
  units run as they are, bitwise equal to :func:`run_plan` (the same nodes
  in the same order). On the card each unit is captured once into a
  ``torch.cuda.CUDAGraph`` after a warm-up run (which also builds the
  kernels, outside the capture) and replayed (:class:`CudaGraphs`: the
  warm-up's kernel launches count, the capture's and the replays' do
  not); each call copies its inputs into the unit's static buffers. A
  round with no host control flow is therefore one CUDA graph, the
  counterpart of the reference's one executable. A ``while`` reads its predicate on the host and replays its
  body's graph; a ``scan`` replays its body's graph once per iteration; a
  ``cond`` reads its branch index on the host. What the executor cannot
  capture (a node that reads a value on the host, such as ``.item()``,
  inside a unit) raises at compile time; nothing falls back to eager
  execution.
* A ``TRANSFER`` stage (a pipeline's neighbour exchange) is inline like
  a broadcast or a reduce: it runs inside its unit, one CUDA graph with
  the local stages around it.
* An executable cache keyed by ``(plan fingerprint, device, argument
  shapes and dtypes, donation)``: a plan built again from a new trace of
  the same program is a hit and captures nothing new
  (:func:`plan_fingerprint` hashes the canonical graph code, placements
  and their kinds, stage skeleton and constant bytes: a stage stack and a
  replica stack of the same sizes never share an executable).
* Donation: ``donate_argnums`` marks carried arguments (params, server
  state), and the plan returns its carry first: donated argument ``i``
  takes output ``i``, which must have its shape and dtype. After a call
  each donated argument holds its output's value, updated in place, and
  is returned in that output's place: what JAX's buffer donation buys (no
  second copy of the carried state). The writes come after the last
  stage, so no stage reads an overwritten argument. Outputs that share
  memory with a donated argument (an input passed through) are copied
  before the first write. No other input is written. A donation the
  donation pass calls an error (``CompiledPlan.donation_report``) raises
  at compile time.
* :class:`ElasticHierarchicalRound`: a pod-hierarchical round compiled per
  placement level. The per-client leg is one compiled plan of the
  per-pod program (``clients_per_pod`` groups), traced once and called
  once per pod, whatever the pod count; the cross-pod leg (the mean of the
  stacked pod partials and the server update) is one unit per distinct
  set of argument shapes and dtypes, that is per pod count.
* On a mesh (``compile_plan(plan, mesh=, placement_axes=)``, a
  ``DeviceMesh`` and ``{placement: mesh dim(s)}``, the reference's
  ``_make_constrainer``): the plan's partitioned inputs are placed as
  DTensors on their levels' mesh dims, ``GROUP_COMPUTE`` stages run on
  each rank's own groups (a map node on the local shards), and
  ``BROADCAST``/``REDUCE``/``TRANSFER`` stages run as the primitives'
  collectives (``core/sharding.py``). Such a plan runs its stages eagerly,
  by design: a CUDA graph cannot hold a collective of the gloo backend,
  and the DTensor dispatch is host work. A plan with a loop or a cond
  stage is refused on a mesh at compile time. The executable cache keys
  the mesh too (:func:`_mesh_key`: dim names, shape, rank identity and
  the placement axes).
* ``ElasticHierarchicalRound.step(mesh=)`` is the physical elastic path:
  every rank of pod row p runs pod p's client leg (one trace), the pod
  partials enter the cross leg sharded over the pod dim, the cross leg is
  cached per (argument shapes, mesh), and on a mesh change the server
  state migrates by a broadcast from the lowest rank that holds it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.fx as fx
from torch.utils import _pytree as pytree

from ..core import interpreter as interp
from ..kernels import ops

__all__ = [
    "CompiledPlan",
    "CudaGraphs",
    "ElasticHierarchicalRound",
    "FusedCompute",
    "TraceCounter",
    "clear_executor_cache",
    "compile_plan",
    "executor_cache_size",
    "fingerprint_parts",
    "fuse_stages",
    "plan_fingerprint",
]

# Nodes that read a device value on the host: a CUDA graph cannot hold them.
_HOST_READS = {"_local_scalar_dense", "item", "nonzero", "masked_select",
               "unique", "_unique2", "unique_consecutive", "unique_dim"}


class TraceCounter:
    """Counts how many times a wrapped function runs: wrapped around an
    executable's build, it counts builds (1 after the first round, and
    no more across rounds)."""

    def __init__(self):
        self.count = 0

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)

        return wrapped


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def _graph_code(gm: fx.GraphModule, prefix: str = "") -> List[str]:
    """The generated code of a graph and of every sub-graph it applies,
    depth-first by attribute name: canonical for one program's traces."""
    out = [prefix + gm.code]
    for name, sub in sorted(gm.named_children()):
        if isinstance(sub, fx.GraphModule):
            out.extend(_graph_code(sub, f"{prefix}{name}."))
    return out


def fingerprint_parts(plan) -> List[Tuple[str, bytes]]:
    """The named byte components :func:`plan_fingerprint` hashes, in
    order: placements, input/output depths, the graph code, the stage
    skeleton, the placements' kinds and every constant's shape, dtype and
    bytes."""
    parts: List[Tuple[str, bytes]] = [
        ("placements", str(plan.placements).encode()),
        ("partitioned_invars", str(plan.partitioned_invars).encode()),
        ("partitioned_outvars", str(plan.partitioned_outvars).encode()),
        ("graph", "\n".join(_graph_code(plan.gm)).encode()),
        ("stage_skeleton", "|".join(
            f"{name}:{s.kind}" for name, s, _ in plan.named_stages()).encode()),
        ("placement_kinds", str(plan.placement_kinds).encode()),
    ]
    for i, (_, val) in enumerate(interp._const_table(plan)):
        t = val.detach().cpu().contiguous().reshape(-1)
        parts.append((f"const[{i}]",
                      str((tuple(val.shape), str(t.dtype))).encode()
                      + t.view(torch.uint8).numpy().tobytes()))
    return parts


def plan_fingerprint(plan) -> str:
    """Structural hash of a plan: two plans built from separate traces of
    the same program at the same shapes share it."""
    h = hashlib.sha1()
    for _, data in fingerprint_parts(plan):
        h.update(data)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# stage fusion
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FusedCompute:
    """A maximal run of adjacent LocalCompute stages, fused into one unit."""

    nodes: List[fx.Node]
    kinds: Tuple[str, ...]

    @property
    def kind(self) -> str:
        return "FUSED_COMPUTE"


def fuse_stages(stages: Sequence[Any]) -> List[Any]:
    """Merge adjacent LocalCompute stages (any placement) into FusedCompute."""
    out: List[Any] = []
    for s in stages:
        if isinstance(s, interp.LocalCompute):
            if out and isinstance(out[-1], FusedCompute):
                out[-1].nodes.extend(s.nodes)
                out[-1].kinds = out[-1].kinds + (s.kind,)
            else:
                out.append(FusedCompute(nodes=list(s.nodes), kinds=(s.kind,)))
        else:
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def _inline(stage) -> bool:
    """Does ``stage`` run inside a captured unit (no host control flow)?"""
    return isinstance(stage, (interp.LocalCompute, interp.Broadcast,
                              interp.Reduce, interp.Transfer))


def _runs(io) -> List[List[int]]:
    """The plan's units, as runs of stage indices: each maximal run of
    inline stages, and each control stage alone."""
    runs: List[List[int]] = []
    for i, (stage, _, _) in enumerate(io):
        if _inline(stage) and runs and _inline(io[runs[-1][-1]][0]):
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def _sub_plans(stage) -> List[Any]:
    if isinstance(stage, interp.CondStage):
        return list(stage.branch_plans)
    return [p for p in (stage.cond_plan, stage.body_plan) if p]


def _check(plan, device: str) -> int:
    """The plan's structure, checked without building anything: raises
    where a unit for ``device`` cannot be captured, else returns the
    number of units at the plan's top level."""
    io = plan.stage_io()
    runs = _runs(io)
    for run in runs:
        stages = [io[i][0] for i in run]
        if not _inline(stages[0]):
            for sub in _sub_plans(stages[0]):
                _check(sub, device)
        elif device == "cuda":
            _check_capturable(plan, stages)
    return len(runs)


def _check_capturable(plan, stages) -> None:
    for stage in stages:
        nodes = (stage.nodes if isinstance(stage, interp.LocalCompute)
                 else [stage.node])
        for n in nodes:
            name = interp._op_name(n)
            if name in _HOST_READS:
                raise NotImplementedError(
                    f"compile_plan: node {n.name} ({name}) reads a device "
                    "value on the host, which a CUDA graph cannot capture")
            for sub in interp._subgraphs(n, plan.gm):
                for m in sub.graph.nodes:
                    if (m.op == "call_function"
                            and interp._op_name(m) in _HOST_READS):
                        raise NotImplementedError(
                            f"compile_plan: node {m.name} inside "
                            f"{n.name} reads a device value on the host, "
                            "which a CUDA graph cannot capture")


class CudaGraphs:
    """``fn`` run as one CUDA graph per key on the card (``device``), and
    eagerly on the CPU: the capture helper of the compiled plan's units and
    of the serve steps (``launch/steps.py``).

    ``graphs(key, *args)``: ``args`` are buffers the caller owns, the same
    tensors at every call of a key, written before the call. The first call
    of a key counts on ``counter`` (when given) and, on the card, runs
    ``fn`` on a side stream (kernel builds and first-call setup stay
    outside the capture), then captures it over the same buffers. With
    ``replay_first`` the capture is then replayed and its outputs are the
    call's; without it the side-stream run was the call's work, and its
    outputs are returned. Every later call of the key replays. The
    capture's kernel calls stay off the wrappers' counters
    (``ops.uncounted``: recorded, not launched); each replay adds them to
    ``replayed`` (kernel name -> launches), which the counters never see.
    On the CPU every call runs ``fn`` eagerly."""

    def __init__(self, fn: Callable, *, device,
                 counter: Optional["TraceCounter"] = None,
                 replay_first: bool = False):
        self.fn = fn
        self.device = torch.device(device)
        self.counter = counter
        self.replay_first = replay_first
        self.graphs: Dict[Any, Optional[tuple]] = {}
        self.replays = 0
        self.replayed: Dict[str, int] = {}
        self._side: Optional[torch.cuda.Stream] = None

    def __call__(self, key, *args):
        if key not in self.graphs:
            if self.counter is not None:
                self.counter.count += 1
            if self.device.type != "cuda":
                self.graphs[key] = None
                return self.fn(*args)
            out = self._capture(key, args)
            if not self.replay_first:
                return out
        entry = self.graphs[key]
        if entry is None:
            return self.fn(*args)
        graph, out, launched = entry
        graph.replay()
        self.replays += 1
        for name, n in launched.items():
            self.replayed[name] = self.replayed.get(name, 0) + n
        return out

    def _capture(self, key, args):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side, main = self._side, torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with ops.uncounted() as launched, torch.cuda.graph(
                graph, stream=side, capture_error_mode="global"):
            captured = self.fn(*args)
        self.graphs[key] = (graph, captured, launched)
        return out


class _Graphed:
    """A unit on the card: each call copies its tensors into static
    buffers (cloned at the first call) and replays the unit's one CUDA
    graph (:class:`CudaGraphs`, captured at the first call)."""

    def __init__(self, fn: Callable):
        self.graphs = CudaGraphs(lambda *xs: list(fn(*xs)), device="cuda",
                                 replay_first=True)
        self.static_in: Optional[List[torch.Tensor]] = None

    def __call__(self, *args):
        if self.static_in is None:
            for a in args:
                if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
                    raise TypeError("a captured unit takes CUDA tensors only, "
                                    f"got {type(a).__name__}")
            self.static_in = [a.detach().clone() for a in args]
        else:
            for s, a in zip(self.static_in, args):
                s.copy_(a)
        return self.graphs(None, *self.static_in)


class _Program:
    """A plan compiled into units, run on flat inputs."""

    def __init__(self, plan, device: str):
        self.plan = plan
        self.device = device
        self.units: List[Tuple[Callable, List[fx.Node], List[fx.Node]]] = []
        io = plan.stage_io()
        final = {a for a in plan.out_atoms if isinstance(a, fx.Node)}
        runs = _runs(io)
        for k, run in enumerate(runs):
            stages = [io[i][0] for i in run]
            defined = set()
            for s in stages:
                defined.update(interp._stage_writes(s))
            ins: List[fx.Node] = []
            for i in run:
                for a in io[i][1]:
                    if a not in defined and a not in ins:
                        ins.append(a)
            later = set(final)
            for other in runs[k + 1:]:
                for i in other:
                    later.update(io[i][1])
            outs = [w for s in stages for w in interp._stage_writes(s)
                    if w in later]
            self.units.append((self._unit(stages, ins, outs), ins, outs))

    def _unit(self, stages, ins, outs) -> Callable:
        if not _inline(stages[0]):
            return self._host(stages[0], outs)
        nodes = [n for s in stages for n in
                 (s.nodes if isinstance(s, interp.LocalCompute) else [s.node])]
        fn = interp.stage_module(self.plan.gm, nodes, ins, outs)
        return _Graphed(fn) if self.device == "cuda" else fn

    def _host(self, stage, outs) -> Callable:
        """A loop (a ``while``'s predicate read on the host, a ``scan``'s
        body once per iteration) or a ``cond`` (branch index read on the
        host): the sub-plans run as compiled programs of their own."""
        subs = {id(p): _Program(p, self.device) for p in _sub_plans(stage)}
        ins = interp._control_inputs(stage)

        def execute(plan, args):
            return [_own(v) for v in subs[id(plan)](list(args))]

        def run(*vals):
            env = dict(zip(ins, vals))

            def read(a):
                return _read(self.plan.gm, env, a)

            if isinstance(stage, interp.LoopStage):
                res = interp._run_loop(stage, read, execute)
            else:
                res = interp._run_cond(stage, read, execute)
            picked = {stage.node: res}
            for g in stage.getitems:
                picked[g] = res[g.args[1]]
            return [picked[o] for o in outs]

        return run

    def __call__(self, args: Sequence[Any]) -> List[Any]:
        env: Dict[fx.Node, Any] = dict(zip(self.plan.invars, args))
        for fn, ins, outs in self.units:
            vals = fn(*[env[a] for a in ins])
            env.update(zip(outs, vals))
        return [_read(self.plan.gm, env, a) for a in self.plan.out_atoms]


def _read(root, env, a):
    """A node's value in a unit program: an input or a unit's output, a
    constant of the graph, or a literal."""
    if not isinstance(a, fx.Node):
        return a
    if a.op == "get_attr":
        return interp._attr(root, a.target)
    return env[a]


def _own(v):
    """A value that outlives the next replay of the graph that made it."""
    return v.clone() if isinstance(v, torch.Tensor) and v.is_cuda else v


# ---------------------------------------------------------------------------
# cache + CompiledPlan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CacheEntry:
    program: _Program
    counter: TraceCounter


_EXEC_CACHE: Dict[Any, _CacheEntry] = {}


def clear_executor_cache() -> None:
    _EXEC_CACHE.clear()


def executor_cache_size() -> int:
    return len(_EXEC_CACHE)


def _arg_key(args) -> Tuple:
    return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                 else (type(a).__name__, a) for a in args)


def _mesh_key(mesh, placement_axes=None) -> Tuple:
    """A mesh's cache key: dim names and sizes, the ranks (identity: the
    same shape re-mapped onto other ranks after a pod dropped is another
    mesh) and the placement axes."""
    from .. import compat

    if mesh is None:
        return (None, None, None)
    return (tuple(zip(compat.mesh_axis_names(mesh), compat.mesh_shape(mesh))),
            compat.mesh_ranks(mesh),
            tuple(sorted((placement_axes or {}).items())))


class _MeshProgram:
    """A plan run on a mesh, stage by stage (``compile_plan(mesh=)``):
    inputs placed at their depths, local stages on DTensors (a map node
    on each rank's own groups), communication stages as the primitives'
    collectives under a context of the node's own stack, the plan's
    placement axes and the mesh. Replicated outputs come back as the
    plain tensors every rank holds."""

    def __init__(self, plan, mesh, placement_axes):
        from ..core import placement as placement_lib

        self.plan, self.mesh = plan, mesh
        self.axes = dict(placement_axes or {})
        self.ctx = self._context(tuple(
            placement_lib.Placement(n, s, kind=k)
            for (n, s), k in zip(plan.placements, plan.placement_kinds)))

    def _context(self, levels):
        from ..core import placement as placement_lib

        return placement_lib.PlacementContext(
            placements=tuple(dataclasses.replace(p, axes=self.axes.get(p.name))
                             for p in levels), mesh=self.mesh)

    def _comm(self, stage, x):
        from ..core import placement as placement_lib
        from ..core import primitives as prims

        node = stage.node
        ctx = self._context(prims.parse_placements(node.args[1]))
        name = ctx.names[node.args[2]]
        with placement_lib.placement_context(ctx):
            if isinstance(stage, interp.Broadcast):
                return prims.broadcast(x, placement=name)
            if isinstance(stage, interp.Transfer):
                return prims.stage_transfer(x, placement=name,
                                            shift=node.args[3],
                                            wrap=node.args[4])
            if stage.op == "reduce_mean":
                extra = list(node.args[3:5])
                return prims.reduce_mean(
                    x, placement=name,
                    compress=extra[0] if extra else None,
                    qaxis=extra[1] if len(extra) > 1 else -1)
            return getattr(prims, stage.op)(x, placement=name)

    def __call__(self, args: Sequence[Any]) -> List[Any]:
        from torch.distributed.tensor.experimental import implicit_replication

        from ..core import sharding

        placed = [sharding.constrain_partitioned(a, self.ctx, d)
                  if d > 0 and isinstance(a, torch.Tensor) else a
                  for a, d in zip(args, self.plan.partitioned_invars)]
        env = interp._Env(self.plan, placed)
        with implicit_replication():
            for stage in self.plan.stages:
                if isinstance(stage, interp.LocalCompute):
                    for node in stage.nodes:
                        env.run(node)
                else:
                    x = env.read(stage.node.args[0])
                    env.write(stage.node, self._comm(stage, x))
                    env.consumed(stage.node)
            outs = [env.read(a) for a in self.plan.out_atoms]
        return sharding.unwrap_replicated(outs)


class CompiledPlan:
    """A plan compiled for repeated rounds on one device (lazily, per
    argument shapes). ``trace_count`` is how many times the active entry
    was built: 1 after the first round, and no more across rounds.
    ``num_units`` counts its executable units (captured graphs and host
    control units), ``num_stage_units`` the plan's stages after fusion."""

    def __init__(self, plan, *, device: str, donate_argnums=(), mesh=None,
                 placement_axes=None):
        if device not in ("cpu", "cuda"):
            raise ValueError(f"compile_plan: unsupported device {device!r}")
        self.plan = plan
        self.device = device
        self.donate_argnums = tuple(donate_argnums)
        self.mesh = mesh
        self.placement_axes = dict(placement_axes or {})
        self.fingerprint = plan_fingerprint(plan)
        self._entry: Optional[_CacheEntry] = None
        if mesh is not None:
            control = [st for st in plan.stages if not _inline(st)]
            if control:
                raise ValueError(
                    "compile_plan(mesh=): a plan with a loop or a cond stage "
                    f"({type(control[0]).__name__}) runs on one rank's whole "
                    "groups; on a mesh only straight-line plans compile")
        # Donation and structure are checked now: a donation the executor
        # cannot honour, or a plan that cannot be captured, raises here,
        # at compile time, before any round and any write.
        if self.donate_argnums:
            errors = self.donation_report().errors
            if errors:
                raise ValueError("; ".join(f.message for f in errors))
        self.num_units = _check(plan, device)

    def donation_report(self):
        """The donation pass (``analysis.donation``) over this plan with
        its ``donate_argnums``: what this compiled plan does with them."""
        from ..analysis import donation_report

        return donation_report(self)

    def _entry_for(self, args) -> _CacheEntry:
        key = (self.fingerprint, self.device, _arg_key(args),
               self.donate_argnums,
               _mesh_key(self.mesh, self.placement_axes))
        entry = _EXEC_CACHE.get(key)
        if entry is None:
            counter = TraceCounter()
            program = counter.wrap(
                lambda: _Program(self.plan, self.device) if self.mesh is None
                else _MeshProgram(self.plan, self.mesh,
                                  self.placement_axes))()
            entry = _CacheEntry(program=program, counter=counter)
            _EXEC_CACHE[key] = entry
        self._entry = entry
        return entry

    def __call__(self, *args):
        for a in args:
            if isinstance(a, torch.Tensor) and a.device.type != self.device:
                raise ValueError(f"compiled for {self.device}, got a tensor "
                                 f"on {a.device}")
        outs = list(self._entry_for(args).program(list(args)))
        if self.donate_argnums:
            outs = self._donate(args, outs)
        if self.device == "cuda" and self.mesh is None:
            donated = set(self.donate_argnums)
            outs = [o if j in donated else _own(o) for j, o in enumerate(outs)]
        return outs

    def _donate(self, args, outs) -> List[Any]:
        """Donated argument ``i`` takes output ``i`` in place. Outputs that
        share memory with a donated argument are copied first, so no value
        is read after an earlier write overwrote it."""
        for i in self.donate_argnums:
            arg = args[i]
            o = outs[i] if i < len(outs) else None
            if not (isinstance(arg, torch.Tensor) and isinstance(o, torch.Tensor)
                    and o.shape == arg.shape and o.dtype == arg.dtype):
                raise ValueError(
                    f"donated argument {i} takes output {i}, which must be a "
                    f"tensor of its shape and dtype: got {_describe(arg)} and "
                    f"{_describe(o)}")
        written = {args[i].untyped_storage().data_ptr()
                   for i in self.donate_argnums}
        outs = [o.clone() if isinstance(o, torch.Tensor)
                and o.untyped_storage().data_ptr() in written else o
                for o in outs]
        for i in self.donate_argnums:
            args[i].copy_(outs[i])
            outs[i] = args[i]
        return outs

    @property
    def trace_count(self) -> int:
        return self._entry.counter.count if self._entry is not None else 0

    @property
    def num_stage_units(self) -> int:
        """Dispatch units after fusing adjacent local stages."""
        return len(fuse_stages(self.plan.stages))


def _describe(v) -> str:
    if isinstance(v, torch.Tensor):
        return f"{tuple(v.shape)} {v.dtype}"
    return "no output" if v is None else type(v).__name__


def compile_plan(plan, *, device: str = "cuda", donate_argnums=(),
                 mesh=None, placement_axes=None) -> CompiledPlan:
    """Compile a MapReducePlan for ``device`` (the card unless the caller
    asks for the CPU). The plan returns its carry first: each argument in
    ``donate_argnums`` is updated in place with the output of its index.
    ``mesh`` (a ``DeviceMesh``) and ``placement_axes`` (``{placement: mesh
    dim(s)}``) run it on a mesh, every rank of the mesh calling it."""
    return CompiledPlan(plan, device=device, donate_argnums=donate_argnums,
                        mesh=mesh, placement_axes=placement_axes)


# ---------------------------------------------------------------------------
# elastic two-leg executor (per-placement-level cache split)
# ---------------------------------------------------------------------------


class ElasticHierarchicalRound:
    """A pod-hierarchical round compiled per placement level
    (``repro/runtime/executor.py:623``).

    * The **per-client leg** (broadcast, client updates, intra-pod
      reduction) is the per-pod program ``client_fn(params, pod_data)``
      over ``clients_per_pod`` groups: traced (``core.trace``), planned and
      compiled (:func:`compile_plan`) once per set of argument shapes and
      dtypes, none of which mention the pod count, and called once per
      pod. On the card it is one CUDA graph, replayed per pod.
    * The **cross-pod leg** ``cross_fn(params, server_state, partials)``
      (the mean of the stacked pod partials and the server update) is one
      unit per set of argument shapes and dtypes, that is per pod count:
      on the card one CUDA graph each.

    When a pod drops out, the next :meth:`step` reuses the client leg as
    it is (``client_trace_count`` stays 1) and builds only a cross leg for
    the new count (``cross_compile_count``); a regrown count reuses its
    cached cross leg. ``client_trace_s`` is the seconds spent tracing,
    planning and compiling client legs (their capture runs at the first
    call).

    ``step(..., mesh=)`` is the physical path, on a ``(pod, data)``
    ``DeviceMesh`` of the surviving pods' ranks
    (``runtime.elastic.mesh_for_surviving_pods``), called by every rank of
    the world:

    * every rank of pod row p runs pod p's client leg, the same one trace
      for the whole run (the reference pins the leg to one device);
    * the pod partials enter the cross leg as DTensors sharded over the
      pod dim; the leg gathers them exactly over that dim, so every rank
      runs the same mean and server update on the same bits, and its
      cache is keyed by (argument shapes, mesh): one cross leg per mesh
      (``cross_compile_count == meshes_seen`` when the pod count follows
      the mesh). The gather stays outside the leg's CUDA graph;
    * on a mesh change the server state migrates: a broadcast along each
      mesh dim from the lowest rank of the new mesh that holds the current
      state, so a regrown pod's ranks receive it (``reshard_count``
      counts the changes, ``mesh_migrate_ms`` their broadcasts'
      milliseconds, ``meshes_seen`` the distinct meshes). Which ranks hold
      the current state is tracked across steps; after a checkpoint
      restore the caller names them (:meth:`set_state_holders`);
    * a rank outside the mesh (a dropped pod) keeps the same bookkeeping,
      takes no part in a collective and gets ``None``.
    """

    def __init__(self, client_fn: Callable, cross_fn: Callable, *,
                 clients_per_pod: int, device: str = "cuda"):
        from .. import compat

        self.client_fn = client_fn
        self.cross_fn = cross_fn
        self.clients_per_pod = clients_per_pod
        self.device = compat.resolve_device(device).type
        self._clients: Dict[Tuple, Tuple[CompiledPlan, Any]] = {}
        self._cross: Dict[Tuple, Tuple[Callable, List[Any]]] = {}
        self.client_trace_count = 0
        self.client_trace_s = 0.0
        # the physical path's bookkeeping (the same on every rank)
        self._active_key: Optional[Tuple] = None
        self._keys_seen: set = set()
        self._holders: Optional[frozenset] = None  # None: every rank
        self.reshard_count = 0
        self.mesh_migrate_ms = 0.0

    def _client_leg(self, params, pod_data):
        leaves = pytree.tree_leaves((params, pod_data))
        key = _arg_key(leaves)
        if key not in self._clients:
            t0 = time.perf_counter()
            gm = interp.trace(self.client_fn, params, pod_data)
            self.client_trace_count += 1
            depths = ([0] * len(pytree.tree_leaves(params))
                      + [1] * len(pytree.tree_leaves(pod_data)))
            plan = interp.build_plan(gm, self.clients_per_pod,
                                     partitioned_invars=depths)
            self._clients[key] = (compile_plan(plan, device=self.device),
                                  gm.out_spec)
            self.client_trace_s += time.perf_counter() - t0
        compiled, spec = self._clients[key]
        return pytree.tree_unflatten(list(compiled(*leaves)), spec)

    def _cross_leg(self, params, server_state, partials, mesh=None):
        if mesh is not None:
            from ..core import sharding

            # the pod partials, sharded over the pod dim, gathered exactly
            partials = pytree.tree_map(
                lambda x: sharding.gather_dim(x.to_local(), 0, mesh, (0,)),
                partials)
        leaves, in_spec = pytree.tree_flatten((params, server_state,
                                               partials))
        key = (_arg_key(leaves), _mesh_key(mesh))
        if key not in self._cross:
            spec: List[Any] = []
            cross_fn = self.cross_fn  # not self: no cycle holds the graph

            def flat_fn(*xs):
                out = cross_fn(*pytree.tree_unflatten(list(xs), in_spec))
                flat, out_spec = pytree.tree_flatten(out)
                spec[:] = [out_spec]
                return flat

            fn = _Graphed(flat_fn) if self.device == "cuda" else flat_fn
            self._cross[key] = (fn, spec)
        fn, spec = self._cross[key]
        outs = [_own(o) for o in fn(*leaves)]
        return pytree.tree_unflatten(outs, spec[0])

    def step(self, params, server_state, round_data, *, mesh=None):
        """One round: ``round_data`` leaves lead with (num_pods,
        clients_per_pod, ...); the pod count may change between calls.
        Returns ``cross_fn``'s outputs (new params, new server state,
        metrics). With ``mesh`` (every rank of the world calls it) the pod
        count is the mesh's first dim, and a rank outside the mesh gets
        ``None``."""
        leaves = pytree.tree_leaves(round_data)
        if not leaves:
            raise ValueError("round_data must have at least one leaf")
        num_pods = leaves[0].shape[0]
        if mesh is None:
            pod_outs = [
                self._client_leg(params, pytree.tree_map(lambda x: x[p],
                                                         round_data))
                for p in range(num_pods)]
            partials = pytree.tree_map(lambda *xs: torch.stack(xs),
                                       *pod_outs)
            del pod_outs
            return self._cross_leg(params, server_state, partials)
        from .. import compat

        if compat.mesh_shape(mesh)[0] != num_pods:
            raise ValueError(f"round data of {num_pods} pods on a mesh of "
                             f"{compat.mesh_shape(mesh)[0]} pod rows")
        coord = mesh.get_coordinate()
        params, server_state = self._adopt_mesh(mesh, coord is not None,
                                                params, server_state)
        if coord is None:
            return None
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ..core import sharding

        pod = coord[0]
        out = self._client_leg(params, pytree.tree_map(lambda x: x[pod],
                                                       round_data))
        placements = [Shard(0)] + [Replicate()] * (len(coord) - 1)

        def on_pods(x):
            shape = (num_pods,) + tuple(x.shape)
            return DTensor.from_local(
                x.unsqueeze(0), mesh, placements, run_check=False,
                shape=torch.Size(shape),
                stride=sharding.contiguous_stride(shape))

        partials = pytree.tree_map(on_pods, out)
        return self._cross_leg(params, server_state, partials, mesh)

    def _adopt_mesh(self, mesh, member: bool, params, server_state):
        """Install ``mesh`` (``repro/runtime/executor.py:734-769``): on a
        change, or where a rank of it does not hold the current state,
        the state is broadcast to its ranks from the lowest rank that
        holds it. The same bookkeeping runs on every rank."""
        from .. import compat

        key = _mesh_key(mesh)
        ranks = compat.mesh_ranks(mesh)
        changed = key != self._active_key
        holders = (set(ranks) if self._holders is None
                   else set(ranks) & self._holders)
        if changed or len(holders) < len(ranks):
            t0 = time.perf_counter()
            if member:
                params, server_state = _broadcast_tree(
                    (params, server_state), mesh, min(holders or ranks))
                if self.device == "cuda":
                    torch.cuda.synchronize()
                self.mesh_migrate_ms += (time.perf_counter() - t0) * 1e3
            if changed and self._active_key is not None:
                self.reshard_count += 1
            self._active_key = key
            self._keys_seen.add(key)
        self._holders = frozenset(ranks)
        return params, server_state

    def set_state_holders(self, ranks=None) -> None:
        """The ranks whose state is current (``None``: every rank), as
        after a restore from per-rank checkpoints: the next physical step
        broadcasts from them to any other rank of its mesh."""
        self._holders = None if ranks is None else frozenset(
            int(r) for r in ranks)

    def holds_state(self, rank: int) -> bool:
        """Does ``rank`` hold the current state before the next step (so
        that its inputs to that step are not stale)?"""
        return self._holders is None or int(rank) in self._holders

    @property
    def cross_compile_count(self) -> int:
        return len(self._cross)

    @property
    def meshes_seen(self) -> int:
        """Distinct meshes adopted so far (0 in logical mode)."""
        return len(self._keys_seen)

    def cross_meshes(self) -> List[Tuple]:
        """The mesh keys of the cross legs this rank built."""
        return [k[1] for k in self._cross]


def _broadcast_tree(tree, mesh, src: int):
    """Every tensor of ``tree`` as rank ``src`` holds it, on every rank of
    ``mesh``: one broadcast along each mesh dim, innermost first, each
    from the coordinate of ``src`` on that dim (the caller's tensors are
    copied, never written)."""
    import torch.distributed as dist

    from .. import compat

    grid = compat.mesh_grid(mesh)
    src_coord = [int(c) for c in np.argwhere(grid == src)[0]]
    coord = mesh.get_coordinate()
    leaves, spec = pytree.tree_flatten(tree)
    out = [x.detach().clone() if isinstance(x, torch.Tensor) else x
           for x in leaves]
    for d in reversed(range(len(coord))):
        at = list(coord)
        at[d] = src_coord[d]
        root = int(grid[tuple(at)])
        for x in out:
            if isinstance(x, torch.Tensor):
                dist.broadcast(x, src=root, group=mesh.get_group(d))
    return pytree.tree_unflatten(out, spec)
