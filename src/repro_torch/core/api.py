"""User-facing DrJAX API on trees of tensors (``repro/core/api.py``).

.. code-block:: python

    from repro_torch import core as drjax

    @drjax.program(partition_size=3)
    def broadcast_double_and_sum(x):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a: 2 * a, y)
        return drjax.reduce_sum(z)

Placements nest (``placements={"pods": 2, "clients": 4}``); with no
``placement=``, ``broadcast``/``reduce_*``/``map_fn`` span the whole stack.
All ops take trees (dicts, lists, tuples of tensors; ``torch.utils._pytree``)
whose every leaf carries the leading group axes.

Ported: ``program`` (with ``placement_kinds``), ``broadcast``, ``map_fn``
(recorded as one group body under ``interpreter.trace``), ``reduce_sum``,
``reduce_mean``, ``reduce_max``, ``reduce_weighted_mean``,
``masked_reduce_mean`` (the straggler rounds' reduction),
``stage_transfer`` and ``stage_map`` (pipeline stages) and
``partition_size``, with the reference's sharding switches
(``partition_axes``, ``mesh``, ``use_sharding_annotations``,
``use_spmd_axis_name``): on a ``DeviceMesh`` a partitioned value is a
DTensor sharded over its levels' mesh dims, ``map_fn`` runs its body on
each rank's own groups and the reductions are collectives
(``core/sharding.py``).
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Mapping, Optional

import torch
from torch.utils import _pytree as pytree

from .. import compat
from . import placement as placement_lib
from . import primitives as prims
from . import sharding

__all__ = [
    "program",
    "placement_context",
    "broadcast",
    "map_fn",
    "reduce_sum",
    "reduce_max",
    "reduce_mean",
    "reduce_weighted_mean",
    "masked_reduce_mean",
    "partition_size",
    "current_context",
    "stage_map",
    "stage_transfer",
]

placement_context = placement_lib.placement_context
current_context = placement_lib.current_context


def program(
    fn: Optional[Callable] = None,
    *,
    partition_size: Optional[int] = None,
    placements: Optional[Mapping[str, int]] = None,
    partition_axes=None,
    placement_kinds: Optional[Mapping[str, str]] = None,
    mesh=None,
    use_sharding_annotations: bool = True,
    use_spmd_axis_name: bool = True,
):
    """Decorator declaring a DrJAX program over ``partition_size=n`` groups
    (the paper's API, one "clients" placement) or an ordered stack
    ``placements={"pods": P, "clients": m}``, outermost first.
    ``placement_kinds`` marks levels as pipeline stages
    (``{"stages": "stages"}``): they communicate by :func:`stage_transfer`
    and :func:`stage_map` instead of broadcast/reduce; unnamed levels are
    ``"replicas"``.

    ``mesh`` (a ``DeviceMesh``, built on every rank) and ``partition_axes``
    (a mesh dim name for one placement, or ``{placement: axes}``) shard
    each level's groups over its mesh dims; every rank of the mesh calls
    the program (SPMD). Inside it, server values after a reduction are
    replicated DTensors and mix with plain tensors (implicit
    replication); it returns them as the plain tensors every rank holds,
    and a partitioned result as a DTensor. ``use_sharding_annotations=
    False`` is DrJAX-NS (Fig. 6): nothing is sharded and every rank
    computes every group."""
    if fn is not None:
        raise TypeError(
            "drjax.program requires a partition size: use "
            "@drjax.program(partition_size=n)."
        )
    if placements is not None and partition_size is not None:
        raise ValueError("Pass either partition_size or placements, not both.")
    if placements is None and partition_size is None:
        raise ValueError("partition_size (or placements) is required.")
    ctx = placement_lib.make_context(
        partition_size, placements=placements, partition_axes=partition_axes,
        placement_kinds=placement_kinds, mesh=mesh,
        use_sharding_annotations=use_sharding_annotations,
        use_spmd_axis_name=use_spmd_axis_name)

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with placement_lib.placement_context(ctx):
                if not ctx.sharded() or prims.is_recording():
                    return f(*args, **kwargs)
                from torch.distributed.tensor.experimental import (
                    implicit_replication)

                with implicit_replication():
                    out = f(*args, **kwargs)
                return sharding.unwrap_replicated(out)

        wrapped.drjax_context = ctx
        return wrapped

    return deco


def _require_replica_stack(ctx: placement_lib.PlacementContext, op: str):
    """A collective with no ``placement=`` spans the whole stack, which
    only an all-replica stack allows."""
    stages = [n for n, k in zip(ctx.names, ctx.kinds) if k == "stages"]
    if stages:
        raise ValueError(
            f"{op} with no placement= spans the whole stack, but level(s) "
            f"{stages} are stage-kind (pipeline stages do not "
            f"broadcast/reduce — use stage_transfer/stage_map). Address a "
            f"replica-kind placement explicitly with placement=<name>."
        )


def broadcast(tree, placement: Optional[str] = None):
    """Replicate a structure to every group. With ``placement=p``: one
    broadcast at that level; with none: server -> fully partitioned, one
    broadcast per level, outermost first."""
    ctx = placement_lib.current_context()
    if placement is None:
        _require_replica_stack(ctx, "broadcast")
    chain = ctx.names if placement is None else (placement,)

    def leaf(x):
        for name in chain:
            x = prims.broadcast(x, placement=name)
        return x

    return pytree.tree_map(leaf, tree)


def _reduce_tree(tree, binder, placement: Optional[str]):
    ctx = placement_lib.current_context()
    if placement is None:
        _require_replica_stack(ctx, "reduce")
    chain = tuple(reversed(ctx.names)) if placement is None else (placement,)

    def leaf(x):
        for name in chain:
            x = binder(x, placement=name)
        return x

    return pytree.tree_map(leaf, tree)


def reduce_sum(tree, placement: Optional[str] = None):
    """Sum over one level's groups, or (default) the whole stack, innermost
    level first."""
    return _reduce_tree(tree, prims.reduce_sum, placement)


def reduce_max(tree, placement: Optional[str] = None):
    """Max over one level's groups, or (default) the whole stack, innermost
    level first; the gradient is the reference's subgradient (split evenly
    over tied arg-max groups)."""
    return _reduce_tree(tree, prims.reduce_max, placement)


def reduce_mean(tree, placement: Optional[str] = None):
    """Mean over one level's groups, or (default) the whole stack as a
    mean of per-level means (equal group sizes)."""
    return _reduce_tree(tree, prims.reduce_mean, placement)


def reduce_weighted_mean(tree, weights, placement: Optional[str] = None):
    """Weighted mean over groups: ``sum_i w_i x_i / sum_i w_i``.

    ``weights`` holds one entry per group: shape ``(n,)`` under the flat
    API, or the stack-prefix shape (e.g. ``(P, m)``) when reducing a nested
    stack (no ``placement``, innermost level first) or an inner placement.
    Differentiable in both ``tree`` and ``weights``.

    When every weight is zero (a straggler mask that dropped the whole
    cohort) the result is zeros rather than 0/0 = NaN, so a fully dropped
    round leaves the server params untouched. The guard is a ``torch.where``
    over a division by a safe denominator, so the gradients stay finite.
    """
    ctx = placement_lib.current_context()
    weights = torch.as_tensor(weights)
    if placement is None:
        _require_replica_stack(ctx, "reduce_weighted_mean")
        chain = tuple(reversed(ctx.names))
        depth_in, depth_out = ctx.depth, 0
    else:
        i = ctx.index_of(placement)
        chain = (placement,)
        depth_in, depth_out = i + 1, i
    expected = tuple(ctx.sizes[:depth_in])
    if tuple(weights.shape) != expected:
        raise ValueError(
            f"reduce_weighted_mean: weights have shape {tuple(weights.shape)}, "
            f"but the reduction over placement(s) {list(ctx.names[:depth_in])} "
            f"needs one weight per group: expected shape {expected}."
        )

    def rsum(x):
        for name in chain:
            x = prims.reduce_sum(x, placement=name)
        return x

    def place(x):  # on a mesh: the rank's own groups, as the leaf's
        return sharding.constrain_partitioned(x, ctx, depth_in)

    denom = rsum(place(weights))
    all_dropped = denom == 0
    safe_denom = torch.where(all_dropped, torch.ones_like(denom), denom)

    def leaf(x):
        if x.ndim < depth_in or tuple(x.shape[:depth_in]) != expected:
            raise ValueError(
                f"reduce_weighted_mean: weights of shape "
                f"{tuple(weights.shape)} do not match a leaf of shape "
                f"{tuple(x.shape)}: the leaf's leading "
                f"{'axis' if depth_in == 1 else f'{depth_in} axes'} must be "
                f"the group axes {expected} (one entry per group of "
                f"placement(s) {list(ctx.names[:depth_in])})."
            )
        w = place(weights.reshape(expected + (1,) * (x.ndim - depth_in)))
        s = rsum(place(x) * w)
        trail = (1,) * (s.ndim - depth_out)
        dropped = all_dropped.reshape(tuple(all_dropped.shape) + trail)
        denom_b = safe_denom.reshape(tuple(safe_denom.shape) + trail)
        return torch.where(dropped, torch.zeros_like(s), s / denom_b)

    return pytree.tree_map(leaf, tree)


def masked_reduce_mean(tree, mask, placement: Optional[str] = None):
    """Mean over the groups with ``mask == 1`` (the straggler-dropping
    reduce): ``mask`` enters as the weights of
    :func:`reduce_weighted_mean`, so the reduction stays differentiable and
    an all-zero mask yields zeros, not NaN."""
    return reduce_weighted_mean(tree, mask, placement)


def map_groups(body: Callable, sizes, lead: int, *leaves, n_mapped=None):
    """Run ``body`` (one group's flat leaves -> a flat list of outputs) on
    every group's slice of the first ``n_mapped`` leaves (default: all;
    group axes ``sizes`` at axis ``lead``; the other leaves go to every
    group whole), one group after another, and stack the outputs.

    Each output leaf is allocated once, from the first group's result,
    and every group's output is copied into its slot as soon as it is
    computed: the memory a map holds is the stacked outputs plus one
    group's computation. This is the execution of a direct ``map_fn`` and
    of a recorded map node alike (the node's target)."""
    sizes = tuple(sizes)
    n = len(leaves) if n_mapped is None else n_mapped
    mapped, whole = leaves[:n], leaves[n:]
    ref = next((x for x in mapped if sharding.is_dtensor(x)), None)
    if ref is not None:
        return _map_dtensors(body, lead, len(sizes), ref, mapped, whole)
    stacked = None
    for idx in itertools.product(*(range(k) for k in sizes)):
        sel = (slice(None),) * lead + idx
        outs = body(*(x[sel] for x in mapped), *whole)
        if stacked is None:
            stacked = [torch.empty(x.shape[:lead] + sizes + x.shape[lead:],
                                   dtype=x.dtype, device=x.device)
                       for x in outs]
        elif len(outs) != len(stacked):
            raise ValueError(f"map_fn: group {idx} returned {len(outs)} "
                             f"leaves where group 0 returned {len(stacked)}")
        for buf, x in zip(stacked, outs):
            slot = buf[sel]
            if slot.shape != x.shape or buf.dtype != x.dtype:
                raise ValueError(
                    f"map_fn: group {idx} returned {x.dtype} "
                    f"{tuple(x.shape)} where group 0 returned {buf.dtype} "
                    f"{tuple(slot.shape)}")
            buf[sel] = x
        del outs  # free this group's outputs before the next group runs
    return stacked


def _map_dtensors(body: Callable, lead: int, depth: int, ref, mapped, whole):
    """A map node run on a mesh (a compiled plan's): each rank maps its
    own groups, the local shards of ``ref``'s placement; a plain mapped
    leaf is cut to the same groups, and the outputs are placed as
    ``ref``."""
    from torch.distributed.tensor import DTensor

    mesh, placements = ref.device_mesh, tuple(ref.placements)

    def local(x):
        if sharding.is_dtensor(x):
            if tuple(x.placements) != placements:
                raise ValueError("map_fn: mapped DTensors placed "
                                 f"{tuple(x.placements)} and {placements}")
            return x.to_local()
        rep = DTensor.from_local(x, mesh, compat.replicated_placements(mesh),
                                 run_check=False)
        return rep.redistribute(mesh, placements).to_local()

    locs = [local(x) for x in mapped]
    wholes = [x.to_local() if sharding.is_dtensor(x) else x for x in whole]
    d = lead + depth
    outs = map_groups(body, tuple(locs[0].shape[lead:d]), lead, *locs,
                      *wholes, n_mapped=len(locs))
    out = []
    for o in outs:
        shape = tuple(ref.shape[:d]) + tuple(o.shape[d:])
        out.append(DTensor.from_local(
            o, mesh, placements, run_check=False, shape=torch.Size(shape),
            stride=sharding.contiguous_stride(shape)))
    return out


def _under_trace() -> bool:
    from torch.fx.experimental import proxy_tensor

    return proxy_tensor.get_proxy_mode() is not None


def _in_functorch_transform() -> bool:
    return torch._C._functorch.peek_interpreter_stack() is not None


def _stack_groups(body: Callable, sizes, lead: int, *leaves):
    """``map_groups`` under a ``torch.func`` transform, where the slot
    copies into an untransformed buffer are not allowed: the same values
    as ``torch.stack`` of the per-group outputs."""
    per_group = [body(*(x[(slice(None),) * lead + idx] for x in leaves))
                 for idx in itertools.product(*(range(n) for n in sizes))]
    return [torch.stack(parts, dim=lead).reshape(
                parts[0].shape[:lead] + tuple(sizes) + parts[0].shape[lead:])
            for parts in zip(*per_group)]


class _RecordedMap(torch.autograd.Function):
    """A map recorded under a tracer: ``body`` is traced once, on group 0's
    slice, into a sub-graph, and the outer graph gets one node
    ``map_groups(body_graph, sizes, lead, *leaves)``. Its backward is
    another such node, over the body's vjp traced the same way (the
    forward recomputed inside, the arithmetic of the direct map's
    backward), so an outer gradient (MAML) flows through the map and the
    gradient program stays group-elementwise."""

    @staticmethod
    def forward(ctx, body, sizes, lead, *leaves):
        ctx.body, ctx.sizes, ctx.lead = body, sizes, lead
        ctx.needs = tuple(x.requires_grad for x in leaves)
        ctx.save_for_backward(*leaves)
        outs = tuple(_emit_map_node(body, sizes, lead, leaves))
        ctx.out_meta = [(o.shape, o.dtype, o.device) for o in outs]
        return outs

    @staticmethod
    def backward(ctx, *cts):
        leaves = ctx.saved_tensors
        needs, body = ctx.needs, ctx.body
        n = len(leaves)

        def vjp(*args):
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(args[:n], needs)]
            with torch.enable_grad():
                outs = body(*ins)
            pairs = [(o, c) for o, c in zip(outs, args[n:])
                     if o.requires_grad]
            wrt = [x for x in ins if x.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                        [c for _, c in pairs],
                                        allow_unused=True)
            grads = iter(grads)
            out = []
            for x in ins:
                if x.requires_grad:
                    g = next(grads)
                    out.append(torch.zeros_like(x) if g is None else g)
            return out

        cts = [torch.zeros(shape, dtype=dtype, device=device) if c is None
               else c for c, (shape, dtype, device) in zip(cts, ctx.out_meta)]
        grads = iter(_emit_map_node(vjp, ctx.sizes, ctx.lead,
                                    list(leaves) + cts))
        return (None, None, None) + tuple(next(grads) if need else None
                                          for need in needs)


def _emit_map_node(body, sizes, lead, leaves):
    """Trace ``body`` on group 0's slice of ``leaves`` into a sub-graph of
    the current trace and record one ``map_groups`` node over ``leaves``;
    returns the node's outputs (fake tensors of the stacked shapes).

    A value of the traced program that ``body`` closes over is lifted into
    an input of the sub-graph, which the node passes to every group whole
    (the vmap of an unbatched value). A gradient does not flow into such a
    value: one that requires it raises, to be passed as a mapped argument
    instead."""
    from torch._higher_order_ops.utils import reenter_make_fx
    from torch.fx.experimental import proxy_tensor

    mode = proxy_tensor.get_proxy_mode()
    with proxy_tensor.disable_proxy_modes_tracing():
        example = [x[(slice(None),) * lead + (0,) * len(sizes)].detach()
                   .requires_grad_(x.requires_grad) for x in leaves]
    body_graph = reenter_make_fx(lambda *xs: list(body(*xs)))(*example)
    closed = _lift_closed_over(body_graph, mode.tracer)
    root = mode.tracer.root
    name = f"map_body_{sum(1 for k in root._modules if k.startswith('map_body_'))}"
    root.register_module(name, body_graph)
    args = (body_graph, tuple(sizes), lead) + tuple(leaves) + tuple(closed)
    proxy = mode.tracer.create_proxy(
        "call_function", map_groups,
        tuple(mode.tracer.unwrap_proxy(a) if isinstance(a, torch.Tensor)
              else a for a in args), {"n_mapped": len(leaves)})
    (out_node,) = [n for n in body_graph.graph.nodes if n.op == "output"]
    lead_shape = tuple(leaves[0].shape[:lead])
    with proxy_tensor.disable_proxy_modes_tracing():
        outs = [a.meta["val"].new_empty(lead_shape + tuple(sizes)
                                        + tuple(a.meta["val"].shape))
                for a in out_node.args[0]]
    return proxy_tensor.track_tensor_tree(outs, proxy, constant=None,
                                          tracer=mode.tracer)


def recorded_scan(body: Callable, carry, xs) -> list:
    """Record one ``torch.ops.higher_order.scan`` node in the current
    trace: ``body(*carry, *x_slices) -> [*new_carry, *ys]`` traced once
    into its sub-graph, run over the leading axis of every ``xs`` leaf.
    Returns the node's outputs, ``[*carry, *stacked ys]``.

    ``scan_op`` itself traces its body below the autograd key, where a
    client step's ``torch.autograd.grad`` finds no graph; this traces it
    at the autograd level, as a map body is (:func:`_emit_map_node`), and
    emits the node ``scan_op`` would: ``(body_graph, carry, xs,
    additional)``, traced values the body closes over lifted into
    ``additional``. The carry must come out with the shapes and dtypes it
    went in with, as ``scan_op`` requires."""
    from torch._higher_order_ops.utils import reenter_make_fx
    from torch.fx.experimental import proxy_tensor

    mode = proxy_tensor.get_proxy_mode()
    with proxy_tensor.disable_proxy_modes_tracing():
        example = ([c.detach().clone() for c in carry]
                   + [x[0].detach().clone() for x in xs])
    body_graph = reenter_make_fx(lambda *a: list(body(*a)))(*example)
    closed = _lift_closed_over(body_graph, mode.tracer)
    (out_node,) = [n for n in body_graph.graph.nodes if n.op == "output"]
    out_vals = [a.meta["val"] for a in out_node.args[0]]
    for j, (c, o) in enumerate(zip(carry, out_vals)):
        if c.shape != o.shape or c.dtype != o.dtype:
            raise TypeError(
                f"scan: carry {j} enters as {c.dtype} {tuple(c.shape)} and "
                f"leaves as {o.dtype} {tuple(o.shape)}")
    root = mode.tracer.root
    name = ("scan_combine_graph_"
            f"{sum(1 for k in root._modules if k.startswith('scan_combine'))}")
    root.register_module(name, body_graph)
    args = (body_graph, list(carry), list(xs), tuple(closed))
    proxy = mode.tracer.create_proxy(
        "call_function", torch.ops.higher_order.scan,
        pytree.tree_map(mode.tracer.unwrap_proxy, args), {}, name="scan")
    length = xs[0].shape[0]
    with proxy_tensor.disable_proxy_modes_tracing():
        outs = ([o.new_empty(o.shape) for o in out_vals[:len(carry)]]
                + [o.new_empty((length,) + tuple(o.shape))
                   for o in out_vals[len(carry):]])
    return proxy_tensor.track_tensor_tree(outs, proxy, constant=None,
                                          tracer=mode.tracer)


def _lift_closed_over(body_graph, tracer) -> list:
    """Turn the sub-graph's constants that are values of the outer trace
    into trailing inputs; returns those values."""
    from torch.fx.experimental import proxy_tensor

    placeholders = [n for n in body_graph.graph.nodes if n.op == "placeholder"]
    closed = []
    for node in list(body_graph.graph.nodes):
        if node.op != "get_attr":
            continue
        val = getattr(body_graph, node.target)
        if not isinstance(val, torch.Tensor) or proxy_tensor.get_proxy_slot(
                val, tracer, None) is None:
            continue
        if val.requires_grad:
            raise NotImplementedError(
                "map_fn: the mapped function closes over a traced value "
                "that requires grad; pass it as a mapped argument")
        with body_graph.graph.inserting_after(placeholders[-1]):
            ph = body_graph.graph.placeholder(f"closed_{len(closed)}")
        ph.meta = dict(node.meta)
        node.replace_all_uses_with(ph)
        body_graph.graph.erase_node(node)
        delattr(body_graph, node.target)
        placeholders.append(ph)
        closed.append(val)
    if closed:
        body_graph.recompile()
    return closed


def map_fn(fn: Callable, tree, placement: Optional[str] = None):
    """Apply ``fn`` to every group's slice and stack the results.

    A *tuple* ``tree`` passes its elements as separate positional
    arguments. With ``placement=p`` the map runs over that level's axis
    (outputs stacked back at its position); with none it runs over every
    level of the stack (outputs carry all the group axes).

    The reference vmaps ``fn``; here the groups run one after another on
    the one device (:func:`map_groups`): the values are those of the vmap
    (each group sees its own slice) and equal ``torch.stack`` of the
    per-group outputs, and the memory a map holds is the stacked outputs
    plus one group's computation: the point on one card, where a whole
    client's training state is large. The map is differentiable (autograd
    through the slices and the slot copies); under a ``torch.func``
    transform (vmap, grad) the outputs are stacked instead.

    While a program is traced (``interpreter.trace``), the map records
    ``fn`` once, as a sub-graph applied to every group (collapsed over a
    nested stack, as the reference's ``map_fn`` at
    ``repro/core/api.py:340-370``), in one ``map_groups`` node that
    executes as the same per-group loop, so a plan's values are bitwise
    the direct map's. ``torch._higher_order_ops.map`` was tried first and
    does not serve: its eager entry compiles the body with dynamo, which
    refuses ``torch.autograd.grad`` inside it, and its ``map_impl`` runs
    the body below the autograd key, where a client step's
    ``torch.autograd.grad`` finds no graph. This node runs the body at the
    autograd level (``autograd.grad`` and non-reentrant checkpoint inside
    it trace as plain ops) and is an ``autograd.Function``, so an outer
    gradient flows through it.
    """
    ctx = placement_lib.current_context()
    if placement is None:
        lead = 0
        sizes = ctx.sizes
    else:
        lead = ctx.index_of(placement)
        sizes = (ctx.get(placement).size,)
    depth = len(sizes)

    def check(x):
        if x.ndim < lead + depth or tuple(x.shape[lead:lead + depth]) != sizes:
            raise ValueError(
                f"map_fn: a mapped leaf of shape {tuple(x.shape)} does not "
                f"carry the group axes {sizes} at axis {lead}."
            )

    pytree.tree_map(check, tree)
    leaves, in_spec = pytree.tree_flatten(tree)
    out_specs = []

    def body(*group_leaves):
        args = pytree.tree_unflatten(list(group_leaves), in_spec)
        out = fn(*args) if isinstance(tree, tuple) else fn(args)
        out_leaves, spec = pytree.tree_flatten(out)
        if out_specs and spec != out_specs[0]:
            raise ValueError("map_fn: a group returned a tree of another "
                             "structure than group 0")
        out_specs.append(spec)
        return out_leaves

    if prims.is_recording() and _under_trace():
        stacked = _RecordedMap.apply(body, sizes, lead, *leaves)
    elif ctx.sharded() and not prims.is_recording():
        stacked = _map_on_mesh(ctx, body, lead, depth, leaves)
    elif _in_functorch_transform():
        stacked = _stack_groups(body, sizes, lead, *leaves)
    else:
        stacked = map_groups(body, sizes, lead, *leaves)
    return pytree.tree_unflatten(list(stacked), out_specs[0])


def _map_on_mesh(ctx: placement_lib.PlacementContext, body: Callable,
                 lead: int, depth: int, leaves):
    """``map_fn`` on a mesh: each rank runs ``body`` on its own groups (the
    local shards) and the outputs are DTensors placed as the inputs. With
    ``use_spmd_axis_name=False`` each rank runs every group (the inputs
    gathered exactly) and keeps its own groups' outputs."""
    d = lead + depth
    local = [sharding.to_local(x, ctx, d) for x in leaves]
    if not ctx.use_spmd_axis_name:
        for i in range(d):
            local = [sharding.gather_level(x, ctx, i) for x in local]
    sizes = tuple(local[0].shape[lead:d])
    outs = map_groups(body, sizes, lead, *local)
    if not ctx.use_spmd_axis_name:
        return [sharding.constrain_partitioned(o, ctx, d) for o in outs]
    return [sharding.wrap(o, ctx, d, sharding.global_shape(o, ctx, d))
            for o in outs]


def _stage_placement_name(ctx: placement_lib.PlacementContext,
                          placement: Optional[str]) -> str:
    """The addressed stage-kind placement; with none, the stack's only
    stage-kind level."""
    if placement is not None:
        pl = ctx.get(placement)
        if pl.kind != "stages":
            raise ValueError(
                f"placement {placement!r} is {pl.kind!r}-kind, but this op "
                "requires a stage-kind placement (declare it with "
                "placement_kinds={" + f"{placement!r}: 'stages'" + "})."
            )
        return placement
    stages = ctx.stage_names()
    if not stages:
        raise ValueError(
            "no stage-kind placement in the ambient stack: declare one with "
            "placement_kinds={<name>: 'stages'}."
        )
    if len(stages) > 1:
        raise ValueError(
            f"multiple stage-kind placements {stages}: address one "
            "explicitly with placement=<name>."
        )
    return stages[0]


def stage_transfer(tree, placement: Optional[str] = None, *,
                   shift: int = 1, wrap: bool = False):
    """Shift a stage-partitioned structure to neighbouring stages:
    ``out[..., j, ...] = x[..., j - shift, ...]`` along the addressed
    stage-kind placement's axis, so stage j's activations move to stage
    j + shift (the forward hand-off for ``shift=1``). Vacated stages get
    zeros unless ``wrap=True`` (a ring). Linear: the transpose is the
    reverse transfer, so the backward pipeline falls out of autograd."""
    ctx = placement_lib.current_context()
    name = _stage_placement_name(ctx, placement)
    return pytree.tree_map(
        lambda x: prims.stage_transfer(x, placement=name, shift=shift,
                                       wrap=wrap), tree)


def stage_map(fns, tree, placement: Optional[str] = None):
    """Apply per-stage functions across a stage-partitioned structure.

    ``fns`` is one callable (applied at every stage: :func:`map_fn` at the
    stage level) or a sequence of one callable per stage (heterogeneous
    stages: stage s runs ``fns[s]`` on its slice). As with :func:`map_fn`, a
    *tuple* ``tree`` passes its elements as separate positional arguments.
    Levels outside the stage level stay mapped (each of their groups runs
    the stage function on its own slice), and the results are stacked
    back on the stage axis. On a mesh each rank runs its own stages on its
    own groups and the result is placed at the stage level's depth."""
    ctx = placement_lib.current_context()
    name = _stage_placement_name(ctx, placement)
    if callable(fns):
        return map_fn(fns, tree, placement=name)
    fns = tuple(fns)
    i = ctx.index_of(name)
    size = ctx.get(name).size
    if len(fns) != size:
        raise ValueError(
            f"stage_map: got {len(fns)} stage functions for placement "
            f"{name!r} of {size} stages (pass one callable to apply it at "
            "every stage)."
        )
    leaves, in_spec = pytree.tree_flatten(tree)
    stages = range(size)
    on_mesh = ctx.sharded() and not prims.is_recording()
    if on_mesh:  # each rank runs its own stages on its own groups
        leaves = [sharding.to_local(x, ctx, i + 1) for x in leaves]
        n_local, dims = leaves[0].shape[i], sharding.level_dims(ctx, i)
        first = n_local * sharding.block_index(ctx.mesh, dims) if dims else 0
        stages = range(first, first + n_local)
    outer = tuple(leaves[0].shape[:i]) if leaves else ctx.sizes[:i]
    out_specs = []

    def run_stage(s: int):
        fn = fns[s]

        def body(*group_leaves):
            args = pytree.tree_unflatten(list(group_leaves), in_spec)
            out = fn(*args) if isinstance(tree, tuple) else fn(args)
            out_leaves, spec = pytree.tree_flatten(out)
            out_specs.append(spec)
            return out_leaves

        sliced = [x.select(i, s - stages[0]) for x in leaves]
        if not outer:
            return body(*sliced)
        return _stack_groups(body, outer, 0, *sliced)

    per_stage = [run_stage(s) for s in stages]
    if any(spec != out_specs[0] for spec in out_specs):
        raise ValueError("stage_map: the stages returned trees of different "
                         "structures")
    stacked = [torch.stack(parts, dim=i) for parts in zip(*per_stage)]
    if on_mesh:
        stacked = [sharding.wrap(x, ctx, i + 1,
                                 sharding.global_shape(x, ctx, i + 1))
                   for x in stacked]
    return pytree.tree_unflatten(stacked, out_specs[0])


def partition_size(placement: Optional[str] = None) -> int:
    """One placement's size, or (default) the total number of innermost
    groups across the whole stack."""
    ctx = placement_lib.current_context()
    if placement is None:
        return ctx.total_size()
    return ctx.get(placement).size
