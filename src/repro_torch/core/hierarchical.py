"""Hierarchical (two-stage) reductions (``repro/core/hierarchical.py``).

At multi-pod scale the reduction crosses two interconnects: a fast one
inside a pod and a slow one across pods. The hierarchical form

    stage 1 (within pod):  n groups -> P pod partials
    stage 2 (cross pod):   P partials -> 1, optionally compressed

cuts the slow leg's bytes by n/P (and 4x more with int8). Both stages are
the DrJAX reductions of one placement stack, ``reduce_mean@clients`` then
``reduce_mean@pods``; under the flat API the ``(n, ...)`` value is regrouped
to ``(P, n/P, ...)`` and the same two run inside a derived stack.

A recognized compressor (tagged ``drjax_fused_compress = "int8"``, as
``compression.int8_roundtrip`` is) takes the fused path: the tree is
flat-packed into one ``(*groups, R, 256)`` buffer per dtype and the
intra-pod leg is one ``reduce_mean`` tagged ``compress="int8"``, whose
execution is the fused reduce+compress kernel. Gradients are identical
either way: the roundtrip is straight-through.

On a mesh the stages are the primitives' collectives (``core/sharding.py``);
the fused leg gathers each pod's clients exactly and runs the kernel on
the whole stack, and a ``compress_fn`` sees the whole pod partials (top-k
counts over all of them, as the reference's does). The flat API's derived
stack keeps the context's mesh and axes where its group counts can shard
over them (:func:`_axes_if_divisible`, the reference's m | n rule).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

from torch.utils import _pytree as pytree

from .. import compat, compression
from . import api
from . import placement as placement_lib
from . import primitives as prims
from . import sharding

_SUPER = "pods"

# Set REPRO_NO_FUSED_REDUCE=1 to force the generic two-stage composition
# even for recognized compressors. An explicit ``use_fused=True`` overrides.
_NO_FUSED_ENV = "REPRO_NO_FUSED_REDUCE"


def _axes_if_divisible(axes, groups: int, mesh):
    """A derived level keeps its mesh axes only if its group count can
    shard over them (devices | groups); otherwise it stays logical. With
    no mesh the axes are kept as documentation, and axes the mesh lacks
    are kept too, so the later placement fails loudly
    (``repro/core/hierarchical.py:50-64``)."""
    if axes is None or mesh is None:
        return axes
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes_t:
        return None
    sizes = dict(zip(compat.mesh_axis_names(mesh), compat.mesh_shape(mesh)))
    devices = 1
    for a in axes_t:
        if a not in sizes:
            return axes
        devices *= sizes[a]
    return axes if groups % devices == 0 else None


def _fusable(tree, ctx, compress_fn, use_fused: Optional[bool]) -> bool:
    """Take the fused reduce+compress path? Only for a compressor tagged
    int8 and a tree whose every leaf is a floating tensor carrying the
    stack's group axes. ``use_fused=False`` (or ``REPRO_NO_FUSED_REDUCE=1``)
    forces the generic composition; ``use_fused=True`` insists and raises
    on an unrecognized compressor."""
    tag = getattr(compress_fn, "drjax_fused_compress", None)
    if use_fused is False:
        return False
    if tag != "int8":
        if use_fused is True:
            raise ValueError(
                "use_fused=True requires a fusable compress_fn (one tagged "
                f"drjax_fused_compress='int8'); got {compress_fn!r}"
            )
        return False
    if use_fused is None and os.environ.get(_NO_FUSED_ENV, "") not in ("", "0"):
        return False
    leaves = pytree.tree_leaves(tree)
    sizes = tuple(ctx.sizes)
    for leaf in leaves:
        if not leaf.is_floating_point():
            return False
        if tuple(leaf.shape[:ctx.depth]) != sizes:
            return False
    return bool(leaves)


def _staged_reduce(tree, ctx, compress_fn, use_fused: Optional[bool]):
    """The two-stage reduction under the ambient (nested) context."""
    inner = ctx.names[-1]
    d = ctx.depth
    if _fusable(tree, ctx, compress_fn, use_fused):
        on_mesh = ctx.sharded()
        if on_mesh:  # pack each rank's own groups
            tree = pytree.tree_map(lambda x: sharding.to_local(x, ctx, d),
                                   tree)
        bufs, spec = compression.flat_pack(
            tree, lead_ndim=d, cols=compression.PACK_COLS
        )
        outs = {}
        for key, buf in bufs.items():
            if on_mesh:
                buf = sharding.wrap(buf, ctx, d,
                                    sharding.global_shape(buf, ctx, d))
            v = prims.reduce_mean(buf, placement=inner, compress="int8")
            for name in reversed(ctx.names[:-1]):
                v = prims.reduce_mean(v, placement=name)
            outs[key] = v
        out = compression.flat_unpack(sharding.unwrap_replicated(outs), spec,
                                      lead_ndim=0)
        return (sharding.constrain_tree(out, ctx, partitioned=False)
                if on_mesh else out)
    partials = api.reduce_mean(tree, placement=inner)
    if compress_fn is not None:
        if ctx.sharded():  # the compressor sees the whole partials
            whole = pytree.tree_map(
                lambda x: sharding.gather_partitioned(x, ctx, d - 1),
                partials)
            partials = sharding.constrain_tree(compress_fn(whole), ctx,
                                               partitioned=True, depth=d - 1)
        else:
            partials = compress_fn(partials)
    out = partials
    for name in reversed(ctx.names[:-1]):
        out = api.reduce_mean(out, placement=name)
    return out


def hierarchical_reduce_mean(
    tree,
    num_supergroups: Optional[int] = None,
    compress_fn: Optional[Callable] = None,
    use_fused: Optional[bool] = None,
):
    """Two-stage mean over a partitioned structure.

    ``num_supergroups`` is the number of slow-link domains (pods): required
    under the flat API (it must divide the partition size), inferred from a
    nested stack (and validated if passed). ``compress_fn`` is applied to
    the per-pod partials, the value that crosses the slow leg; an int8
    tagged one runs the fused kernel (``use_fused``: None = auto, False =
    force the composition, True = insist).
    """
    ctx = placement_lib.current_context()
    if ctx.depth >= 2:
        outer_total = math.prod(ctx.sizes[:-1])
        if num_supergroups is not None and num_supergroups != outer_total:
            raise ValueError(
                f"num_supergroups={num_supergroups} contradicts the ambient "
                f"placement stack {dict(zip(ctx.names, ctx.sizes))}, which "
                f"has {outer_total} slow-link domain(s)"
            )
        return _staged_reduce(tree, ctx, compress_fn, use_fused)

    n = ctx.partition_size
    if num_supergroups is None:
        raise ValueError(
            "num_supergroups is required under a single-placement context"
        )
    if n % num_supergroups != 0:
        raise ValueError(
            f"num_supergroups={num_supergroups} must divide partition size {n}"
        )
    per = n // num_supergroups
    inner_name = ctx.placement
    super_name = _SUPER if inner_name != _SUPER else "superpods"
    axes = ctx.axes_tuple()
    # The outermost mesh axis carries the slow (cross-pod) leg, the rest
    # stays with the per-pod groups, each only where its count shards.
    super_axes = _axes_if_divisible(axes[0] if axes else None,
                                    num_supergroups, ctx.mesh)
    inner_axes = _axes_if_divisible(axes[1:] if len(axes) > 1 else None,
                                    per, ctx.mesh)
    nested = placement_lib.PlacementContext(
        placements=(
            placement_lib.Placement(super_name, num_supergroups, super_axes),
            placement_lib.Placement(inner_name, per, inner_axes),
        ),
        mesh=ctx.mesh,
        use_sharding_annotations=ctx.use_sharding_annotations,
        use_spmd_axis_name=ctx.use_spmd_axis_name,
    )

    def regroup(leaf):
        if ctx.sharded():  # whole on every rank, then the nested placement
            leaf = sharding.gather_partitioned(leaf, ctx, 1)
        leaf = leaf.reshape((num_supergroups, per) + tuple(leaf.shape[1:]))
        return sharding.constrain_partitioned(leaf, nested, 2)

    regrouped = pytree.tree_map(regroup, tree)
    with placement_lib.placement_context(nested):
        return _staged_reduce(regrouped, nested, compress_fn, use_fused)


def int8_wire_ratio(block: int = 256) -> float:
    """Wire bytes of the packed int8 format as a fraction of f32 bytes:
    1 byte per value plus one f32 scale per ``block`` values,
    ``(1 + 4/block) / 4`` (about 0.2539 for 256), not the naive 0.25."""
    return (1.0 + 4.0 / block) / 4.0


def cross_pod_bytes(param_bytes: float, n: int, num_supergroups: int,
                    compress_ratio: float = 1.0,
                    compress: "str | None" = None) -> dict:
    """Napkin model: bytes crossing the slow leg per round.
    ``compress="int8"`` applies :func:`int8_wire_ratio` instead of
    ``compress_ratio``."""
    if compress is not None:
        if compress != "int8":
            raise ValueError(f"unknown compress scheme: {compress!r}")
        compress_ratio = int8_wire_ratio()
    flat = n * param_bytes
    hier = num_supergroups * param_bytes * compress_ratio
    return {
        "flat_bytes": flat,
        "hierarchical_bytes": hier,
        "reduction_factor": flat / max(hier, 1e-9),
    }
