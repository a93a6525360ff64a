"""Sharding of DrJAX values on a mesh (``repro/core/sharding.py``).

The paper's systems finding (Fig. 6) is that explicit sharding of the
partitioned values, installed by the primitives themselves, is what makes
a round weak-scale. The reference pins those shardings for GSPMD; the
port is SPMD (one process per rank of a ``DeviceMesh``) and states them
as DTensors:

* a value partitioned at depth ``k`` under a context with a mesh and
  ``use_sharding_annotations`` is a DTensor whose ``k`` leading group
  axes are each ``Shard``ed over their level's mesh dim(s) (a level with
  no axes stays whole on every rank), the other mesh dims ``Replicate``;
* a server (depth-0) value is ``Replicate()`` on every mesh dim; a plain
  tensor counts as a whole value that every rank holds;
* ``map_fn`` runs its body on each rank's own groups (the DTensor's local
  shard), so the body only ever sees plain local tensors;
* ``broadcast`` expands onto the rank's own groups; ``reduce_sum`` /
  ``reduce_mean`` take the local partial sum, then one ``all_reduce`` over
  the level's mesh dims (then the product by ``f32(1/n)``): the sum runs
  in another order than the mesh-free one, so it is held to a tolerance,
  and it is bitwise only where one rank holds all the groups;
* the int8-tagged ``reduce_mean`` quantizes the mean of all groups, so it
  gathers the level's groups exactly and runs the fused kernel on the
  whole stack: its payload is bitwise the mesh-free one;
* ``stage_transfer`` gathers the stage axis exactly, shifts it, and keeps
  the rank's own stages.

The exact gather is an ``all_reduce`` (sum) of the value's bytes, as
``uint8``, into a zero-filled stack where each rank wrote only its own
rows: every byte has one nonzero contributor, so the sum is exact, ``-0.0``
and NaN payloads included, and it needs only ``all_reduce``, which gloo
carries for CUDA tensors (its ``all_gather`` does not).

Every collective runs on the mesh-dim groups of the ranks in the mesh: a
rank outside the mesh (a dropped pod) takes no part.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import compat
from . import placement as placement_lib


def _dist():
    import torch.distributed as dist

    return dist


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor (checked without importing the distributed
    package where nothing can be one)?"""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    return isinstance(x, _dtensor())


# ---------------------------------------------------------------------------
# specs and placements
# ---------------------------------------------------------------------------


def partition_spec(ctx: placement_lib.PlacementContext, ndim: int,
                   depth: Optional[int] = None) -> Optional[Tuple]:
    """The reference's entries for the ``depth`` leading group axes of an
    ``ndim`` array: each level's mesh axis name, a tuple of names, or
    ``None`` for a level with no axes. ``None`` when nothing would be
    constrained."""
    if depth is None:
        depth = ctx.depth
    depth = min(depth, ndim)
    entries = []
    for pl in ctx.placements[:depth]:
        axes = pl.axes_tuple()
        entries.append(None if not axes else
                       axes if len(axes) > 1 else axes[0])
    if all(e is None for e in entries):
        return None
    return tuple(entries)


def partition_placements(ctx: placement_lib.PlacementContext, ndim: int,
                         depth: Optional[int] = None) -> list:
    """DTensor placements (one per mesh dim) of a value partitioned at
    ``depth``: ``Shard(j)`` on level j's mesh dims, ``Replicate()``
    elsewhere."""
    spec = partition_spec(ctx, ndim, depth)
    if spec is None:
        return compat.replicated_placements(ctx.mesh)
    return compat.named_placements(ctx.mesh, spec)


def level_dims(ctx: placement_lib.PlacementContext, i: int) -> Tuple[int, ...]:
    """The mesh dims (indices) level ``i``'s groups are sharded over."""
    if not ctx.sharded():
        return ()
    names = compat.mesh_axis_names(ctx.mesh)
    return tuple(names.index(a) for a in ctx.placements[i].axes_tuple())


def _shards(mesh, dims: Sequence[int]) -> int:
    shape = compat.mesh_shape(mesh)
    return math.prod(shape[d] for d in dims)


def block_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block index along a tensor dim split over ``dims``
    (row-major over their coordinates, as DTensor lays it out)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    shape = compat.mesh_shape(mesh)
    idx = 0
    for d in dims:
        idx = idx * shape[d] + coord[d]
    return idx


def _local_len(n: int, mesh, dims: Sequence[int], what: str) -> int:
    k = _shards(mesh, dims)
    if n % k:
        raise ValueError(
            f"{what}: {n} groups cannot shard evenly over {k} ranks "
            "(a partition of n groups shards over m ranks only for m | n)")
    return n // k


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, ctx: placement_lib.PlacementContext,
         depth: int, global_shape) -> torch.Tensor:
    """The DTensor of a value partitioned at ``depth`` from this rank's
    local block (no communication)."""
    shape = tuple(int(s) for s in global_shape)
    return _dtensor().from_local(
        local, ctx.mesh, partition_placements(ctx, len(shape), depth),
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


# ---------------------------------------------------------------------------
# exact gather and local slice (autograd transposes of each other)
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, mesh, dims: Sequence[int], op=None):
    dist = _dist()
    op = dist.ReduceOp.SUM if op is None else op
    for d in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(d))
    return t


def gather_dim(local: torch.Tensor, dim: int, mesh,
                  dims: Sequence[int]) -> torch.Tensor:
    if not dims:
        return local
    k, idx = _shards(mesh, dims), block_index(mesh, dims)
    n = local.shape[dim]
    full = local.new_zeros(local.shape[:dim] + (n * k,)
                           + local.shape[dim + 1:])
    full.narrow(dim, idx * n, n).copy_(local)
    if full.numel():
        _all_reduce(full.view(-1).view(torch.uint8), mesh, dims)
    return full


def _slice_local(full: torch.Tensor, dim: int, mesh,
                 dims: Sequence[int]) -> torch.Tensor:
    if not dims:
        return full
    n = _local_len(full.shape[dim], mesh, dims, "shard")
    return full.narrow(dim, block_index(mesh, dims) * n, n).contiguous()


class _Gather(torch.autograd.Function):
    """The exact gather of tensor dim ``dim`` over mesh ``dims``; its
    transpose is the local slice."""

    @staticmethod
    def forward(ctx, local, dim, mesh, dims):
        ctx.dim, ctx.mesh, ctx.dims = dim, mesh, dims
        return gather_dim(local, dim, mesh, dims)

    @staticmethod
    def backward(ctx, ct):
        return _slice_local(ct, ctx.dim, ctx.mesh, ctx.dims), None, None, None


class _Slice(torch.autograd.Function):
    """A whole value's local block along ``dim``; its transpose is the
    exact gather."""

    @staticmethod
    def forward(ctx, full, dim, mesh, dims):
        ctx.dim, ctx.mesh, ctx.dims = dim, mesh, dims
        return _slice_local(full, dim, mesh, dims)

    @staticmethod
    def backward(ctx, ct):
        return (gather_dim(ct.contiguous(), ctx.dim, ctx.mesh, ctx.dims),
                None, None, None)


def gather_level(local: torch.Tensor, ctx, i: int) -> torch.Tensor:
    """All of level ``i``'s groups on every rank of the mesh: the exact
    gather of tensor dim ``i`` over that level's mesh dims."""
    dims = level_dims(ctx, i)
    return _Gather.apply(local, i, ctx.mesh, dims) if dims else local


def slice_level(full: torch.Tensor, ctx, i: int) -> torch.Tensor:
    dims = level_dims(ctx, i)
    return _Slice.apply(full, i, ctx.mesh, dims) if dims else full


def to_local(x, ctx: placement_lib.PlacementContext, depth: int
             ) -> torch.Tensor:
    """This rank's block of a value partitioned at ``depth``: a DTensor's
    local shard, or the local slice of a whole (plain) value."""
    if is_dtensor(x):
        want = partition_placements(ctx, x.ndim, depth)
        if list(x.placements) != want:
            # another placement (a DTensor op outside the primitives
            # replicated it): DTensor's own redistribution, local from a
            # replicated value
            x = x.redistribute(ctx.mesh, want)
        return x.to_local()
    for i in range(min(depth, x.ndim)):
        x = slice_level(x, ctx, i)
    return x


def global_shape(local: torch.Tensor, ctx, depth: int) -> Tuple[int, ...]:
    return tuple(ctx.sizes[:depth]) + tuple(local.shape[depth:])


# ---------------------------------------------------------------------------
# the constraints (``repro/core/sharding.py:63-115``)
# ---------------------------------------------------------------------------


def constrain_partitioned(x, ctx: placement_lib.PlacementContext,
                          depth: Optional[int] = None):
    """A partitioned value as the DTensor its context places: its
    ``depth`` leading group axes sharded over their levels' mesh dims.
    Unchanged without a mesh, with DrJAX-NS, for a 0-d value or where no
    level has axes."""
    if not ctx.use_sharding_annotations or ctx.mesh is None:
        return x
    if x.ndim == 0:
        return x
    depth = ctx.depth if depth is None else min(depth, x.ndim)
    if partition_spec(ctx, x.ndim, depth) is None:
        return x
    if is_dtensor(x):
        return x if list(x.placements) == partition_placements(
            ctx, x.ndim, depth) else wrap(to_local(x, ctx, depth), ctx,
                                          depth, x.shape)
    return wrap(to_local(x, ctx, depth), ctx, depth, x.shape)


def constrain_replicated(x, ctx: placement_lib.PlacementContext):
    """A server value as a DTensor ``Replicate()`` on every mesh dim:
    every rank holds all of it. Unchanged without a mesh, with DrJAX-NS,
    or where no level has axes."""
    if not ctx.sharded() or x.ndim == 0:
        return x
    rep = compat.replicated_placements(ctx.mesh)
    if is_dtensor(x):
        if all(p.is_replicate() for p in x.placements):
            return x
        raise ValueError("constrain_replicated: a partitioned DTensor "
                         "must be reduced, not re-placed")
    return _dtensor().from_local(x, ctx.mesh, rep, run_check=False)


def constrain_tree(tree, ctx: placement_lib.PlacementContext, *,
                   partitioned: bool, depth: Optional[int] = None):
    if partitioned:
        return pytree.tree_map(lambda x: constrain_partitioned(x, ctx, depth),
                               tree)
    return pytree.tree_map(lambda x: constrain_replicated(x, ctx), tree)


def unwrap_replicated(tree):
    """Replicated DTensors as the plain tensors every rank holds; a
    partitioned DTensor stays one."""

    def leaf(x):
        if is_dtensor(x) and all(p.is_replicate() for p in x.placements):
            return x.to_local()
        return x

    return pytree.tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# the primitives on a mesh
# ---------------------------------------------------------------------------


class _Broadcast(torch.autograd.Function):
    """Expand onto this rank's ``n`` groups at axis ``i``; the transpose
    is the local sum and an ``all_reduce`` over the level's mesh dims."""

    @staticmethod
    def forward(ctx, x, i, n, mesh, dims):
        ctx.i, ctx.mesh, ctx.dims = i, mesh, dims
        return x.unsqueeze(i).expand(x.shape[:i] + (n,) + x.shape[i:])

    @staticmethod
    def backward(ctx, ct):
        g = ct.sum(dim=ctx.i)
        if ctx.dims:
            g = _all_reduce(g.contiguous(), ctx.mesh, ctx.dims)
        return g, None, None, None, None


class _ReduceSum(torch.autograd.Function):
    """The local partial sum over axis ``i``, then an ``all_reduce`` over
    the level's mesh dims; the transpose expands onto the local groups."""

    @staticmethod
    def forward(ctx, x, i, mesh, dims):
        ctx.i, ctx.n = i, x.shape[i]
        out = x.sum(dim=i)
        return _all_reduce(out, mesh, dims) if dims else out

    @staticmethod
    def backward(ctx, ct):
        i = ctx.i
        return (ct.unsqueeze(i).expand(ct.shape[:i] + (ctx.n,)
                                       + ct.shape[i:]), None, None, None)


class _ReduceMax(torch.autograd.Function):
    """The local max, then an ``all_reduce(MAX)``; the transpose sends the
    tangent to the arg-max groups, split evenly over ties on all ranks."""

    @staticmethod
    def forward(ctx, x, i, mesh, dims):
        ctx.i, ctx.mesh, ctx.dims = i, mesh, dims
        out = x.amax(dim=i)
        if dims:
            out = _all_reduce(out, mesh, dims, _dist().ReduceOp.MAX)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        x, out = ctx.saved_tensors
        i = ctx.i
        hit = (x == out.unsqueeze(i)).to(x.dtype)
        count = hit.sum(dim=i, keepdim=True)
        if ctx.dims:
            count = _all_reduce(count.contiguous(), ctx.mesh, ctx.dims)
        hit = hit / torch.clamp_min(count, 1)
        return hit * ct.unsqueeze(i), None, None, None


def broadcast(x, ctx, i: int):
    """``broadcast@level i`` of a depth-``i`` value: a depth-``i + 1``
    DTensor, each rank holding its own groups of the new axis."""
    local = to_local(x, ctx, i)
    dims = level_dims(ctx, i)
    n = _local_len(ctx.sizes[i], ctx.mesh, dims, "broadcast")
    out = _Broadcast.apply(local, i, n, ctx.mesh, dims)
    return wrap(out, ctx, i + 1, global_shape(out, ctx, i + 1))


def _reduced(out: torch.Tensor, ctx, i: int):
    """The result of a reduce at level ``i``, placed at depth ``i``: a
    replicated DTensor at depth 0."""
    if i == 0:
        return _dtensor().from_local(
            out, ctx.mesh, compat.replicated_placements(ctx.mesh),
            run_check=False)
    return wrap(out, ctx, i, global_shape(out, ctx, i))


def reduce_sum(x, ctx, i: int, scale: Optional[torch.Tensor] = None):
    """``reduce_sum@level i`` (``scale``: the mean's ``f32(1/n)``,
    applied after the ``all_reduce``)."""
    local = to_local(x, ctx, i + 1)
    out = _ReduceSum.apply(local, i, ctx.mesh, level_dims(ctx, i))
    if scale is not None:
        out = out * scale
    return _reduced(out, ctx, i)


def reduce_max(x, ctx, i: int):
    local = to_local(x, ctx, i + 1)
    out = _ReduceMax.apply(local, i, ctx.mesh, level_dims(ctx, i))
    return _reduced(out, ctx, i)


def reduce_mean_int8(x, ctx, i: int, fused_apply):
    """The int8-tagged ``reduce_mean@level i``: the level's groups gathered
    exactly, then ``fused_apply(stack, i)`` (the fused reduce + int8
    roundtrip) on the whole stack."""
    full = gather_level(to_local(x, ctx, i + 1), ctx, i)
    return _reduced(fused_apply(full, i), ctx, i)


def stage_transfer(x, ctx, i: int, transfer):
    """``stage_transfer@level i``: the stage axis gathered exactly,
    ``transfer(full, i)`` (the shift), and the rank's own stages kept."""
    full = gather_level(to_local(x, ctx, i + 1), ctx, i)
    out = slice_level(transfer(full, i), ctx, i)
    return wrap(out, ctx, i + 1, global_shape(out, ctx, i + 1))


def gather_partitioned(x, ctx, depth: int) -> torch.Tensor:
    """A partitioned value whole on every rank (plain): each sharded
    level gathered exactly."""
    if not is_dtensor(x):
        return x
    local = to_local(x, ctx, depth)
    for i in range(depth):
        local = gather_level(local, ctx, i)
    return local
