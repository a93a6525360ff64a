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

Ported: ``program``, ``broadcast``, ``map_fn``, ``reduce_sum``,
``reduce_mean``, ``reduce_weighted_mean``, ``masked_reduce_mean`` (the
straggler rounds' reduction) and ``partition_size``. Left out for later
slices: ``reduce_max``, ``stage_transfer``/``stage_map``, and the sharding
annotations.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Mapping, Optional

import torch
from torch.utils import _pytree as pytree

from . import placement as placement_lib
from . import primitives as prims

__all__ = [
    "program",
    "placement_context",
    "broadcast",
    "map_fn",
    "reduce_sum",
    "reduce_mean",
    "reduce_weighted_mean",
    "masked_reduce_mean",
    "partition_size",
    "current_context",
]

placement_context = placement_lib.placement_context
current_context = placement_lib.current_context


def program(
    fn: Optional[Callable] = None,
    *,
    partition_size: Optional[int] = None,
    placements: Optional[Mapping[str, int]] = None,
):
    """Decorator declaring a DrJAX program over ``partition_size=n`` groups
    (the paper's API, one "clients" placement) or an ordered stack
    ``placements={"pods": P, "clients": m}``, outermost first."""
    if fn is not None:
        raise TypeError(
            "drjax.program requires a partition size: use "
            "@drjax.program(partition_size=n)."
        )
    if placements is not None and partition_size is not None:
        raise ValueError("Pass either partition_size or placements, not both.")
    if placements is None and partition_size is None:
        raise ValueError("partition_size (or placements) is required.")
    ctx = placement_lib.make_context(partition_size, placements=placements)

    def deco(f: Callable) -> Callable:
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with placement_lib.placement_context(ctx):
                return f(*args, **kwargs)

        wrapped.drjax_context = ctx
        return wrapped

    return deco


def broadcast(tree, placement: Optional[str] = None):
    """Replicate a structure to every group. With ``placement=p``: one
    broadcast at that level; with none: server -> fully partitioned, one
    broadcast per level, outermost first."""
    ctx = placement_lib.current_context()
    chain = ctx.names if placement is None else (placement,)

    def leaf(x):
        for name in chain:
            x = prims.broadcast(x, placement=name)
        return x

    return pytree.tree_map(leaf, tree)


def _reduce_tree(tree, binder, placement: Optional[str]):
    ctx = placement_lib.current_context()
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

    denom = rsum(weights)
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
        w = weights.reshape(expected + (1,) * (x.ndim - depth_in))
        s = rsum(x * w)
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


def map_fn(fn: Callable, tree, placement: Optional[str] = None):
    """Apply ``fn`` to every group's slice and stack the results.

    A *tuple* ``tree`` passes its elements as separate positional
    arguments. With ``placement=p`` the map runs over that level's axis
    (outputs stacked back at its position); with none it runs over every
    level of the stack (outputs carry all the group axes).

    The reference vmaps ``fn``; here the groups run one after another on
    the one device, and each output leaf is allocated once, stacked, from
    the first group's result; every group's output is copied into its slot
    as soon as it is computed. The values are those of the vmap (each group
    sees its own slice) and equal ``torch.stack`` of the per-group outputs,
    and the memory a map holds is the stacked outputs plus one group's
    computation: the point on one card, where a whole client's training
    state is large. The map is differentiable (autograd through the slices
    and the slot copies).
    """
    ctx = placement_lib.current_context()
    call = (lambda args: fn(*args)) if isinstance(tree, tuple) else fn
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
    stacked, spec = None, None
    for idx in itertools.product(*(range(n) for n in sizes)):
        sel = (slice(None),) * lead + idx
        leaves, out_spec = pytree.tree_flatten(
            call(pytree.tree_map(lambda x: x[sel], tree)))
        if stacked is None:
            spec = out_spec
            stacked = [torch.empty(x.shape[:lead] + sizes + x.shape[lead:],
                                   dtype=x.dtype, device=x.device)
                       for x in leaves]
        elif out_spec != spec:
            raise ValueError(f"map_fn: group {idx} returned a tree of another "
                             "structure than group 0")
        for buf, x in zip(stacked, leaves):
            slot = buf[sel]
            if slot.shape != x.shape or buf.dtype != x.dtype:
                raise ValueError(
                    f"map_fn: group {idx} returned {x.dtype} "
                    f"{tuple(x.shape)} where group 0 returned {buf.dtype} "
                    f"{tuple(slot.shape)}")
            buf[sel] = x
        del leaves  # free this group's outputs before the next group runs
    return pytree.tree_unflatten(stacked, spec)


def partition_size(placement: Optional[str] = None) -> int:
    """One placement's size, or (default) the total number of innermost
    groups across the whole stack."""
    ctx = placement_lib.current_context()
    if placement is None:
        return ctx.total_size()
    return ctx.get(placement).size
