"""DrJAX MapReduce primitives on single tensors (``repro/core/primitives.py``).

Every primitive is placement-addressed: for a placement at stack index
``i``, ``broadcast`` takes a value partitioned at the ``i`` outer placements
and inserts that placement's group axis at position ``i``; ``reduce_*``
removes it.

In the reference each primitive is a JAX ``Primitive`` with hand-written
JVP and transpose rules. Here broadcast and the plain reductions are
ordinary differentiable tensor ops along the leading group axes, so
autograd yields the MapReduce AD transposes directly: the backward of
``broadcast@p`` (an ``expand``) is ``reduce_sum@p``, and that of
``reduce_mean@p`` is ``broadcast@p(ct * r)``. The ``compress="int8"``
tagged ``reduce_mean`` is a :class:`torch.autograd.Function` whose forward
is the fused reduce+compress kernel and whose backward is the same
``broadcast(ct * r)`` (the int8 roundtrip is straight-through).

``r`` is ``1 / size`` rounded to f32 once (:func:`reciprocal`): the
reference's driver always jits, and XLA compiles its ``sum / size`` (and
the transpose's ``ct / size``) as a product with that reciprocal. A
division would differ from it in the last bit for sizes that are not
powers of two.

Left out for later slices: ``reduce_max``, ``stage_transfer`` and the
batching rules (the port has no ``vmap`` of the primitives).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import ops as kernel_ops
from . import placement as placement_lib


def _resolve(placement: Optional[str]) -> Tuple[placement_lib.Placement, int]:
    ctx = placement_lib.current_context()
    i = ctx.index_of(placement)
    return ctx.placements[i], i


def _check_operand_depth(x: torch.Tensor, depth: int, prim: str) -> None:
    """Operand must carry the ``depth`` outermost placements' group axes."""
    ctx = placement_lib.current_context()
    if x.ndim < depth:
        raise ValueError(
            f"drjax.{prim} at placement '{ctx.placements[depth - 1].name}' "
            f"expects a value partitioned at the {depth} outer placement(s) "
            f"{list(ctx.names[:depth])}; got a rank-{x.ndim} tensor."
        )
    for j in range(depth):
        pl = ctx.placements[j]
        if x.shape[j] != pl.size:
            raise ValueError(
                f"drjax.{prim}: axis {j} ({x.shape[j]}) does not match the "
                f"partition size ({pl.size}) of placement '{pl.name}'."
            )


def broadcast(x: torch.Tensor, placement: Optional[str] = None) -> torch.Tensor:
    """One ``broadcast@placement``: depth-i operand -> depth-(i+1) result.

    An ``expand`` view: no copy, and autograd's backward is the sum over
    the new axis (``reduce_sum@placement``)."""
    x = torch.as_tensor(x)
    pl, i = _resolve(placement)
    _check_operand_depth(x, i, "broadcast")
    return x.unsqueeze(i).expand(x.shape[:i] + (pl.size,) + x.shape[i:])


def reduce_sum(x: torch.Tensor, placement: Optional[str] = None) -> torch.Tensor:
    _, i = _resolve(placement)
    _check_operand_depth(x, i + 1, "reduce_sum")
    return x.sum(dim=i)


def reciprocal(n: int) -> torch.Tensor:
    """``1 / n`` rounded to f32 once, as a 0-d CPU tensor. A product with
    it runs as a scalar product in f32 (bf16 operands too) on either
    device, as the jitted reference's ``x / n`` does."""
    return torch.tensor(1.0 / n, dtype=torch.float32)


class _FusedReduceMean(torch.autograd.Function):
    """``reduce_mean@p`` tagged ``compress="int8"``: forward is the fused
    single-pass mean + int8 roundtrip (CUDA kernel on the card); backward
    is ``broadcast@p(ct * r)``, exactly the plain reduce_mean's, so the
    gradient equals the unfused composition's bitwise."""

    @staticmethod
    def forward(ctx, x, axis: int, size: int, qaxis: int):
        ctx.axis, ctx.size, ctx.shape = axis, size, x.shape
        return kernel_ops.reduce_compress_roundtrip(x, axis=axis, qaxis=qaxis)

    @staticmethod
    def backward(ctx, ct):
        g = (ct * reciprocal(ctx.size)).unsqueeze(ctx.axis).expand(ctx.shape)
        return g, None, None, None


def reduce_mean(x: torch.Tensor, placement: Optional[str] = None, *,
                compress: Optional[str] = None, qaxis: int = -1) -> torch.Tensor:
    """Mean over one placement's groups. ``compress="int8"`` runs the fused
    reduce + int8 roundtrip (``qaxis`` = the partial's axis that carries the
    per-row scales): the hierarchical fast path."""
    pl, i = _resolve(placement)
    _check_operand_depth(x, i + 1, "reduce_mean")
    if compress is None:
        return x.sum(dim=i) * reciprocal(pl.size)
    if compress != "int8":
        raise NotImplementedError(
            f"drjax.reduce_mean: fused compress={compress!r} is only "
            "implemented for int8 (the hierarchical fast path)."
        )
    return _FusedReduceMean.apply(x, i, pl.size, qaxis)
