"""Quantized tensor-parallel reduction (``repro/models/tpcomm.py``).

A tensor-parallel product ends in partial sums, one per rank of
``"model"``, that a bf16 step reduces with an all-reduce.
:func:`int8_matmul_reduce` carries that reduction in int8 instead:

    local partial product (f32)
      -> per-row symmetric int8 quantization (:func:`_quant_rows`)
      -> gather of the int8 values and the f32 row scales over "model"
      -> the dequant-sum of the m shards, in shard order

Forward-only, as the reference's (its docstring and ``mlp.py:43``): the
serve steps' prefill takes it with ``tp_comm="int8"``; a call that needs
a gradient raises. The quantization is per row of the full output width
d under XLA in the reference (``tpcomm.py:36-41``), not K1a's blocks of
256, so it stays in plain PyTorch here. The gather goes by
``partitioning.gather_route`` (``all_gather``, or the exact ``all_reduce``
gather of int8 bytes on gloo with CUDA tensors): the int8 bits on the wire
are the same either way.

The dequant-sum is ``sum_j q_j * s_j`` over the gathered axis. XLA
compiles the reference's ``jnp.sum(qg.astype(f32) * sg, axis=0)`` as it
compiles K3c's accumulation (caveat R6): the first product rounded, then
one fused multiply-add a shard, in shard order. :func:`_dequant_sum` does
the same with ``ref.fma_f32`` (one rounding), and
``tests/test_torch_tpcomm.py`` holds it bitwise to the jitted reference,
beside the sum of rounded products, which differs.

:func:`bf16_wire_bytes` and :func:`int8_wire_bytes` are the reference's
per-device models: a ring all-reduce of (t, d) bf16, and an all-gather
whose gathered stack holds t rows of d int8 values and an f32 scale. A
rank of m that gathers its partial of t/m rows receives
``int8_wire_bytes(t, d, m)`` bytes: (m - 1) blocks of t/m rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ref
from . import common, partitioning

F32 = torch.float32


def _quant_rows(x: torch.Tensor):
    """x (..., d) f32 -> (int8 (..., d), scales (..., 1) f32): per row,
    ``scale = max(absmax * f32(1/127), 1e-12)`` (the jitted reference's
    product with the reciprocal, caveat R3), ``q = clip(round(x / scale),
    -127, 127)`` with an IEEE division."""
    d = x.shape[-1]
    q, scale = ref.quantize_ref(x.reshape(-1, d))
    return q.reshape(x.shape), scale.reshape(x.shape[:-1] + (1,))


def _dequant_sum(qg: torch.Tensor, sg: torch.Tensor) -> torch.Tensor:
    """(m, ..., d) int8 and (m, ..., 1) f32 -> (..., d) f32: ``q_0 s_0``,
    then ``fma(q_j, s_j, acc)`` for j = 1 .. m-1."""
    out = qg[0].to(F32) * sg[0]
    for j in range(1, qg.shape[0]):
        out = ref.fma_f32(qg[j].to(F32), sg[j].expand_as(out), out)
    return out


def int8_sum(part: torch.Tensor) -> torch.Tensor:
    """The int8 reduction over ``"model"`` of each rank's f32 partial sums
    ``part`` (..., d), in f32: quantize, gather the int8 values and
    scales, and the dequant-sum in shard order. Each shard's rounding
    moves its term by at most half its row's scale, so the result is
    within ``sum_j s_j / 2`` of the exact sum, plus the m roundings of
    the sum."""
    if torch.is_grad_enabled() and part.requires_grad:
        raise RuntimeError("the int8 tensor-parallel reduction is "
                           "forward-only (serve steps)")
    dims = partitioning.model_dims()
    q, s = _quant_rows(part)
    qg = partitioning.gather_exact(q[None], 0, dims)
    sg = partitioning.gather_exact(s[None], 0, dims)
    partitioning.ROUTES["int8 gathers"] += 1
    # the other ranks' int8 values and f32 scales this rank received
    partitioning.ROUTES["int8 payload bytes"] += (qg.shape[0] - 1) * (
        q.numel() + 4 * s.numel())
    return _dequant_sum(qg, sg)


def int8_reduce(part: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`int8_sum` cast to ``out_dtype``."""
    return int8_sum(part).to(out_dtype)


def int8_matmul_reduce(x: torch.Tensor, w: torch.Tensor, *,
                       axis_name: str = "model", batch_axes=("data",),
                       out_dtype: Optional[torch.dtype] = None):
    """x (T, f) @ w (f, d) with the cross-shard reduction in int8.

    On a mesh with ``axis_name`` of size > 1, ``x`` and ``w`` are the
    rank's blocks (T rows of its batch shard, its f columns / rows), and
    the result is the rank's T rows of the whole product. Without one it
    is the f32-accumulated product cast to ``out_dtype``
    (``repro/models/tpcomm.py:56-61``). ``batch_axes`` names the mesh axes
    the rows shard over, as the reference's ``shard_map`` specs do; each
    rank holds its own rows here already."""
    del batch_axes
    if axis_name != partitioning.MODEL:
        raise ValueError(f"the tensor-parallel axis is "
                         f"{partitioning.MODEL!r}, not {axis_name!r}")
    out_dtype = out_dtype or x.dtype
    part = common.matmul_f32(x, w)
    if not partitioning.model_dims():
        return part.to(out_dtype)
    return int8_reduce(part, out_dtype)


def bf16_wire_bytes(t_tokens: int, d: int, m: int) -> float:
    """Per-device wire bytes of the baseline bf16 all-reduce."""
    return 2.0 * (m - 1) / m * t_tokens * d * 2.0


def int8_wire_bytes(t_tokens: int, d: int, m: int) -> float:
    """Per-device wire bytes of the int8 all-gather reduction."""
    return (m - 1) / m * t_tokens * (d * 1.0 + 4.0)
