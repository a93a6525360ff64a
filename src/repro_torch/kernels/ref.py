"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py``).

Each function computes what its kernel computes, op for op, so that the
kernel can be held to it bitwise on the card and the CPU path can be held to
the JAX oracle. The ``ops`` wrappers run these only for CPU tensors.
"""

from __future__ import annotations

import torch


def quantize_ref(x: torch.Tensor):
    """Per-row symmetric int8: (R, C) -> (q int8 (R, C), scale f32 (R, 1)).

    ``scale = max(absmax / 127, 1e-12)``, ``q = clip(round(x / scale),
    -127, 127)`` with round-half-to-even (``torch.round``).

    The reference runs under ``jit``, where XLA compiles ``absmax / 127.0``
    (a division by a constant) as a product with the f32 reciprocal of 127;
    ``x / scale`` stays an IEEE division. This version does the same, so it
    is bitwise to the reference's kernels and jitted oracles.
    """
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scales).to(dtype)


def partial_mean_ref(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis -3 of (..., G, R, C) in f32, summed in order
    g = 0..G-1 and scaled by the f32 reciprocal of G (as the kernels do)."""
    g = x.shape[-3]
    acc = x.select(-3, 0).to(torch.float32)
    for i in range(1, g):
        acc = acc + x.select(-3, i).to(torch.float32)
    return acc * (1.0 / g)


def reduce_compress_ref(x: torch.Tensor):
    """(..., G, R, C) -> ((..., R, C) int8, (..., R, 1) f32): partial mean
    over G then per-row int8 quantization."""
    return quantize_ref(partial_mean_ref(x))


def reduce_compress_roundtrip_ref(x: torch.Tensor):
    """(..., G, R, C) -> (back x.dtype, q int8, s f32): mean + quant +
    dequant, the straight-through value the tagged reduction consumes."""
    q, s = reduce_compress_ref(x)
    return dequantize_ref(q, s, x.dtype), q, s
