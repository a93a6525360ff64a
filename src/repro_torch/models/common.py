"""Shared model components (``repro/models/common.py``): initializers, RMSNorm,
embedding, rotary embeddings, activations and the cross-entropy loss.

Layers are functions of explicit parameter tensors, so the same code runs a
model's own parameters and a client's copy inside a training round. Matrix
products run in the activation dtype (bf16 on the card, f32 in the CPU
tests) with f32 accumulation, as the reference's ``preferred_element_type``
products cast back to that dtype. Two keep an f32 result, as the
reference's: the gated FFN's up and gate products (:func:`matmul_f32`,
dense and MoE), and the logits, an f32 product of f32 copies (exact
products of bf16 values). Norms, rotary embeddings, softmax and the loss
run in f32 as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bf16 (or f16) CUDA tensors, 2-d (``aten::mm.dtype``)
    or batched 3-d (``aten::bmm.dtype``), as one cuBLAS call with an f32
    output. Those ops have no autograd formula, so the backward is written
    here: the same products with the f32 cotangent rounded to the inputs'
    dtype (what autograd of ``matmul(a, b).float()`` computes), each
    gradient one product in the input dtype with f32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.ndim == 2 else torch.bmm
        return mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.transpose(-1, -2), g)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as an f32 tensor from inputs of the activation dtype: the
    reference's ``einsum(..., preferred_element_type=f32)``. ``a`` is (...,
    K) against ``b`` (K, N), or (E, M, K) against (E, K, N). In f32 it is
    ``torch.matmul``. For bf16 on the card it is one GEMM with an f32
    output (:class:`_MatmulF32`), with no f32 copy of either input; on the
    CPU, or where this torch lacks ``aten::mm.dtype``, the product of f32
    copies, which is the exact products of the bf16 values summed in
    f32."""
    if a.dtype == F32 and b.dtype == F32:
        return torch.matmul(a, b)
    if not (a.is_cuda and hasattr(torch.ops.aten.mm, "dtype")):
        return torch.matmul(a.to(F32), b.to(F32))
    if b.ndim == 2:
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return _MatmulF32.apply(a, b)


def normal_init(generator: torch.Generator, shape: Sequence[int],
                dtype: torch.dtype, stddev: Optional[float] = None,
                device=None) -> torch.Tensor:
    """``stddev * N(0, 1)`` in f32, cast to ``dtype``; default stddev is
    ``1/sqrt(fan_in)`` with fan_in = ``shape[0]``, as in the reference."""
    if stddev is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
        stddev = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=generator, dtype=F32,
                    device=device)
    return (stddev * x).to(dtype)


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    # theta as an f32 tensor made on the device (no host copy: a CUDA graph
    # of a serve step captures this)
    base = torch.full((), theta, dtype=F32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., :, None].to(F32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    return {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (..., V); labels: (...) int. Mean over unmasked tokens."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(F32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
