"""Shared model components (``repro/models/common.py``): initializers, RMSNorm,
embedding, rotary embeddings, activations and the cross-entropy loss.

Layers are functions of explicit parameter tensors, so the same code runs a
model's own parameters and a client's copy inside a training round. Matrix
products run in the activation dtype (bf16 on the card, f32 in the CPU
tests) with f32 accumulation, as the reference's ``preferred_element_type``
products cast back to that dtype. Two keep an f32 result, as the
reference's: the gated FFN's up and gate products (:func:`matmul_f32`,
dense and MoE, whose gradients take the f32 cotangent as the reference's
transposes do), and the logits, an f32 product of f32 copies (exact
products of bf16 values). Norms, rotary embeddings, softmax and the loss
run in f32 as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32


def split3_bf16(g: torch.Tensor):
    """An f32 tensor as three bf16 terms, ``hi + mid + lo == g`` exactly:
    ``hi = bf16(g)``, ``mid = bf16(g - hi)``, ``lo = bf16(g - hi - mid)``.
    Each term takes at least the next 8 of f32's 24 significand bits (the
    differences are exact in f32) and bf16 keeps f32's exponent range, so
    three cover ``g``. A product of a term with a bf16 value is exact in
    f32."""
    hi = g.to(torch.bfloat16)
    r = g - hi.to(F32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(F32)).to(torch.bfloat16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product of two bf16 tensors, 2-d or batched 3-d: on the card
    one cuBLAS call with an f32 output (``aten::mm.dtype`` /
    ``bmm.dtype``), elsewhere the product of f32 copies (the same exact
    products, summed in f32 in another order)."""
    if a.is_cuda:
        return (torch.mm if a.ndim == 2 else torch.bmm)(a, b, out_dtype=F32)
    return torch.matmul(a.to(F32), b.to(F32))


def matmul_f32_grads(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     need=(True, True)):
    """``(da, db)`` of ``a @ b`` with the f32 result's cotangent ``g``, as
    the reference transposes ``einsum(..., preferred_element_type=f32)``:
    each gradient ``bf16(g . f32(operand))``, exact products summed in
    f32. ``g`` enters as its three bf16 terms (:func:`split3_bf16`), each
    one GEMM with an f32 output against the bf16 operand; the three are
    summed in f32 and cast to the inputs' dtype. ``None`` where ``need``
    is false. Under grad mode (a backward with ``create_graph``, as
    MAML's outer gradient takes) each product is a :class:`_MatmulF32`,
    so the gradients are differentiable in turn."""
    mm = _MatmulF32.apply if torch.is_grad_enabled() else _mm_f32
    hi, *rest = split3_bf16(g)
    da = db = None
    if need[0]:
        bt = b.transpose(-1, -2)
        da = sum((mm(t, bt) for t in rest), mm(hi, bt)).to(a.dtype)
    if need[1]:
        at = a.transpose(-1, -2)
        db = sum((mm(at, t) for t in rest), mm(at, hi)).to(b.dtype)
    return da, db


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bf16 tensors, 2-d or batched 3-d, with an f32
    output (:func:`_mm_f32`: one cuBLAS call on the card). Those ops have
    no autograd formula, so the backward is written here:
    :func:`matmul_f32_grads`, the f32 cotangent against the bf16
    operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return matmul_f32_grads(a, b, g, ctx.needs_input_grad[:2])


def _gemm_f32_output(a: torch.Tensor) -> bool:
    """Whether :func:`matmul_f32` runs :class:`_MatmulF32` for ``a``: bf16
    on the card, where this torch has ``aten::mm.dtype``."""
    return (a.is_cuda and a.dtype == torch.bfloat16
            and hasattr(torch.ops.aten.mm, "dtype"))


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
    if not _gemm_f32_output(a):
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
    return masked_mean(logz - gold, mask)


def masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The mean of ``nll`` over the unmasked tokens (all without a mask)."""
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(F32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
