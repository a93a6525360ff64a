"""Launchers of the CUDA int8 reduce/compress kernels
(``csrc/reduce_compress.cu``).

The counterparts of ``repro/kernels/reduce_compress.py``:

* :func:`reduce_compress_roundtrip` (K3b), on the canonical ``(L, G, R,
  256)`` layout: mean over G (in order, times the f32 reciprocal of G),
  per-row int8 quantization, and the straight-through dequantized value, in
  one pass; the f32 partial never reaches device memory;
* :func:`reduce_compress` (K3a), the same pass without the dequantized
  value: each pod's int8 wire payload;
* :func:`dequant_accumulate` (K3c), the cross-pod leg: the mean over P of
  the dequantized ``(P, R, 256)`` payloads.

CUDA tensors only; ``kernels.ops`` canonicalizes shapes, dispatches CPU
tensors to ``kernels.ref`` and counts the launches.
"""

from __future__ import annotations

import torch

from . import _build
from .quantize import COLS, DTYPE_CODES, _stream, check_rows


def _canonical(x: torch.Tensor, what: str):
    check_rows(x, what, DTYPE_CODES)
    if x.ndim != 4:
        raise ValueError(f"{what}: expected (L, G, R, {COLS}), got "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError(f"{what}: empty group axis")
    return x.shape


def reduce_compress_roundtrip(x: torch.Tensor):
    """(L, G, R, 256) f32/bf16 on the card -> (back (L, R, 256) x.dtype,
    q (L, R, 256) int8, s (L, R, 1) f32)."""
    L, G, R, C = _canonical(x, "reduce_compress_roundtrip")
    back = torch.empty((L, R, C), dtype=x.dtype, device=x.device)
    q = torch.empty((L, R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((L, R, 1), dtype=torch.float32, device=x.device)
    lib = _build.KERNELS.library("reduce_compress")
    with torch.cuda.device(x.device):
        rc = lib.repro_reduce_compress_roundtrip(
            x.data_ptr(), DTYPE_CODES[x.dtype], back.data_ptr(), q.data_ptr(),
            s.data_ptr(), L, G, R, 1.0 / G, _stream(x))
    _build.check(rc, "reduce_compress_roundtrip")
    return back, q, s


def reduce_compress(x: torch.Tensor):
    """(L, G, R, 256) f32/bf16 on the card -> (q (L, R, 256) int8,
    s (L, R, 1) f32): the wire payload."""
    L, G, R, C = _canonical(x, "reduce_compress")
    q = torch.empty((L, R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((L, R, 1), dtype=torch.float32, device=x.device)
    lib = _build.KERNELS.library("reduce_compress")
    with torch.cuda.device(x.device):
        rc = lib.repro_reduce_compress(
            x.data_ptr(), DTYPE_CODES[x.dtype], q.data_ptr(), s.data_ptr(),
            L, G, R, 1.0 / G, _stream(x))
    _build.check(rc, "reduce_compress")
    return q, s


def dequant_accumulate(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(P, R, 256) int8 and (P, R, 1) f32 on the card -> (R, 256) f32, the
    mean over P of ``q * s`` (fused multiply-adds in order p = 0..P-1)."""
    check_rows(q, "dequant_accumulate", (torch.int8,))
    if q.ndim != 3 or q.shape[0] < 1:
        raise ValueError(f"dequant_accumulate: expected (P, R, {COLS}) with "
                         f"P >= 1, got {tuple(q.shape)}")
    P, R, C = q.shape
    if (s.device != q.device or s.dtype != torch.float32
            or tuple(s.shape) != (P, R, 1) or not s.is_contiguous()):
        raise ValueError(
            f"dequant_accumulate: scales must be contiguous f32 ({P}, {R}, 1) "
            f"on {q.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    lib = _build.KERNELS.library("reduce_compress")
    with torch.cuda.device(q.device):
        rc = lib.repro_dequant_accumulate(q.data_ptr(), s.data_ptr(),
                                          out.data_ptr(), P, R, 1.0 / P,
                                          _stream(q))
    _build.check(rc, "dequant_accumulate")
    return out
