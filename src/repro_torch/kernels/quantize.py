"""Launchers of the CUDA int8 quantize/dequantize pair (``csrc/quantize.cu``).

The counterpart of ``repro/kernels/quantize.py``: per-row symmetric int8
over a flat-packed ``(R, 256)`` buffer. These functions take CUDA tensors
only; ``kernels.ops`` dispatches CPU tensors to the plain versions in
``kernels.ref`` and counts the launches.
"""

from __future__ import annotations

import torch

from . import _build

COLS = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_rows(t: torch.Tensor, what: str, dtypes) -> None:
    """A contiguous CUDA (..., 256) tensor of an accepted dtype, 16-byte
    aligned (the kernels use vector loads)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.ndim < 2 or t.shape[-1] != COLS:
        raise ValueError(f"{what}: expected (..., {COLS}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize(x: torch.Tensor):
    """(R, 256) f32/bf16 on the card -> (q int8 (R, 256), scale f32 (R, 1))."""
    check_rows(x, "quantize", DTYPE_CODES)
    if x.ndim != 2:
        raise ValueError(f"quantize: expected (R, {COLS}), got {tuple(x.shape)}")
    rows = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = _build.KERNELS.library("quantize")
    with torch.cuda.device(x.device):
        rc = lib.repro_quantize(x.data_ptr(), DTYPE_CODES[x.dtype],
                                q.data_ptr(), s.data_ptr(), rows, _stream(x))
    _build.check(rc, "quantize")
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(R, 256) int8 and (R, 1) f32 on the card -> (R, 256) ``dtype``."""
    check_rows(q, "dequantize", (torch.int8,))
    if q.ndim != 2:
        raise ValueError(f"dequantize: expected (R, {COLS}), got {tuple(q.shape)}")
    rows = q.shape[0]
    if (s.device != q.device or s.dtype != torch.float32
            or tuple(s.shape) != (rows, 1) or not s.is_contiguous()):
        raise ValueError(
            f"dequantize: scales must be contiguous f32 ({rows}, 1) on "
            f"{q.device}, got {s.dtype} {tuple(s.shape)} on {s.device}"
        )
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dequantize: output dtype {dtype} not supported")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    lib = _build.KERNELS.library("quantize")
    with torch.cuda.device(q.device):
        rc = lib.repro_dequantize(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                  DTYPE_CODES[dtype], rows, _stream(q))
    _build.check(rc, "dequantize")
    return out
