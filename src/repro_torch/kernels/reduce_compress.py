"""Launcher of the CUDA fused reduce+compress roundtrip
(``csrc/reduce_compress.cu``).

The counterpart of ``repro/kernels/reduce_compress.py::
reduce_compress_roundtrip`` on the canonical ``(L, G, R, 256)`` layout:
mean over G (in order, times the f32 reciprocal of G), per-row int8
quantization, and the straight-through dequantized value, in one pass. The
f32 partial never reaches device memory. CUDA tensors only; ``kernels.ops``
canonicalizes shapes, dispatches CPU tensors to ``kernels.ref`` and counts
the launches. The wire-payload kernel (``reduce_compress``) and the
cross-pod ``dequant_accumulate`` are not on the training path and are not
ported yet.
"""

from __future__ import annotations

import torch

from . import _build
from .quantize import DTYPE_CODES, check_rows


def reduce_compress_roundtrip(x: torch.Tensor):
    """(L, G, R, 256) f32/bf16 on the card -> (back (L, R, 256) x.dtype,
    q (L, R, 256) int8, s (L, R, 1) f32)."""
    check_rows(x, "reduce_compress_roundtrip", DTYPE_CODES)
    if x.ndim != 4:
        raise ValueError(
            "reduce_compress_roundtrip: expected (L, G, R, 256), got "
            f"{tuple(x.shape)}"
        )
    L, G, R, C = x.shape
    if G < 1:
        raise ValueError("reduce_compress_roundtrip: empty group axis")
    back = torch.empty((L, R, C), dtype=x.dtype, device=x.device)
    q = torch.empty((L, R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((L, R, 1), dtype=torch.float32, device=x.device)
    lib = _build.KERNELS.library("reduce_compress")
    with torch.cuda.device(x.device):
        rc = lib.repro_reduce_compress_roundtrip(
            x.data_ptr(), DTYPE_CODES[x.dtype], back.data_ptr(), q.data_ptr(),
            s.data_ptr(), L, G, R, 1.0 / G,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "reduce_compress_roundtrip")
    return back, q, s
