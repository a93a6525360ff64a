"""Launchers of the CUDA RG-LRU scan kernels (``csrc/rglru_scan.cu``).

The counterpart of ``repro/kernels/rglru_scan.py::lru_scan`` (the forward
``h_t = a_t * h_{t-1} + b_t``, with an optional f32 initial state ``h0``)
and its backward, the reverse scan of ``ref.lru_scan_bwd_ref``. a, b
(B, S, W), f32 or bf16, contiguous, on one card. Each launcher checks what
the kernels take and raises on anything else, allocates its outputs with
``torch.empty``, picks the route (:func:`route`) and launches on the
current stream. CUDA tensors only; ``kernels.ops`` dispatches CPU tensors
to ``kernels.ref`` and counts the launches.

Two routes, both bitwise equal to the plain versions: the TMA route
(``tma_fwd_kernel``, ``tma_bwd_kernel``: shared-memory rings fed by the
Tensor Memory Accelerator) where every tensor it maps is 16-byte aligned
and a row of W values is a multiple of 16 bytes, else the SIMT route
(``simt_fwd_kernel``, ``simt_bwd_kernel``). :data:`ROUTE_LAUNCHES` counts
the launches of each.
"""

from __future__ import annotations

import torch

from . import _build
from .quantize import DTYPE_CODES

_MAX_GRID_Y = 65535

TMA_ALIGN = 16  # bytes: data pointers and a row of W values

ROUTE_LAUNCHES = {"tma": 0, "simt": 0}


def reset_route_launches() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def route(*tensors: torch.Tensor) -> str:
    """``"tma"`` if the TMA route takes these (B, S, W) tensors, the
    inputs and outputs it maps: a row of W values a multiple of 16 bytes
    and every data pointer 16-byte aligned. Else ``"simt"``."""
    first = tensors[0]
    row_bytes = first.shape[-1] * first.element_size()
    if row_bytes % TMA_ALIGN == 0 and all(t.data_ptr() % TMA_ALIGN == 0
                                          for t in tensors):
        return "tma"
    return "simt"


def _check(what: str, tensors, h0):
    """(B, S, W) of a call the kernels take, or raise."""
    first = tensors[0][1]
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not in "
                            f"{tuple(DTYPE_CODES)}")
        if t.dtype != first.dtype or t.device != first.device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                            f"a is {first.dtype} on {first.device}")
        if t.ndim != 3 or tuple(t.shape) != tuple(first.shape):
            raise ValueError(f"{what}: {name} must be (B, S, W) like a, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, s, w = first.shape
    if min(b, s, w) <= 0 or b > _MAX_GRID_Y:
        raise ValueError(f"{what}: need 0 < B <= {_MAX_GRID_Y} and S, W > 0, "
                         f"got {tuple(first.shape)}")
    if h0 is not None and (h0.device != first.device
                           or h0.dtype != torch.float32
                           or tuple(h0.shape) != (b, w)
                           or not h0.is_contiguous()):
        raise ValueError(f"{what}: h0 must be contiguous f32 {(b, w)} on "
                         f"{first.device}, got {h0.dtype} {tuple(h0.shape)} "
                         f"on {h0.device}")
    return b, s, w


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd(a, b, h0=None):
    """-> h (B, S, W) in a's dtype."""
    dims = _check("lru_scan_fwd", (("a", a), ("b", b)), h0)
    h = torch.empty_like(a)
    r = route(a, b, h)
    lib = _build.KERNELS.library("rglru_scan")
    with torch.cuda.device(a.device):
        rc = lib.repro_lru_scan_fwd(a.data_ptr(), b.data_ptr(), _ptr(h0),
                                    DTYPE_CODES[a.dtype], h.data_ptr(), *dims,
                                    int(r == "tma"), _stream(a))
    _build.check(rc, "lru_scan_fwd")
    ROUTE_LAUNCHES[r] += 1
    return h


def bwd(a, h, g, h0=None):
    """-> (da, db in a's dtype, dh0 (B, W) f32)."""
    b, _, w = _check("lru_scan_bwd", (("a", a), ("h", h), ("g", g)), h0)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = torch.empty((b, w), dtype=torch.float32, device=a.device)
    r = route(a, h, g, da, db)
    lib = _build.KERNELS.library("rglru_scan")
    with torch.cuda.device(a.device):
        rc = lib.repro_lru_scan_bwd(a.data_ptr(), h.data_ptr(), g.data_ptr(),
                                    _ptr(h0), DTYPE_CODES[a.dtype],
                                    da.data_ptr(), db.data_ptr(),
                                    dh0.data_ptr(), *a.shape,
                                    int(r == "tma"), _stream(a))
    _build.check(rc, "lru_scan_bwd")
    ROUTE_LAUNCHES[r] += 1
    return da, db, dh0
