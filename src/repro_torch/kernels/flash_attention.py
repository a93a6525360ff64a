"""Launchers of the CUDA flash attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_sm90.cu`` and ``csrc/flash_decode.cu``).

The counterpart of ``repro/kernels/flash_attention.py::flash_attention``
(forward) and of ``repro/models/attention.py::_flash_bwd_rule`` (the
backward of ``flash_attention_xla``), in the reference's layout: q
(B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), f32 or bf16, contiguous, on one
card. Three kernels: the forward (with the f32 output and the logsumexp L
that the backward reads), ``bwd_dq`` (D and dq) and ``bwd_dkdv`` (dk and
dv, after ``bwd_dq``); the forward of a bf16 call with at most
:data:`DECODE_ROWS` query rows a kv head (Sq * Hq / Hkv) takes a fourth,
``fwd_decode``, the split-KV kernels of ``flash_decode.cu``. :data:`ROUTES`
names the entry point each call takes, by dtype and head dim: f32 runs the
SIMT kernels, bf16 the ``mma.sync`` tensor-core kernels, except at head
dims 64 and 128, where all three run on the ``wgmma`` kernels of
``flash_attention_sm90.cu`` (TMA rings, warp specialisation; the sources'
headers say why). Each launcher checks what the kernel takes and raises on
anything else, allocates its outputs (and, where the ``mma.sync``
``bwd_dkdv`` runs with Hq > Hkv, the f32 per-head partials that a second
kernel sums in order, or the decode forward's per-split partials) with
``torch.empty`` and launches on the current stream. CUDA tensors only;
``kernels.ops`` dispatches CPU tensors to ``kernels.ref`` and counts the
launches; :data:`ROUTE_LAUNCHES` counts them here by entry point, dtype
and head dim.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from . import _build
from .quantize import DTYPE_CODES

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_MAX_GRID_YZ = 65535

# The forward of a bf16 call with at most this many query rows a kv head
# (Sq * G) takes the split-KV decode kernels: one m16 tile of rows.
DECODE_ROWS = 16

# (library, extern "C" entry point) of each kernel
_SIMT = {"fwd": ("flash_attention", "repro_flash_fwd"),
         "bwd_dq": ("flash_attention", "repro_flash_bwd_dq"),
         "bwd_dkdv": ("flash_attention", "repro_flash_bwd_dkdv")}
_WGMMA = {"fwd": ("flash_attention_sm90", "repro_flash_wg_fwd"),
          "bwd_dq": ("flash_attention_sm90", "repro_flash_wg_bwd_dq"),
          "bwd_dkdv": ("flash_attention_sm90", "repro_flash_wg_bwd_dkdv")}
_DECODE = ("flash_decode", "repro_flash_decode")
# (dtype, head dim) -> {kernel: (library, entry point)}. The f32 and the
# mma.sync routes share the entry points of flash_attention.cu, which pick
# the SIMT or the tensor-core kernel by dtype; f32 decode calls keep the
# SIMT forward.
ROUTES = {
    (dtype, hd): dict(
        _WGMMA if dtype == torch.bfloat16 and hd in (64, 128) else _SIMT,
        fwd_decode=_DECODE if dtype == torch.bfloat16 else _SIMT["fwd"])
    for dtype in (torch.float32, torch.bfloat16) for hd in HEAD_DIMS
}
# The one entry point that takes f32 scratch for per-head partials (bf16,
# Hq > Hkv); the wgmma bwd_dkdv sums the heads in registers.
_PARTIALS_ENTRY = _SIMT["bwd_dkdv"]

# Launches by (entry point, dtype, head dim) since the last reset.
ROUTE_LAUNCHES: Dict[Tuple[str, torch.dtype, int], int] = {}


def reset_route_launches() -> None:
    ROUTE_LAUNCHES.clear()


def _check_qkv(what: str, q, k, v):
    """(B, Sq, Skv, Hq, Hkv, hd) of a call the kernels take, or raise."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not in "
                            f"{tuple(DTYPE_CODES)}")
        if t.ndim != 4:
            raise ValueError(f"{what}: {name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v on different devices")
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    if (tuple(k.shape) != tuple(v.shape) or k.shape[0] != b
            or k.shape[3] != hd):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    if min(b, sq, skv, hq, hkv) <= 0 or hq % hkv:
        raise ValueError(f"{what}: need B, Sq, Skv > 0 and Hkv dividing Hq, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"{what}: B and Hq must be <= {_MAX_GRID_YZ}")
    return b, sq, skv, hq, hkv, hd


def _check_aux(what: str, name: str, t, shape, dtype, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{what}: {name} must be contiguous, 16-byte aligned {dtype} "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}"
        )


def _common(dims, causal: bool, window: int, stream: int):
    b, sq, skv, hq, hkv, hd = dims
    return (b, sq, skv, hq, hkv, hd, int(bool(causal)), int(window or 0),
            1.0 / math.sqrt(hd), stream)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(what: str, q: torch.Tensor, kernel: str, *args) -> None:
    """Calls the entry point that :data:`ROUTES` gives ``kernel`` for q's
    dtype and head dim (which ``_check_qkv`` has checked) with ``args``,
    raises on a failed launch and counts it."""
    library, entry = ROUTES[(q.dtype, q.shape[-1])][kernel]
    with torch.cuda.device(q.device):
        rc = getattr(_build.KERNELS.library(library), entry)(*args)
    _build.check(rc, what)
    key = (entry, q.dtype, q.shape[-1])
    ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1


def takes_decode(dtype, sq: int, hq: int, hkv: int) -> bool:
    """Whether a forward call takes ``fwd_decode``: bf16, and at most
    :data:`DECODE_ROWS` query rows a kv head."""
    return dtype == torch.bfloat16 and sq * (hq // hkv) <= DECODE_ROWS


@functools.lru_cache(maxsize=None)
def _decode_chunk(hd: int) -> int:
    """kv rows of a split of the decode forward at head dim ``hd`` (the
    source's rule, asked once per head dim)."""
    library, _ = _DECODE
    return _build.KERNELS.library(library).repro_flash_decode_chunk(hd)


def fwd(q, k, v, *, causal: bool, window: int):
    """-> (out in q's dtype, out_f32, L (B, Sq, Hq) f32). The f32 output
    and L are what the backward reads; for f32 inputs ``out_f32`` is
    ``out`` itself."""
    dims = _check_qkv("flash_attention_fwd", q, k, v)
    b, sq, skv, hq, hkv, hd = dims
    out = torch.empty_like(q)
    out32 = None if q.dtype == torch.float32 else torch.empty(
        q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    kernel, scratch = "fwd", ()
    if takes_decode(q.dtype, sq, hq, hkv):
        # per split: acc (Sq * G, hd) and (m, l) of each query row
        splits = -(-skv // _decode_chunk(hd))
        part = torch.empty(b * hkv * splits * sq * (hq // hkv) * (hd + 2),
                           dtype=torch.float32, device=q.device)
        kernel, scratch = "fwd_decode", (part.data_ptr(),)
    _launch("flash_attention_fwd", q, kernel,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype],
            out.data_ptr(), None if out32 is None else out32.data_ptr(),
            lse.data_ptr(), *scratch,
            *_common(dims, causal, window, _stream(q)))
    return out, out if out32 is None else out32, lse


def bwd_dq(q, k, v, out32, lse, dout, *, causal: bool, window: int):
    """-> (dq in q's dtype, D (B, Sq, Hq) f32 = rowsum(dout * out32))."""
    dims = _check_qkv("flash_attention_bwd_dq", q, k, v)
    b, sq, _, hq, _, _ = dims
    _check_aux("flash_attention_bwd_dq", "out32", out32, q.shape,
               torch.float32, q.device)
    _check_aux("flash_attention_bwd_dq", "lse", lse, (b, sq, hq),
               torch.float32, q.device)
    _check_aux("flash_attention_bwd_dq", "dout", dout, q.shape, q.dtype,
               q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd_dq", q, "bwd_dq",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype],
            out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_common(dims, causal, window, _stream(q)))
    return dq, delta


def bwd_dkdv(q, k, v, lse, delta, dout, *, causal: bool, window: int):
    """-> (dk in k's dtype, dv in v's dtype), given D from :func:`bwd_dq`."""
    dims = _check_qkv("flash_attention_bwd_dkdv", q, k, v)
    b, sq, skv, hq, hkv, hd = dims
    for name, t in (("lse", lse), ("delta", delta)):
        _check_aux("flash_attention_bwd_dkdv", name, t, (b, sq, hq),
                   torch.float32, q.device)
    _check_aux("flash_attention_bwd_dkdv", "dout", dout, q.shape, q.dtype,
               q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = ()
    if ROUTES[(q.dtype, hd)]["bwd_dkdv"] == _PARTIALS_ENTRY:
        part = None
        if q.dtype == torch.bfloat16 and hq > hkv:
            part = torch.empty((2, b, skv, hq, hd), dtype=torch.float32,
                               device=q.device)
        scratch = (None if part is None else part.data_ptr(),)
    _launch("flash_attention_bwd_dkdv", q, "bwd_dkdv",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype],
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *scratch,
            *_common(dims, causal, window, _stream(q)))
    return dk, dv
