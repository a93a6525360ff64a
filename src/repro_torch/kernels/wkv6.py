"""Launchers of the CUDA WKV6 kernels (``csrc/wkv6.cu``).

The counterpart of ``repro/kernels/wkv6.py::wkv6`` (the RWKV-6 WKV
recurrence, chunks of 64) and its backward, the chunked reverse pass of
``ref.wkv6_bwd_ref``. r, k, v, logw (B, S, H, N) f32 with N in
{16, 32, 64}, u (H, N) f32, contiguous, on one card; an optional initial
state s0 (B, H, N, N) f32, which the reference kernel lacks (it starts
from zeros) and its serve path takes (``repro/models/rwkv.py:142``,
``chunked_wkv(..., state=)``). The forward also returns the state after
the last real step; the backward takes an optional gradient for it and
returns one for s0. Each launcher checks
what the kernels take and raises on anything else, allocates its outputs
with ``torch.empty`` and launches on the current stream. CUDA tensors only;
``kernels.ops`` dispatches CPU tensors to ``kernels.ref`` and counts the
launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import WKV_CHUNK

HEAD_DIMS = (16, 32, 64)
_MAX_GRID = 65535


def _check(what: str, tensors, u):
    """(B, S, H, N) of a call the kernels take, or raise."""
    first = tensors[0][1]
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, r on {first.device}")
        if t.ndim != 4 or tuple(t.shape) != tuple(first.shape):
            raise ValueError(f"{what}: {name} must be (B, S, H, N) like r, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, s, h, n = first.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim N must be one of {HEAD_DIMS}, got {n}")
    if min(b, s, h) <= 0 or b > _MAX_GRID or h > _MAX_GRID:
        raise ValueError(f"{what}: need 0 < B, H <= {_MAX_GRID} and S > 0, got "
                         f"{tuple(first.shape)}")
    if (u.device != first.device or u.dtype != torch.float32
            or tuple(u.shape) != (h, n) or not u.is_contiguous()):
        raise ValueError(f"{what}: u must be contiguous f32 {(h, n)} on "
                         f"{first.device}, got {u.dtype} {tuple(u.shape)} on "
                         f"{u.device}")
    return b, s, h, n


def num_chunks(s: int) -> int:
    return -(-s // WKV_CHUNK)


def _chunk_vectors(b, h, s, n, device):
    return torch.empty((b, h, num_chunks(s), n), dtype=torch.float32,
                       device=device)


def _check_square(what: str, name: str, t, like, b, h, n):
    """``t`` must be a contiguous f32 (B, H, N, N) on ``like``'s card."""
    want = (b, h, n, n)
    if (t.device != like.device or t.dtype != torch.float32
            or tuple(t.shape) != want or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be contiguous f32 {want} on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _ptr(t):
    """The data pointer, or None (NULL) for an absent optional."""
    return None if t is None else t.data_ptr()


def _aligned(*tensors):
    """The tensors, each copied if its data is not 16-byte aligned (the
    kernels stage rows with 16-byte copies; a contiguous view can start
    anywhere in its storage)."""
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for t in tensors)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd(r, k, v, logw, u, s0=None):
    """-> (out (B, S, H, N) f32, states (B, H, ceil(S / 64), N, N) f32, the
    state entering each chunk, the first ``s0`` or zeros, final (B, H, N,
    N) f32, the state after step S - 1)."""
    b, s, h, n = _check("wkv6_fwd", (("r", r), ("k", k), ("v", v),
                                     ("logw", logw)), u)
    if s0 is not None:
        _check_square("wkv6_fwd", "s0", s0, r, b, h, n)
    out = torch.empty_like(r)
    states = torch.empty((b, h, num_chunks(s), n, n), dtype=torch.float32,
                         device=r.device)
    final = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    dvec = _chunk_vectors(b, h, s, n, r.device)  # scratch: e^{lcw_last}
    r, k, v, logw, u, s0 = _aligned(r, k, v, logw, u, s0)
    lib = _build.KERNELS.library("wkv6")
    with torch.cuda.device(r.device):
        rc = lib.repro_wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                logw.data_ptr(), u.data_ptr(), _ptr(s0),
                                out.data_ptr(), states.data_ptr(),
                                final.data_ptr(), dvec.data_ptr(), b, s, h,
                                n, _stream(r))
    _build.check(rc, "wkv6_fwd")
    return out, states, final


def bwd(r, k, v, logw, u, states, dout, s0=None, final=None, dfinal=None):
    """-> (dr, dk, dv, dlogw (B, S, H, N), du (H, N), ds0 (B, H, N, N) or
    None without ``s0``), all f32. ``dfinal`` (B, H, N, N), the gradient of
    the final state, needs the forward's ``final``; without it the reverse
    pass starts from zero, as before there was a final state."""
    b, s, h, n = _check("wkv6_bwd", (("r", r), ("k", k), ("v", v),
                                     ("logw", logw), ("dout", dout)), u)
    if s0 is not None:
        _check_square("wkv6_bwd", "s0", s0, r, b, h, n)
    if dfinal is not None:
        if final is None:
            raise ValueError("wkv6_bwd: dfinal needs the forward's final state")
        _check_square("wkv6_bwd", "dfinal", dfinal, r, b, h, n)
        _check_square("wkv6_bwd", "final", final, r, b, h, n)
    else:
        final = None
    want = (b, h, num_chunks(s), n, n)
    if (states.device != r.device or states.dtype != torch.float32
            or tuple(states.shape) != want or not states.is_contiguous()):
        raise ValueError(f"wkv6_bwd: states must be contiguous f32 {want} on "
                         f"{r.device}, got {states.dtype} "
                         f"{tuple(states.shape)} on {states.device}")
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    dstates = torch.empty_like(states)
    # scratch: each chunk's e^{lcw_last} and its share of du
    dvec, du_part = (_chunk_vectors(b, h, s, n, r.device) for _ in range(2))
    du = torch.empty((h, n), dtype=torch.float32, device=r.device)
    ds0 = (None if s0 is None else
           torch.empty((b, h, n, n), dtype=torch.float32, device=r.device))
    r, k, v, logw, u, states, dout, final, dfinal = _aligned(
        r, k, v, logw, u, states, dout, final, dfinal)
    lib = _build.KERNELS.library("wkv6")
    with torch.cuda.device(r.device):
        rc = lib.repro_wkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                logw.data_ptr(), u.data_ptr(),
                                states.data_ptr(), _ptr(final),
                                dout.data_ptr(), _ptr(dfinal), dr.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(),
                                dlogw.data_ptr(), _ptr(ds0),
                                dstates.data_ptr(), dvec.data_ptr(),
                                du_part.data_ptr(), du.data_ptr(), b, s, h, n,
                                _stream(r))
    _build.check(rc, "wkv6_bwd")
    return dr, dk, dv, dlogw, du, ds0
