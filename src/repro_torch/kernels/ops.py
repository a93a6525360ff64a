"""Public kernel entry points with their launch counters.

Dispatch rule: a CUDA tensor launches the hand-written kernel (or the
launcher raises); a CPU tensor runs the plain PyTorch version in
``kernels.ref``. There is no other fallback: a build or launch failure
propagates. Each wrapper carries ``launches``, a plain integer that grows
by one exactly where the kernel is launched, so a run can show that its
main path went through the kernels (:func:`reset_launches`,
:func:`launch_counts`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import flash_attention as _fa
from . import quantize as _quant
from . import reduce_compress as _rc
from . import ref as _ref
from . import rglru_scan as _lru
from . import wkv6 as _wkv


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def quantize(x: torch.Tensor):
    """(R, C) -> (q int8 (R, C), scale f32 (R, 1)): per-row symmetric int8."""
    if not _on_card(x, "quantize"):
        return _ref.quantize_ref(x)
    out = _quant.quantize(x)
    quantize.launches += 1
    return out


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``(q * scale)`` in ``dtype``."""
    if not _on_card(q, "dequantize"):
        return _ref.dequantize_ref(q, scales, dtype)
    out = _quant.dequantize(q, scales, dtype)
    dequantize.launches += 1
    return out


def reduce_compress_roundtrip(x: torch.Tensor, *, axis: int = 0,
                              qaxis: int = -1) -> torch.Tensor:
    """Mean over ``axis`` then an int8 roundtrip with per-row scales over
    ``qaxis`` (an axis of the partial), in one pass over ``x``.

    The execution of the ``compress="int8"``-tagged ``reduce_mean``
    (``core/hierarchical.py`` fast path), as ``repro/kernels/ops.py:137-192``
    canonicalizes it: the quant axis goes last, the axes before ``axis``
    fold into the kernel's L dimension (instead of a vmap over pods), the
    rest into R rows of ``C`` values: ``(L, G, R, C)``. A quant axis among
    the leading pod axes (``qaxis < axis``) is not ported, on either
    device: the fast path never binds it.
    """
    on_card = _on_card(x, "reduce_compress_roundtrip")
    part_ndim = x.ndim - 1
    if part_ndim < 1:
        raise ValueError("reduce_compress_roundtrip needs a non-group axis")
    axis = axis % x.ndim
    qaxis = qaxis % part_ndim
    if qaxis < axis:
        raise NotImplementedError(
            "reduce_compress_roundtrip: a quant axis before the reduced axis "
            "is not ported"
        )
    lead = tuple(x.shape[:axis])
    g = x.shape[axis]
    if qaxis != part_ndim - 1:
        x = x.movedim(qaxis + 1, -1)
    trail = tuple(x.shape[axis + 1:])
    x4 = x.reshape(math.prod(lead), g, math.prod(trail[:-1]), trail[-1])
    if on_card:
        back, _, _ = _rc.reduce_compress_roundtrip(x4.contiguous())
        reduce_compress_roundtrip.launches += 1
    else:
        back, _, _ = _ref.reduce_compress_roundtrip_ref(x4)
    back = back.reshape(lead + trail)
    if qaxis != part_ndim - 1:
        back = back.movedim(-1, qaxis)
    return back


def reduce_compress(x: torch.Tensor):
    """The int8 wire payload of a partial mean: (..., G, R, 256) ->
    (q (..., R, 256) int8, s (..., R, 1) f32), the mean over G quantized
    per 256-wide row (K3a, ``repro/kernels/ops.py:85``). The leading axes
    fold into the kernel's L dimension, as in
    :func:`reduce_compress_roundtrip`."""
    on_card = _on_card(x, "reduce_compress")
    if x.ndim < 3:
        raise ValueError(f"reduce_compress: expected (..., G, R, C), got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-3])
    x4 = x.reshape((math.prod(lead),) + tuple(x.shape[-3:]))
    if on_card:
        q, s = _rc.reduce_compress(x4.contiguous())
        reduce_compress.launches += 1
    else:
        q, s = _ref.reduce_compress_ref(x4)
    return q.reshape(lead + q.shape[1:]), s.reshape(lead + s.shape[1:])


def dequant_accumulate(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The cross-pod leg: ((P, R, C) int8, (P, R, 1) f32) -> (R, C) f32, the
    mean over P of the dequantized payloads (K3c,
    ``repro/kernels/ops.py:92``)."""
    if not _on_card(q, "dequant_accumulate"):
        return _ref.dequant_accumulate_ref(q, scales)
    out = _rc.dequant_accumulate(q, scales)
    dequant_accumulate.launches += 1
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """K2 forward: -> (out in q's dtype, out_f32, L (B, Sq, Hq) f32)."""
    if not _on_card(q, "flash_attention_fwd"):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _fa.fwd(q, k, v, causal=causal, window=window)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_bwd_dq(q, k, v, out32, lse, dout, *, causal: bool = True,
                           window: int = 0):
    """K2 backward, first half: -> (dq, D = rowsum(dout * out_f32))."""
    if not _on_card(q, "flash_attention_bwd_dq"):
        return _ref.flash_attention_bwd_dq_ref(q, k, v, out32, lse, dout,
                                               causal=causal, window=window)
    out = _fa.bwd_dq(q, k, v, out32, lse, dout, causal=causal, window=window)
    flash_attention_bwd_dq.launches += 1
    return out


def flash_attention_bwd_dkdv(q, k, v, lse, delta, dout, *,
                             causal: bool = True, window: int = 0):
    """K2 backward, second half: -> (dk, dv), given D."""
    if not _on_card(q, "flash_attention_bwd_dkdv"):
        return _ref.flash_attention_bwd_dkdv_ref(q, k, v, lse, delta, dout,
                                                 causal=causal, window=window)
    out = _fa.bwd_dkdv(q, k, v, lse, delta, dout, causal=causal,
                       window=window)
    flash_attention_bwd_dkdv.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """``flash_attention_xla``'s custom VJP: the forward saves q, k, v, the
    f32 output and L (``repro/models/attention.py:_flash_fwd_rule``), the
    backward recomputes p from L. Works under non-reentrant
    ``torch.utils.checkpoint``, which runs the forward again in the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, out32, lse = flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                           causal=ctx.causal,
                                           window=ctx.window)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, delta, dout,
                                          causal=ctx.causal,
                                          window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash attention with its backward: q (B, Sq, Hq, hd), k/v
    (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in q's dtype. On the card the K2
    kernels (forward, then ``bwd_dq`` and ``bwd_dkdv``); on the CPU their
    plain versions."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), int(window or 0))


def lru_scan_fwd(a, b, h0=None):
    """K4 forward: ``h_t = a_t * h_{t-1} + b_t`` over axis 1 of (B, S, W),
    f32 state, -> h in a's dtype."""
    if not _on_card(a, "lru_scan_fwd"):
        return _ref.lru_scan_ref(a, b, h0)
    out = _lru.fwd(a, b, h0)
    lru_scan_fwd.launches += 1
    return out


def lru_scan_bwd(a, h, g, h0=None):
    """K4 backward, the reverse scan: -> (da, db, dh0 f32 (B, W))."""
    if not _on_card(a, "lru_scan_bwd"):
        return _ref.lru_scan_bwd_ref(a, h, g, h0)
    out = _lru.bwd(a, h, g, h0)
    lru_scan_bwd.launches += 1
    return out


class _LruScan(torch.autograd.Function):
    """The RG-LRU scan with the reverse scan as its backward. Saves a, the
    output h and h0; works under non-reentrant ``torch.utils.checkpoint``,
    which runs the forward again in the backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = lru_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = lru_scan_bwd(a, h, g.contiguous(), h0)
        return da, db, None if h0 is None else dh0


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` with its backward: a, b (B, S, W), h0
    (B, W) f32 or None -> h (B, S, W) in a's dtype. On the card the K4
    kernels, on the CPU their plain versions."""
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    return _LruScan.apply(a.contiguous(), b.contiguous(), h0)


def wkv6_fwd(r, k, v, logw, u):
    """K5 forward: the WKV6 recurrence over axis 1 of (B, S, H, N) f32 ->
    (out f32, states): on the card the state entering each 64-step chunk
    (B, H, ceil(S / 64), N, N), which the backward kernel reads; on the
    CPU None (the plain backward runs the recurrence again)."""
    if not _on_card(r, "wkv6_fwd"):
        return _ref.wkv6_ref(r, k, v, logw, u), None
    out = _wkv.fwd(r, k, v, logw, u)
    wkv6_fwd.launches += 1
    return out


def wkv6_bwd(r, k, v, logw, u, states, dout):
    """K5 backward, the chunked reverse pass: -> (dr, dk, dv, dlogw, du),
    f32; du (H, N) summed over batch and chunks in a fixed order."""
    if not _on_card(r, "wkv6_bwd"):
        return _ref.wkv6_bwd_ref(r, k, v, logw, u, dout)
    out = _wkv.bwd(r, k, v, logw, u, states, dout)
    wkv6_bwd.launches += 1
    return out


class _Wkv6(torch.autograd.Function):
    """WKV6 with the chunked reverse pass as its backward. Saves the inputs
    and the chunk states (none on the CPU); works under non-reentrant
    ``torch.utils.checkpoint``, which runs the forward again in the
    backward."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        out, states = wkv6_fwd(r, k, v, logw, u)
        ctx.save_for_backward(r, k, v, logw, u, states)
        return out

    @staticmethod
    def backward(ctx, dout):
        r, k, v, logw, u, states = ctx.saved_tensors
        return wkv6_bwd(r, k, v, logw, u, states, dout.contiguous())


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 WKV recurrence with its backward: r, k, v, logw
    (B, S, H, N), u (H, N), all f32 -> out (B, S, H, N) f32, from a zero
    state. On the card the K5 kernels, on the CPU their plain versions."""
    return _Wkv6.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                       logw.contiguous(), u.contiguous())


KERNEL_WRAPPERS = (quantize, dequantize, reduce_compress_roundtrip,
                   reduce_compress, dequant_accumulate, flash_attention_fwd,
                   flash_attention_bwd_dq, flash_attention_bwd_dkdv,
                   lru_scan_fwd, lru_scan_bwd, wkv6_fwd, wkv6_bwd)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launches() -> None:
    """Every wrapper's count to 0, and K4's launches by route
    (``rglru_scan.ROUTE_LAUNCHES``)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    _lru.reset_route_launches()


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
