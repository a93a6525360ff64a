"""Public kernel entry points: registered ops with their launch counters.

Every kernel is a ``torch.library`` op in the ``repro`` namespace
(``torch.ops.repro.quantize``, ``flash_attention_fwd``, ...) with three
implementations: the CUDA one launches the hand-written kernel (or the
launcher raises), the CPU one runs the plain PyTorch version in
``kernels.ref``, and the fake one gives the output shapes to a tracer.
There is no other fallback: a build or launch failure propagates. Being
ops, the kernels stay visible to a tracer: a traced round holds each
launch as one ``repro`` node (a ctypes launch would be invisible, and its
output a constant of the trace).

Each Python wrapper below goes through its op whenever a dispatch mode is
active (a tracer, fake tensors); otherwise it calls the same CUDA or CPU
implementation directly, since the dispatcher's Python round trip added
0.01-0.03 ms to the event times of the smaller kernels on the card
(``scripts/compare_parent.sh``, PERF.md §6). Each wrapper carries ``launches``, a plain integer that the
CUDA implementation grows by one exactly where the kernel is launched, so
a run can show that its main path went through the kernels
(:func:`reset_launches`, :func:`launch_counts`). A replay of a captured
CUDA graph launches the kernels without running this Python, so it does
not count; a capture records launches without making them, so it runs
under :func:`uncounted`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.flop_counter

from . import flash_attention as _fa
from . import quantize as _quant
from . import reduce_compress as _rc
from . import ref as _ref
from . import rglru_scan as _lru
from . import wkv6 as _wkv

Tensor = torch.Tensor


# Defined through ``torch.library.Library``, not ``custom_op``, whose
# wrapper layers cost several times the dispatch itself. The ops have no
# autograd kernel: the ``autograd.Function`` classes below call them in
# their forward and backward, where grad mode is off.
_LIB = torch.library.Library("repro", "DEF")
_IMPLS: Dict[str, Dict[str, Callable]] = {}


def _op(name: str, schema: str, plain, card, fake) -> None:
    """Register ``repro::name(schema)``: ``plain`` on CPU tensors, ``card``
    on CUDA tensors (counted on the wrapper of the same name), ``fake``
    for tracing."""
    _LIB.define(name + schema)

    def launch(*args):
        out = card(*args)
        globals()[name].launches += 1
        return out

    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro::{name}", fake, lib=_LIB)
    _IMPLS[name] = {"cpu": plain, "cuda": launch}


def _call(name: str, *args):
    """Kernel op ``name`` on ``args``: through the dispatcher (one graph
    node) under an active dispatch mode, else its implementation for the
    first argument's device, called directly."""
    if torch._C._len_torch_dispatch_stack():
        return getattr(torch.ops.repro, name)(*args)
    impl = _IMPLS[name].get(args[0].device.type)
    if impl is None:
        raise ValueError(f"{name}: unsupported device {args[0].device}")
    return impl(*args)


def _empty0(like: Tensor) -> Tensor:
    """A 0-element f32 tensor: an op output that stands for "none"."""
    return like.new_empty((0,), dtype=torch.float32)


# -- K1: per-row int8 --------------------------------------------------------


def _quantize_plain(x: Tensor) -> Tuple[Tensor, Tensor]:
    return _ref.quantize_ref(x)


def _quantize_fake(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0], 1), dtype=torch.float32))


_op("quantize", "(Tensor x) -> (Tensor, Tensor)", _quantize_plain,
    _quant.quantize, _quantize_fake)


def _dequantize_plain(q: Tensor, scales: Tensor, dtype: torch.dtype) -> Tensor:
    return _ref.dequantize_ref(q, scales, dtype)


_op("dequantize", "(Tensor q, Tensor scales, ScalarType dtype) -> Tensor",
    _dequantize_plain, _quant.dequantize,
    lambda q, scales, dtype: q.new_empty(q.shape, dtype=dtype))


# -- K3: reduce + compress -------------------------------------------------


def _rc_roundtrip_plain(x4: Tensor) -> Tensor:
    return _ref.reduce_compress_roundtrip_ref(x4)[0]


def _rc_roundtrip_card(x4):
    return _rc.reduce_compress_roundtrip(x4.contiguous())[0]


_op("reduce_compress_roundtrip", "(Tensor x4) -> Tensor", _rc_roundtrip_plain,
    _rc_roundtrip_card,
    lambda x4: x4.new_empty((x4.shape[0],) + tuple(x4.shape[2:])))


def _rc_plain(x4: Tensor) -> Tuple[Tensor, Tensor]:
    return _ref.reduce_compress_ref(x4)


def _rc_fake(x4):
    l, _, r, c = x4.shape
    return (x4.new_empty((l, r, c), dtype=torch.int8),
            x4.new_empty((l, r, 1), dtype=torch.float32))


_op("reduce_compress", "(Tensor x4) -> (Tensor, Tensor)", _rc_plain,
    lambda x4: _rc.reduce_compress(x4.contiguous()), _rc_fake)


def _dequant_accumulate_plain(q: Tensor, scales: Tensor) -> Tensor:
    return _ref.dequant_accumulate_ref(q, scales)


_op("dequant_accumulate", "(Tensor q, Tensor scales) -> Tensor",
    _dequant_accumulate_plain, _rc.dequant_accumulate,
    lambda q, scales: q.new_empty(q.shape[1:], dtype=torch.float32))


# -- K2: flash attention ---------------------------------------------------


def _no_alias(out, out32, lse):
    """An op's outputs may not alias each other: for f32, where the f32
    output is the output itself, the op returns a 0-element tensor in its
    place and the wrapper puts the output back."""
    return out, (_empty0(out) if out32 is out else out32), lse


def _fa_fwd_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: int) -> Tuple[Tensor, Tensor, Tensor]:
    return _no_alias(*_ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window))


def _fa_fwd_card(q, k, v, causal, window):
    return _no_alias(*_fa.fwd(q, k, v, causal=causal, window=window))


def _fa_fwd_fake(q, k, v, causal, window):
    b, sq, hq, _ = q.shape
    out32 = (_empty0(q) if q.dtype == torch.float32
             else q.new_empty(q.shape, dtype=torch.float32))
    return (q.new_empty(q.shape), out32,
            q.new_empty((b, sq, hq), dtype=torch.float32))


_op("flash_attention_fwd", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "int window) -> (Tensor, Tensor, Tensor)", _fa_fwd_plain, _fa_fwd_card,
    _fa_fwd_fake)


def _fa_dq_plain(q: Tensor, k: Tensor, v: Tensor, out32: Tensor, lse: Tensor,
                 dout: Tensor, causal: bool,
                 window: int) -> Tuple[Tensor, Tensor]:
    return _ref.flash_attention_bwd_dq_ref(q, k, v, out32, lse, dout,
                                           causal=causal, window=window)


def _fa_dq_card(q, k, v, out32, lse, dout, causal, window):
    return _fa.bwd_dq(q, k, v, out32, lse, dout, causal=causal, window=window)


_op("flash_attention_bwd_dq", "(Tensor q, Tensor k, Tensor v, Tensor out32, "
    "Tensor lse, Tensor dout, bool causal, int window) -> (Tensor, Tensor)",
    _fa_dq_plain, _fa_dq_card,
    lambda q, k, v, out32, lse, dout, causal, window: (
        q.new_empty(q.shape), lse.new_empty(lse.shape)))


def _fa_dkdv_plain(q: Tensor, k: Tensor, v: Tensor, lse: Tensor,
                   delta: Tensor, dout: Tensor, causal: bool,
                   window: int) -> Tuple[Tensor, Tensor]:
    return _ref.flash_attention_bwd_dkdv_ref(q, k, v, lse, delta, dout,
                                             causal=causal, window=window)


def _fa_dkdv_card(q, k, v, lse, delta, dout, causal, window):
    return _fa.bwd_dkdv(q, k, v, lse, delta, dout, causal=causal,
                        window=window)


_op("flash_attention_bwd_dkdv", "(Tensor q, Tensor k, Tensor v, Tensor lse, "
    "Tensor delta, Tensor dout, bool causal, int window) -> (Tensor, Tensor)",
    _fa_dkdv_plain, _fa_dkdv_card,
    lambda q, k, v, lse, delta, dout, causal, window: (
        k.new_empty(k.shape), v.new_empty(v.shape)))


# -- K4: the RG-LRU scan ---------------------------------------------------


def _lru_fwd_plain(a: Tensor, b: Tensor, h0: Optional[Tensor]) -> Tensor:
    return _ref.lru_scan_ref(a, b, h0)


_op("lru_scan_fwd", "(Tensor a, Tensor b, Tensor? h0) -> Tensor",
    _lru_fwd_plain, _lru.fwd,
    lambda a, b, h0: a.new_empty(a.shape))


def _lru_bwd_plain(a: Tensor, h: Tensor, g: Tensor,
                   h0: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    return _ref.lru_scan_bwd_ref(a, h, g, h0)


_op("lru_scan_bwd", "(Tensor a, Tensor h, Tensor g, Tensor? h0) -> "
    "(Tensor, Tensor, Tensor)", _lru_bwd_plain, _lru.bwd,
    lambda a, h, g, h0: (a.new_empty(a.shape), a.new_empty(a.shape),
                         a.new_empty((a.shape[0], a.shape[2]),
                                     dtype=torch.float32)))


# -- K5: WKV6 --------------------------------------------------------------


def _wkv_fwd_plain(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                   s0: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    out, _, final = _ref.wkv6_fwd_ref(r, k, v, logw, u, s0)
    return out, _empty0(r), final


def _wkv_fwd_fake(r, k, v, logw, u, s0):
    b, s, h, n = r.shape
    final = r.new_empty((b, h, n, n), dtype=torch.float32)
    if r.device.type != "cuda":
        return r.new_empty(r.shape), _empty0(r), final
    return r.new_empty(r.shape), r.new_empty(
        (b, h, _wkv.num_chunks(s), n, n), dtype=torch.float32), final


_op("wkv6_fwd", "(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, "
    "Tensor? s0) -> (Tensor, Tensor, Tensor)", _wkv_fwd_plain, _wkv.fwd,
    _wkv_fwd_fake)


def _ds0_or_empty(grads, r):
    """An op output may not be None: an absent ds0 is a 0-element tensor."""
    return grads[:5] + (_empty0(r) if grads[5] is None else grads[5],)


def _wkv_bwd_plain(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                   states: Optional[Tensor], dout: Tensor,
                   s0: Optional[Tensor], final: Optional[Tensor],
                   dfinal: Optional[Tensor]) -> Tuple[Tensor, ...]:
    return _ds0_or_empty(_ref.wkv6_bwd_ref(r, k, v, logw, u, dout, s0,
                                           dfinal), r)


def _wkv_bwd_card(r, k, v, logw, u, states, dout, s0, final, dfinal):
    return _ds0_or_empty(_wkv.bwd(r, k, v, logw, u, states, dout, s0, final,
                                  dfinal), r)


_op("wkv6_bwd", "(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, "
    "Tensor? states, Tensor dout, Tensor? s0, Tensor? final, "
    "Tensor? dfinal) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _wkv_bwd_plain, _wkv_bwd_card,
    lambda r, k, v, logw, u, states, dout, s0, final, dfinal: tuple(
        t.new_empty(t.shape) for t in (r, k, v, logw, u)) + (
        _empty0(r) if s0 is None else s0.new_empty(s0.shape),))


# ---------------------------------------------------------------------------
# FLOP formulas (``torch.utils.flop_counter``)
# ---------------------------------------------------------------------------
#
# ``FlopCounterMode`` counts an op it has no formula for as 0, and under any
# dispatch mode each kernel is one ``repro`` node: these formulas count the
# work each kernel's inputs need, as the ``.cu`` headers count it. The int8
# kernels (K1, K3) do no products; their bytes are the memory term's.


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs ``ref.visible_mask`` lets attend, counted
    a query row at a time in numpy (positions start at 0 for both)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window and window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_flop(per_pair: int):
    def formula(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
        b, sq, hq, hd = q_shape
        causal, window = args[-2], args[-1]
        return per_pair * hd * hq * b * visible_pairs(sq, k_shape[1], causal,
                                                      window)

    return formula


# per visible pair and query head: the forward's q.k and p.v (4 hd);
# bwd_dq recomputes s and dp and forms dq (6 hd); bwd_dkdv recomputes s and
# dp and forms dv and dk (8 hd)
torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro.flash_attention_fwd)(_flash_flop(4))
torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro.flash_attention_bwd_dq)(_flash_flop(6))
torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro.flash_attention_bwd_dkdv)(_flash_flop(8))


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro.lru_scan_fwd)
def _lru_fwd_flop(a_shape, b_shape, h0_shape, *, out_shape=None,
                  **kwargs) -> int:
    """h_t = a_t h_{t-1} + b_t: a product and a sum an element."""
    return 2 * math.prod(a_shape)


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro.lru_scan_bwd)
def _lru_bwd_flop(a_shape, h_shape, g_shape, h0_shape, *, out_shape=None,
                  **kwargs) -> int:
    """dh_t = g_t + a_{t+1} dh_{t+1} and da_t = dh_t h_{t-1}: three an
    element; dh0 = a_0 dh_0 one a (batch, width) entry, given h0."""
    b, _, w = a_shape
    return 3 * math.prod(a_shape) + (b * w if h0_shape is not None else 0)


def _wkv_chunks(s: int):
    c = _ref.WKV_CHUNK
    return [min(c, s - c * i) for i in range(-(-s // c))]


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro.wkv6_fwd)
def _wkv_fwd_flop(r_shape, *args, out_shape=None, **kwargs) -> int:
    """Per (batch, head) and chunk of L steps, the chunked form's products:
    the scores and their product with v (2 L^2 N) and the state's readout
    and update (4 L N^2)."""
    b, s, h, n = r_shape
    return b * h * sum(2 * L * L * n + 4 * L * n * n for L in _wkv_chunks(s))


@torch.utils.flop_counter.register_flop_formula(torch.ops.repro.wkv6_bwd)
def _wkv_bwd_flop(r_shape, *args, out_shape=None, **kwargs) -> int:
    """Per (batch, head) and chunk of L steps: 5 L^2 N + 8 L N^2."""
    b, s, h, n = r_shape
    return b * h * sum(5 * L * L * n + 8 * L * n * n for L in _wkv_chunks(s))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor):
    """(R, C) -> (q int8 (R, C), scale f32 (R, 1)): per-row symmetric int8."""
    return _call("quantize", x)


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``(q * scale)`` in ``dtype``."""
    return _call("dequantize", q, scales, dtype)


def reduce_compress_roundtrip(x: torch.Tensor, *, axis: int = 0,
                              qaxis: int = -1) -> torch.Tensor:
    """Mean over ``axis`` then an int8 roundtrip with per-row scales over
    ``qaxis`` (an axis of the partial), in one pass over ``x``.

    The execution of the ``compress="int8"``-tagged ``reduce_mean``
    (``core/hierarchical.py`` fast path), as ``repro/kernels/ops.py:137-192``
    canonicalizes it: the quant axis goes last, the axes before ``axis``
    fold into the kernel's L dimension (instead of a vmap over pods), the
    rest into R rows of ``C`` values: ``(L, G, R, C)``, one launch of the
    ``repro.reduce_compress_roundtrip`` op.

    A quant axis among the leading pod axes (``qaxis < axis``) has no
    kernel, as in the reference (``repro/kernels/ops.py:137-142``), which
    runs its ``_reduce_compress_roundtrip_jnp`` on every device:
    :func:`_roundtrip_lead_qaxis` computes that form with plain tensor ops
    on either device.
    """
    part_ndim = x.ndim - 1
    if part_ndim < 1:
        raise ValueError("reduce_compress_roundtrip needs a non-group axis")
    axis = axis % x.ndim
    qaxis = qaxis % part_ndim
    if qaxis < axis:
        return _roundtrip_lead_qaxis(x, axis, qaxis)
    lead = tuple(x.shape[:axis])
    g = x.shape[axis]
    if qaxis != part_ndim - 1:
        x = x.movedim(qaxis + 1, -1)
    trail = tuple(x.shape[axis + 1:])
    x4 = x.reshape(math.prod(lead), g, math.prod(trail[:-1]), trail[-1])
    back = _call("reduce_compress_roundtrip", x4)
    back = back.reshape(lead + trail)
    if qaxis != part_ndim - 1:
        back = back.movedim(-1, qaxis)
    return back


def _roundtrip_lead_qaxis(x: torch.Tensor, axis: int,
                          qaxis: int) -> torch.Tensor:
    """``repro/kernels/ops.py:_reduce_compress_roundtrip_jnp`` for a quant
    axis before the reduced axis: the mean over ``axis`` as an f32 sum
    times the f32 reciprocal of G, in ``x``'s dtype, then the roundtrip of
    ``kernels.ref`` with one scale per row along ``qaxis``. For bf16 this
    is the reference's arithmetic. For f32 with L^2 G <= 2^22 the
    reference takes the mean as a gemm with weights 1/G (ROADMAP R7), whose
    partial can differ from this one in the last bit, and so its int8 codes
    by one step."""
    g = x.shape[axis]
    part = (x.to(torch.float32).sum(dim=axis) * (1.0 / g)).to(x.dtype)
    moved = part.movedim(qaxis, -1)
    q, s = _ref.quantize_ref(moved.reshape(-1, moved.shape[-1]))
    back = _ref.dequantize_ref(q, s, part.dtype).reshape(moved.shape)
    return back.movedim(-1, qaxis)


def reduce_compress(x: torch.Tensor):
    """The int8 wire payload of a partial mean: (..., G, R, 256) ->
    (q (..., R, 256) int8, s (..., R, 1) f32), the mean over G quantized
    per 256-wide row (K3a, ``repro/kernels/ops.py:85``). The leading axes
    fold into the kernel's L dimension, as in
    :func:`reduce_compress_roundtrip`."""
    if x.ndim < 3:
        raise ValueError(f"reduce_compress: expected (..., G, R, C), got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-3])
    x4 = x.reshape((math.prod(lead),) + tuple(x.shape[-3:]))
    q, s = _call("reduce_compress", x4)
    return q.reshape(lead + q.shape[1:]), s.reshape(lead + s.shape[1:])


def dequant_accumulate(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The cross-pod leg: ((P, R, C) int8, (P, R, 1) f32) -> (R, C) f32, the
    mean over P of the dequantized payloads (K3c,
    ``repro/kernels/ops.py:92``)."""
    return _call("dequant_accumulate", q, scales)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """K2 forward: -> (out in q's dtype, out_f32, L (B, Sq, Hq) f32); for
    f32 inputs ``out_f32`` is ``out`` itself."""
    out, out32, lse = _call("flash_attention_fwd", q, k, v, bool(causal),
                            int(window or 0))
    return out, out if out32.numel() == 0 else out32, lse


def flash_attention_bwd_dq(q, k, v, out32, lse, dout, *, causal: bool = True,
                           window: int = 0):
    """K2 backward, first half: -> (dq, D = rowsum(dout * out_f32))."""
    return _call("flash_attention_bwd_dq", q, k, v, out32, lse, dout,
                 bool(causal), int(window or 0))


def flash_attention_bwd_dkdv(q, k, v, lse, delta, dout, *,
                             causal: bool = True, window: int = 0):
    """K2 backward, second half: -> (dk, dv), given D."""
    return _call("flash_attention_bwd_dkdv", q, k, v, lse, delta, dout,
                 bool(causal), int(window or 0))


def _grad_inputs(saved):
    """For a recompute under autograd: a view of each saved tensor that
    carries a graph (so a third order reaches the input, and an input
    passed twice gets each position's own gradient), a fresh leaf of one
    that does not; None stays None."""
    return [None if t is None else
            t.view_as(t) if t.requires_grad else
            t.detach().requires_grad_(True) for t in saved]


def _vjp(outs, cotangents, ins, needs, create: bool):
    """Gradients of ``outs`` (None entries skipped) with respect to the
    ``ins`` marked in ``needs``, each in its input's dtype, None for the
    rest: ``torch.autograd.grad``, with ``create_graph`` when ``create``
    (the caller's grad mode was on: it asked for one more order)."""
    pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, cotangents)
             if o is not None and g is not None]
    want = [x for x, need in zip(ins, needs) if need and x is not None]
    got = iter(torch.autograd.grad(
        [o for o, _ in pairs], want, [g for _, g in pairs],
        create_graph=create, allow_unused=True,
        materialize_grads=True) if pairs and want else ())
    return [next(got) if need and x is not None else None
            for x, need in zip(ins, needs)]


class _FlashAttention(torch.autograd.Function):
    """``flash_attention_xla``'s custom VJP: the forward saves q, k, v, the
    f32 output and L (``repro/models/attention.py:_flash_fwd_rule``), the
    backward (:class:`_FlashAttentionBackward`) recomputes p from L. Works
    under non-reentrant ``torch.utils.checkpoint``, which runs the forward
    again in the backward. The forward returns the op's three outputs (the
    f32 output as a 0-element tensor for f32 inputs), the last two not
    differentiable: :func:`flash_attention` hands out the first."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return _call("flash_attention_fwd", q, k, v, causal, window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, out32, lse = output
        ctx.mark_non_differentiable(out32, lse)
        ctx.save_for_backward(q, k, v, out if out32.numel() == 0 else out32,
                              lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, dout, _dout32, _dlse):
        q, k, v, out32, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBackward.apply(
            q, k, v, out32.detach(), lse, dout.contiguous(), ctx.causal,
            ctx.window)
        return dq, dk, dv, None, None


class _FlashAttentionBackward(torch.autograd.Function):
    """K2's backward as a differentiable function of (q, k, v, dout).

    Forward: the ``bwd_dq`` and ``bwd_dkdv`` kernels (their plain versions
    on the CPU), as the first-order backward always ran them.

    Backward, the second order: the vjp of (dq, dk, dv) with respect to
    (q, k, v, dout), including the dependence of the f32 output and L on q,
    k and v, which JAX takes through ``_flash_fwd_rule``'s residuals when it
    differentiates ``_flash_bwd_rule``. It is computed by recomputing the
    forward and the first backward from (q, k, v, dout) through the plain
    versions in ``kernels.ref`` under autograd, then
    ``torch.autograd.grad`` (with ``create_graph`` when the caller's grad
    mode asks for it, so a third order composes). No kernel computes this
    term, on the card either: the reference computes it in XLA too, outside
    any Pallas kernel, and a hand-written second-order kernel is later work
    (ROADMAP queue 2). Each such call counts in
    ``plain_counts()["flash_attention_bwd2_plain"]``. The recompute holds
    the (B, Hq, Sq, Skv) f32 scores of the call.

    The recompute runs in f32 for every input dtype, as the reference's
    ``_flash_bwd_rule`` does: bf16 q, k, v and dout are cast to f32 once
    on entry, so each input's terms from every path (the scores, the
    output, the first backward) sum in f32 and are rounded to its dtype
    once. Given the same cotangents it agrees with the reference's double
    backward (and with autograd's through the plain forward) within 1e-4
    of the largest magnitude in f32, and for bf16 within two bf16 steps
    (2^-6 of each value) plus 1e-2 of the largest magnitude: the two sides
    round the same values to bf16, from f32 sums taken in another order. A
    cotangent built from the bf16 first order itself (the gradient of
    ``sum |dq|^2``, say) carries the card kernels' one-step rounding of
    that first order too, and can read beyond it."""

    @staticmethod
    def forward(q, k, v, out32, lse, dout, causal, window):
        dq, delta = flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                           causal=causal, window=window)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, delta, dout,
                                          causal=causal, window=window)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, _, _, dout, causal, window = inputs
        ctx.save_for_backward(q, k, v, dout)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        _PLAIN_CALLS["flash_attention_bwd2_plain"] += 1
        create = torch.is_grad_enabled()
        needs = [ctx.needs_input_grad[j] for j in (0, 1, 2, 5)]
        with torch.enable_grad():
            ins = _grad_inputs(ctx.saved_tensors)
            # One f32 cast of each input: every path's term sums in f32
            # and is rounded to the input's dtype once.
            q, k, v, dout = (x.to(torch.float32) for x in ins)
            _, out32, lse = _ref.flash_attention_ref(
                q, k, v, causal=ctx.causal, window=ctx.window)
            grads = _ref.flash_attention_bwd_ref(
                q, k, v, out32, lse, dout, causal=ctx.causal,
                window=ctx.window)
            gq, gk, gv, gdout = _vjp(grads, (gdq, gdk, gdv), ins, needs,
                                     create)
        return gq, gk, gv, None, None, gdout, None, None


# Calls of the terms no kernel computes (:func:`plain_counts`): the second
# orders of K2, K4 and K5 grow by one each time
# :class:`_FlashAttentionBackward`, :class:`_LruScanBackward` or
# :class:`_Wkv6Backward` differentiates a first backward (plain PyTorch on
# either device).
_PLAIN_CALLS = {"flash_attention_bwd2_plain": 0, "lru_scan_bwd2_plain": 0,
                "wkv6_bwd2_plain": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash attention with its backward: q (B, Sq, Hq, hd), k/v
    (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in q's dtype. On the card the K2
    kernels (forward, then ``bwd_dq`` and ``bwd_dkdv``); on the CPU their
    plain versions."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 int(window or 0))[0]


def lru_scan_fwd(a, b, h0=None):
    """K4 forward: ``h_t = a_t * h_{t-1} + b_t`` over axis 1 of (B, S, W),
    f32 state, -> h in a's dtype."""
    return _call("lru_scan_fwd", a, b, h0)


def lru_scan_bwd(a, h, g, h0=None):
    """K4 backward, the reverse scan: -> (da, db, dh0 f32 (B, W))."""
    return _call("lru_scan_bwd", a, h, g, h0)


class _LruScan(torch.autograd.Function):
    """The RG-LRU scan with the reverse scan as its backward
    (:class:`_LruScanBackward`). Saves a, b, h0 and the output h; works
    under non-reentrant ``torch.utils.checkpoint``, which runs the forward
    again in the backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = lru_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, b, h0, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, b, h0, h = ctx.saved_tensors
        da, db, dh0 = _LruScanBackward.apply(a, b, h0, h.detach(),
                                             g.contiguous())
        return da, db, None if h0 is None else dh0


class _LruScanBackward(torch.autograd.Function):
    """K4's backward as a differentiable function of (a, b, h0, g).

    Forward: the reverse-scan kernel (its plain version on the CPU), as the
    first-order backward always ran it, bitwise.

    Backward, the second order: the vjp of (da, db, dh0) with respect to
    (a, b, h0, g), including the dependence of h on a, b and h0, which the
    reference takes when XLA differentiates the transpose of its
    associative scan (``repro/models/rglru.py:lru_scan``) again. It is
    computed by recomputing the scan and the reverse scan from (a, b, h0,
    g) through the plain loops of ``kernels.ref`` in f32 under autograd,
    then ``torch.autograd.grad`` (with ``create_graph`` when the caller's
    grad mode asks for it, so a third order composes), on either device.
    No kernel computes this term; each call counts in
    ``plain_counts()["lru_scan_bwd2_plain"]``. The loops take S Python
    steps each: cheap at serve and test lengths, slow at S 4096."""

    @staticmethod
    def forward(ctx, a, b, h0, h, g):
        ctx.save_for_backward(a, b, h0, g)
        return lru_scan_bwd(a, h, g, h0)

    @staticmethod
    def backward(ctx, gda, gdb, gdh0):
        _PLAIN_CALLS["lru_scan_bwd2_plain"] += 1
        create = torch.is_grad_enabled()
        saved = ctx.saved_tensors
        needs = [ctx.needs_input_grad[j] for j in (0, 1, 2, 4)]
        with torch.enable_grad():
            ins = _grad_inputs(saved)
            a, b, h0, g = (None if x is None else x.to(torch.float32)
                           for x in ins)
            h = _ref.lru_scan_ref(a, b, h0)
            outs = _ref.lru_scan_bwd_ref(a, h, g, h0)
            got = _vjp(outs, (gda, gdb, gdh0), ins, needs, create)
        ga, gb, gh0, gg = got
        return ga, gb, gh0, None, gg


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` with its backward: a, b (B, S, W), h0
    (B, W) f32 or None -> h (B, S, W) in a's dtype. On the card the K4
    kernels, on the CPU their plain versions."""
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    return _LruScan.apply(a.contiguous(), b.contiguous(), h0)


def wkv6_fwd(r, k, v, logw, u, s0=None):
    """K5 forward: the WKV6 recurrence over axis 1 of (B, S, H, N) f32 from
    ``s0`` (B, H, N, N), or zeros -> (out f32, states, final (B, H, N, N)
    f32): states, on the card, the state entering each 64-step chunk
    (B, H, ceil(S / 64), N, N), which the backward kernel reads; on the
    CPU None (the plain backward runs the recurrence again)."""
    out, states, final = _call("wkv6_fwd", r, k, v, logw, u, s0)
    return out, None if states.numel() == 0 else states, final


def wkv6_bwd(r, k, v, logw, u, states, dout, s0=None, final=None,
             dfinal=None):
    """K5 backward, the chunked reverse pass: -> (dr, dk, dv, dlogw, du,
    ds0), f32; du (H, N) summed over batch and chunks in a fixed order; ds0
    (B, H, N, N) with ``s0``, else None. ``dfinal``, the final state's
    gradient, starts the reverse pass (zeros when None); on the card it
    needs the forward's ``final``."""
    grads = _call("wkv6_bwd", r, k, v, logw, u, states, dout, s0, final,
                  dfinal)
    return tuple(grads[:5]) + (None if s0 is None else grads[5],)


class _Wkv6(torch.autograd.Function):
    """WKV6 with the chunked reverse pass as its backward
    (:class:`_Wkv6Backward`). Saves the inputs, the chunk states (none on
    the CPU) and the final state; works under non-reentrant
    ``torch.utils.checkpoint``, which runs the forward again in the
    backward. Gradients are not materialised: a final state that no loss
    reads gives the reverse pass no ``dfinal`` and leaves it as it was
    before the final state existed, bitwise."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        out, states, final = wkv6_fwd(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0, states, final)
        ctx.set_materialize_grads(False)
        return out, final

    @staticmethod
    def backward(ctx, dout, dfinal):
        r, k, v, logw, u, s0, states, final = ctx.saved_tensors
        dout = torch.zeros_like(r) if dout is None else dout.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        return _Wkv6Backward.apply(r, k, v, logw, u, s0, states,
                                   final.detach(), dout, dfinal)


class _Wkv6Backward(torch.autograd.Function):
    """K5's backward as a differentiable function of (r, k, v, logw, u,
    s0, dout, dfinal).

    Forward: the chunked reverse-pass kernels (their plain version on the
    CPU), as the first-order backward always ran them, bitwise.

    Backward, the second order: the vjp of (dr, dk, dv, dlogw, du, ds0)
    with respect to those inputs, including the dependence of the states on
    r, k, v, logw and s0, which the reference takes when XLA differentiates
    its scan's transpose again (``repro/models/rwkv.py:sequential_wkv``).
    It is computed by recomputing the reverse pass from those inputs
    through the plain loops of ``kernels.ref`` (``wkv6_bwd_ref``, which
    runs the forward recurrence again) in f32 under autograd, then
    ``torch.autograd.grad``, on either device. No kernel computes this
    term; each call counts in ``plain_counts()["wkv6_bwd2_plain"]``. The
    loops hold every step's (B, H, N, N) state: cheap at serve and test
    lengths, large at S 4096."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, states, final, dout, dfinal):
        ctx.save_for_backward(r, k, v, logw, u, s0, dout, dfinal)
        return wkv6_bwd(r, k, v, logw, u, states, dout, s0, final, dfinal)

    @staticmethod
    def backward(ctx, gdr, gdk, gdv, gdlogw, gdu, gds0):
        _PLAIN_CALLS["wkv6_bwd2_plain"] += 1
        create = torch.is_grad_enabled()
        saved = ctx.saved_tensors
        needs = [ctx.needs_input_grad[j] for j in (0, 1, 2, 3, 4, 5, 8, 9)]
        with torch.enable_grad():
            ins = _grad_inputs(saved)
            r, k, v, logw, u, s0, dout, dfinal = ins
            outs = _ref.wkv6_bwd_ref(r, k, v, logw, u, dout, s0, dfinal)
            got = _vjp(outs, (gdr, gdk, gdv, gdlogw, gdu, gds0), ins, needs,
                       create)
        gr, gk, gv, glogw, gu, gs0, gdout, gdfinal = got
        return gr, gk, gv, glogw, gu, gs0, None, None, gdout, gdfinal


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0=None):
    """The RWKV-6 WKV recurrence with its backward: r, k, v, logw
    (B, S, H, N), u (H, N), all f32, and an initial state s0 (B, H, N, N)
    f32 (zeros when None) -> (out (B, S, H, N) f32, final (B, H, N, N) f32,
    the state after the last step), as ``repro/models/rwkv.py:119
    sequential_wkv(..., state=)``. On the card the K5 kernels, on the CPU
    their plain versions; both outputs and s0 take gradients."""
    if s0 is not None:
        s0 = s0.to(torch.float32).contiguous()
    return _Wkv6.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                       logw.contiguous(), u.contiguous(), s0)


KERNEL_WRAPPERS = (quantize, dequantize, reduce_compress_roundtrip,
                   reduce_compress, dequant_accumulate, flash_attention_fwd,
                   flash_attention_bwd_dq, flash_attention_bwd_dkdv,
                   lru_scan_fwd, lru_scan_bwd, wkv6_fwd, wkv6_bwd)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launches() -> None:
    """Every wrapper's count to 0, K2's launches by entry point
    (``flash_attention.ROUTE_LAUNCHES``), K4's by route
    (``rglru_scan.ROUTE_LAUNCHES``) and the plain calls of
    :func:`plain_counts`."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for name in _PLAIN_CALLS:
        _PLAIN_CALLS[name] = 0
    _fa.reset_route_launches()
    _lru.reset_route_launches()


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


class uncounted:
    """``with uncounted() as made:`` wrapper calls inside the block leave
    the counters (and K2's and K4's by route) as they were: a CUDA graph
    capture records its launches, it does not make them. On exit ``made``
    holds the calls made inside by wrapper name (those a replay of the
    capture launches)."""

    def __enter__(self) -> Dict[str, int]:
        self.before = launch_counts()
        self.routes = dict(_lru.ROUTE_LAUNCHES)
        self.flash_routes = dict(_fa.ROUTE_LAUNCHES)
        self.made: Dict[str, int] = {}
        return self.made

    def __exit__(self, *exc) -> None:
        after = launch_counts()
        self.made.update({k: after[k] - self.before[k] for k in after
                          if after[k] != self.before[k]})
        for fn in KERNEL_WRAPPERS:
            fn.launches = self.before[fn.__name__]
        _lru.ROUTE_LAUNCHES.update(self.routes)
        _fa.ROUTE_LAUNCHES.clear()
        _fa.ROUTE_LAUNCHES.update(self.flash_routes)


def plain_counts() -> Dict[str, int]:
    """Calls of the terms no kernel computes, on either device: the second
    orders of K2, K4 and K5 (:class:`_FlashAttentionBackward`,
    :class:`_LruScanBackward`, :class:`_Wkv6Backward`)."""
    return dict(_PLAIN_CALLS)
