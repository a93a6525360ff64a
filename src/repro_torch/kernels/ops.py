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

from . import quantize as _quant
from . import reduce_compress as _rc
from . import ref as _ref


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


KERNEL_WRAPPERS = (quantize, dequantize, reduce_compress_roundtrip)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
