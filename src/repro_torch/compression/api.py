"""Delta compression for the cross-pod reduction (``repro/compression/api.py``).

Trees are compressed through **flat packing**: all leaves of one dtype are
concatenated into a single contiguous ``(..., R, 256)`` buffer, each leaf's
span zero-padded up to the 256 boundary so no scale block crosses a leaf,
and the whole tree pays one kernel launch per dtype. A 256-wide row is the
scale granularity of the wire format (one f32 scale per 256 int8 values).

``int8_roundtrip`` is straight-through under autograd: the backward passes
the cotangent unchanged, so the gradient of a compressed program equals the
uncompressed one's, which lets ``core/hierarchical.py`` swap in the fused
reduce+compress kernel without changing derivatives.

``topk_sparsify`` keeps exactly ``k`` entries of each leaf, ties broken
by lowest index as ``lax.top_k`` breaks them, with the same bits on either
device; ``topk_sparsify_layers`` applies it to a parameter dict over the
reference's leaves (a uniform stack's layers as one leaf).
``ErrorFeedback`` keeps the residual (x - C(x)) and adds it to the next
value it compresses (Seide et al. 2014).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..kernels import ops as kernel_ops

# Lane width of the packed wire format: one f32 scale per PACK_COLS values.
PACK_COLS = 256


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Layout record produced by :func:`flat_pack`.

    ``segments`` maps a dtype name to the ordered ``(leaf_index, size,
    stride)`` spans of its buffer's flattened last axis; ``stride`` is
    ``size`` rounded up to the ``cols`` boundary. ``trail_shapes`` are the
    per-leaf shapes below the packed lead axes, which :func:`flat_unpack`
    restores (the lead axes may be gone by then, e.g. after a reduction).
    """

    treedef: Any
    trail_shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    segments: Dict[str, Tuple[Tuple[int, int, int], ...]]
    cols: Optional[int]


def flat_pack(tree, lead_ndim: int = 0, cols: Optional[int] = PACK_COLS):
    """Pack a tree into one contiguous buffer per dtype.

    Every leaf must carry the same ``lead_ndim`` leading (group) axes; the
    trailing axes are flattened and concatenated. With ``cols`` set, each
    leaf's span is zero-padded to a ``cols`` boundary and the buffer is
    shaped ``(*lead, R, cols)``, the row layout the kernels take. Returns
    ``(buffers, spec)`` with ``buffers`` keyed by dtype name.
    """
    leaves, treedef = pytree.tree_flatten(tree)
    if not leaves:
        return {}, PackSpec(treedef, (), (), {}, cols)
    leaves = [torch.as_tensor(l) for l in leaves]
    lead = tuple(leaves[0].shape[:lead_ndim])
    groups: Dict[str, list] = {}
    trail_shapes = []
    dtypes = []
    for i, leaf in enumerate(leaves):
        if tuple(leaf.shape[:lead_ndim]) != lead:
            raise ValueError(
                f"flat_pack: leaf {i} has lead axes "
                f"{tuple(leaf.shape[:lead_ndim])}, expected {lead} (every "
                f"leaf must carry the same {lead_ndim} leading group axes)."
            )
        trail_shapes.append(tuple(leaf.shape[lead_ndim:]))
        dtypes.append(leaf.dtype)
        groups.setdefault(_dtype_name(leaf.dtype), []).append(i)
    buffers = {}
    segments = {}
    for key, idxs in groups.items():
        parts = []
        segs = []
        for i in idxs:
            part = leaves[i].reshape(lead + (-1,))
            size = part.shape[-1]
            stride = size
            if cols:
                pad = (-size) % cols
                if pad:
                    part = torch.nn.functional.pad(part, (0, pad))
                stride = size + pad
            parts.append(part)
            segs.append((i, size, stride))
        buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        segments[key] = tuple(segs)
        if cols:
            buf = buf.reshape(lead + (-1, cols))
        buffers[key] = buf
    spec = PackSpec(treedef, tuple(trail_shapes), tuple(dtypes), segments, cols)
    return buffers, spec


def flat_unpack(buffers, spec: PackSpec, lead_ndim: int = 0):
    """Inverse of :func:`flat_pack`. ``lead_ndim`` counts the lead axes the
    buffers carry now (0 after a stack-spanning reduction). Leaves are
    views of the buffers where the dtype is unchanged."""
    leaves: list = [None] * len(spec.trail_shapes)
    for key, segs in spec.segments.items():
        buf = buffers[key]
        lead = tuple(buf.shape[:lead_ndim])
        flat = buf.reshape(lead + (-1,))
        offset = 0
        for i, size, stride in segs:
            piece = flat.narrow(-1, offset, size)
            leaves[i] = piece.reshape(lead + spec.trail_shapes[i]).to(
                spec.dtypes[i]
            )
            offset += stride
    return pytree.tree_unflatten(leaves, spec.treedef)


def _roundtrip_leaves(tree):
    """Quantize-dequantize every floating leaf through the packed format:
    one ``(R, 256)`` buffer and one quantize + one dequantize launch per
    float dtype; non-float leaves pass through untouched."""
    leaves, treedef = pytree.tree_flatten(tree)
    float_idx = [
        i for i, leaf in enumerate(leaves)
        if torch.is_tensor(leaf) and leaf.is_floating_point()
    ]
    if not float_idx:
        return tree
    bufs, spec = flat_pack([leaves[i] for i in float_idx], lead_ndim=0,
                           cols=PACK_COLS)
    out_bufs = {}
    for key, buf in bufs.items():
        q, s = kernel_ops.quantize(buf)
        out_bufs[key] = kernel_ops.dequantize(q, s, dtype=buf.dtype)
    back = flat_unpack(out_bufs, spec, lead_ndim=0)
    leaves = list(leaves)
    for i, leaf in zip(float_idx, back):
        leaves[i] = leaf
    return pytree.tree_unflatten(leaves, treedef)


class _StraightThrough(torch.autograd.Function):
    """The int8 roundtrip of floating leaves; identity backward."""

    @staticmethod
    def forward(ctx, *leaves):
        return tuple(_roundtrip_leaves(list(leaves)))

    @staticmethod
    def backward(ctx, *cts):
        return cts


def int8_roundtrip(tree):
    """Quantize-dequantize every floating leaf (the value a backend would
    transmit). Straight-through under autograd: the cotangent passes
    unchanged, matching the fused reduce+compress kernel's backward."""
    leaves, treedef = pytree.tree_flatten(tree)
    float_idx = [
        i for i, leaf in enumerate(leaves)
        if torch.is_tensor(leaf) and leaf.is_floating_point()
    ]
    if not any(leaves[i].requires_grad for i in float_idx):
        return _roundtrip_leaves(tree)
    out = _StraightThrough.apply(*(leaves[i] for i in float_idx))
    leaves = list(leaves)
    for i, leaf in zip(float_idx, out):
        leaves[i] = leaf
    return pytree.tree_unflatten(leaves, treedef)


# Recognition tag for core/hierarchical.py: a compress_fn carrying
# ``drjax_fused_compress = "int8"`` may be replaced by the fused single-pass
# reduce+compress kernel (same straight-through backward, same wire format).
int8_roundtrip.drjax_fused_compress = "int8"


def _topk_leaf(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Exactly ``k = max(int(n * fraction), 1)`` entries of ``x`` by
    magnitude, in f32, the rest zero, cast back to ``x``'s dtype.

    ``torch.topk`` promises no order among ties, but its values are well
    defined: the k-th of them is the cutoff. Every entry above it is kept,
    and of the entries equal to it the first ``k - #above`` by flat index
    (a cumulative count over the equality mask), which is the set
    ``lax.top_k`` selects (ties to the lower index), on either device.
    """
    flat = x.reshape(-1).to(torch.float32)
    k = max(int(flat.numel() * fraction), 1)
    mag = flat.abs()
    cutoff = torch.topk(mag, k, sorted=False).values.min()
    above = mag > cutoff
    at = mag == cutoff
    keep = above | (at & (torch.cumsum(at, 0) <= k - above.sum()))
    sparse = torch.where(keep, flat, torch.zeros_like(flat))
    return sparse.reshape(x.shape).to(x.dtype)


def topk_sparsify(tree, fraction: float = 0.01):
    """Keep the top ``fraction`` of the entries of each leaf by magnitude
    (magnitude pruning)."""
    return pytree.tree_map(lambda x: _topk_leaf(x, fraction), tree)


def _uniform_layers(tree) -> Optional[Dict[str, list]]:
    """For a flat dict of ``layers.{i}.{name}`` leaves whose layers all
    hold the same names, shapes and dtypes: name -> its keys in layer
    order. None otherwise."""
    if not isinstance(tree, dict):
        return None
    layers: Dict[int, Dict[str, Any]] = {}
    for key, x in tree.items():
        m = re.fullmatch(r"layers\.(\d+)\.(.+)", key)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = (
                tuple(x.shape), x.dtype)
    if not layers or sorted(layers) != list(range(len(layers))):
        return None
    if any(layers[i] != layers[0] for i in layers):
        return None
    return {name: [f"layers.{i}.{name}" for i in range(len(layers))]
            for name in layers[0]}


def topk_sparsify_layers(tree, fraction: float = 0.01, layer_axis: int = 0):
    """:func:`topk_sparsify` of a flat parameter dict over the reference's
    leaves. The reference keeps a uniform stack's layers as one leaf with a
    layers axis (``scan_layers``), so its fraction counts over all layers
    of a parameter together. Here, when every layer holds the same names,
    shapes and dtypes, each name's layers are stacked at ``layer_axis`` (0
    for a parameter or delta, 1 for a pod partial that leads with the pods
    axis), sparsified as one leaf and split again; a mixed stack (kept by
    the reference as a list of per-layer trees) and every other leaf go
    one leaf at a time."""
    groups = _uniform_layers(tree)
    if groups is None:
        return topk_sparsify(tree, fraction)
    grouped = {k for keys in groups.values() for k in keys}
    out = {k: _topk_leaf(x, fraction) for k, x in tree.items()
           if k not in grouped}
    for keys in groups.values():
        sparse = _topk_leaf(
            torch.stack([tree[k] for k in keys], dim=layer_axis), fraction)
        out.update(zip(keys, sparse.unbind(layer_axis)))
    return {k: out[k] for k in tree}


class ErrorFeedback:
    """Residual accumulator for biased compressors."""

    @staticmethod
    def init(tree):
        return pytree.tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), tree)

    @staticmethod
    def compress(tree, residual, compressor, *args):
        """(compressor(x + residual), the new residual) with x in f32."""
        corrected = pytree.tree_map(lambda x, r: x.to(torch.float32) + r,
                                    tree, residual)
        compressed = compressor(corrected, *args)
        new_residual = pytree.tree_map(
            lambda c, comp: c - comp.to(torch.float32), corrected, compressed)
        return compressed, new_residual
