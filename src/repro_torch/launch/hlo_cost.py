"""A traced step's cost: FLOPs, collectives and the roofline terms, on the
H100's constants (``repro/launch/hlo_cost.py``; the name is kept so
readers find the counterpart).

The reference reads its counts from a compiled program's HLO. The port has
no HLO, so it counts what one call of a step dispatches:

* FLOPs: :func:`count_flops`, ``torch.utils.flop_counter.FlopCounterMode``
  around one call, with the kernel ops' own formulas
  (``kernels/ops.py``, registered there), so a K2, K4 or K5 node counts
  the work its inputs need;
* collectives: :class:`CollectiveCounter`, a ``TorchDispatchMode`` that
  sees every ``torch.ops.c10d.*`` op (``dist.all_reduce``, ``all_gather``,
  ``broadcast``) and every functional collective (DTensor's
  redistributions) a step dispatches, and returns the reference's schema
  (:func:`parse_collectives`'s counterpart): per kind, ``{"count",
  "operand_bytes"}`` of the per-rank program, with the reference's
  operand convention (``repro/launch/hlo_cost.py:64-70``): an all-gather's
  operand is the rank's block (the output over the group size), a
  reduce-scatter's the whole input (the output times the group size), an
  all-reduce's, all-to-all's and permute's the tensor itself. HLO has no
  broadcast collective; the port's ``dist.broadcast`` is counted under the
  kind ``"broadcast"`` (operand: the tensor), after the reference's five.

Every constant is the card's: :data:`H100` (dense bf16 tensor-core rate,
HBM3 bandwidth and one direction of NVLink 4, from NVIDIA's H100 SXM data
sheet). A caller that needs another chip passes its own :class:`Chip`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's peaks: FLOP/s, HBM bytes/s and link bytes/s."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# NVIDIA H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at
# 900 GB/s both ways (450 GB/s in one direction).
H100 = Chip("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 450e9)
PEAK_FLOPS = H100.peak_flops  # bf16 FLOP/s per card
HBM_BW = H100.hbm_bw  # bytes/s per card
LINK_BW = H100.link_bw  # bytes/s per link, one direction
F32_FLOPS = 67e12  # f32 FLOP/s outside the tensor cores (the SIMT bound)

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "broadcast",
)


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float,
                   chip: Chip = H100) -> Dict[str, float]:
    return {
        "compute_s": flops / chip.peak_flops,
        "memory_s": bytes_accessed / chip.hbm_bw,
        "collective_s": collective_bytes / chip.link_bw,
    }


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


# c10d op name -> (kind, index of the operand argument): the operand is
# the tensor (or list of tensors) the rank contributes, so its bytes follow
# the reference's convention directly.
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
}
# functional collectives (DTensor's redistributions): the input is
# argument 0 in each
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _collective_of(func) -> Tuple[str, int]:
    """(kind, operand argument index) of a dispatched op, or (None, 0)."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns == "c10d" and name in _C10D:
        return _C10D[name]
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], 0
    return None, 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched while it is active: per kind, the
    calls and the operand bytes of this rank (the module docstring's
    convention). ``stats()`` gives the kinds that ran, as the reference's
    ``parse_collectives`` does."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.bytes = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind, at = _collective_of(func)
        if kind is not None:
            self.counts[kind] += 1
            self.bytes[kind] += _nbytes(args[at])
        return func(*args, **(kwargs or {}))

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {k: {"count": self.counts[k],
                    "operand_bytes": float(self.bytes[k])}
                for k in COLLECTIVES if self.counts[k]}


def collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(v["operand_bytes"] for v in stats.values())


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """A batched product's FLOPs, also for ``aten.bmm.dtype`` (the card's
    bf16-in, f32-out ``common._mm_f32``), whose ``out_dtype`` argument
    torch's own ``bmm`` formula takes for its output shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def count_flops(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), total FLOPs, {op name: FLOPs})`` of one call
    under ``FlopCounterMode``: aten's products and attention by torch's
    formulas, the kernel ops by theirs (``kernels/ops.py``). Ops without a
    formula count 0."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import ops  # noqa: F401  (registers the kernels' formulas)

    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    with counter:
        out = fn(*args, **kwargs)
    # the counts are per module; "Global" holds every op once
    glob = counter.get_flop_counts().get("Global", {})
    by_op = {str(op): int(n) for op, n in glob.items()}
    return out, int(counter.get_total_flops()), by_op
