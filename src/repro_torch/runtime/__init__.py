"""Distributed runtime (``repro/runtime``). Ported: straggler simulation and
masks. Left out for later slices: the compiled plan executor, failure
recovery, elasticity and the chaos soak."""

from .stragglers import StragglerSimulator, effective_round_time, straggler_mask

__all__ = ["StragglerSimulator", "effective_round_time", "straggler_mask"]
