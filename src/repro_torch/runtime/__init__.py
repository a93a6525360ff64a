"""Distributed runtime (``repro/runtime``). Ported: failure injection and
checkpoint-restart recovery, straggler simulation and masks. Left out for
later slices: the compiled plan executor, elasticity and the chaos soak."""

from .failure import (
    DEFAULT_RECOVERABLE,
    FailureInjector,
    SimulatedDeviceFailure,
    run_with_recovery,
)
from .stragglers import StragglerSimulator, effective_round_time, straggler_mask

__all__ = ["DEFAULT_RECOVERABLE", "FailureInjector", "SimulatedDeviceFailure",
           "StragglerSimulator", "effective_round_time", "run_with_recovery",
           "straggler_mask"]
