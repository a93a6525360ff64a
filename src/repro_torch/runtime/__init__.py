"""Distributed runtime (``repro/runtime``). Ported: failure injection and
checkpoint-restart recovery, straggler simulation and masks, the compiled
plan executor (``runtime.executor``) and the elastic hierarchical round
(``runtime.elastic``). Left out for later slices: elasticity across cards
(meshes) and the chaos soak."""

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
