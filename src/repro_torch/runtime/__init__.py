"""Distributed runtime (``repro/runtime``). Ported: failure injection and
checkpoint-restart recovery, straggler simulation and masks, the compiled
plan executor (``runtime.executor``) and the elastic hierarchical round
(``runtime.elastic``) with its mesh-free helpers, and the chaos soak in
its logical mode (``runtime.chaos``). Left out for the distributed layer:
elasticity across cards (meshes) and the soak's physical mode."""

from .elastic import ElasticSchedule, rescale_partition
from .failure import (
    DEFAULT_RECOVERABLE,
    FailureInjector,
    SimulatedDeviceFailure,
    run_with_recovery,
)
from .stragglers import StragglerSimulator, effective_round_time, straggler_mask

__all__ = ["DEFAULT_RECOVERABLE", "ElasticSchedule", "FailureInjector",
           "SimulatedDeviceFailure", "StragglerSimulator",
           "effective_round_time", "rescale_partition", "run_with_recovery",
           "straggler_mask"]
