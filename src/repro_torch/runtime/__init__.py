"""Distributed runtime (``repro/runtime``): failure injection and
checkpoint-restart recovery, straggler simulation and masks, the compiled
plan executor (``runtime.executor``, on one device or on a mesh), the
elastic hierarchical round (``runtime.elastic``) with its mesh helpers and
its physical path on a mesh of the surviving pods' ranks, and the chaos
soak in its logical and physical modes (``runtime.chaos``)."""

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
