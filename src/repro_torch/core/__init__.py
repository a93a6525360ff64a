"""DrJAX core for PyTorch: placements (replica and stage kinds),
primitives, the user API (stage transfers and stage maps included), the
hierarchical reduction and the MapReduce plan IR (``trace``,
``build_plan``, ``run_plan``). ``from repro_torch import core as drjax``."""

from .api import (
    broadcast,
    current_context,
    map_fn,
    masked_reduce_mean,
    partition_size,
    placement_context,
    program,
    reduce_max,
    reduce_mean,
    reduce_sum,
    reduce_weighted_mean,
    stage_map,
    stage_transfer,
)
from .hierarchical import (
    cross_pod_bytes,
    hierarchical_reduce_mean,
    int8_wire_ratio,
)
from .interpreter import (
    MapReducePlan,
    build_plan,
    count_primitives,
    run_plan,
    trace,
)
from .placement import Placement, PlacementContext, make_context

__all__ = [
    "MapReducePlan",
    "Placement",
    "PlacementContext",
    "broadcast",
    "build_plan",
    "count_primitives",
    "cross_pod_bytes",
    "current_context",
    "hierarchical_reduce_mean",
    "int8_wire_ratio",
    "make_context",
    "map_fn",
    "masked_reduce_mean",
    "partition_size",
    "placement_context",
    "program",
    "reduce_max",
    "reduce_mean",
    "reduce_sum",
    "reduce_weighted_mean",
    "run_plan",
    "stage_map",
    "stage_transfer",
    "trace",
]
