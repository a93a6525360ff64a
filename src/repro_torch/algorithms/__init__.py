"""MapReduce training algorithms of the port: local-SGD, FedSGD and
asynchronous rounds, parallel MAML, Branch-Train-Merge and pipelined
rounds."""

from .async_rounds import (
    make_async_local_sgd_round,
    make_hierarchical_async_round,
)
from .btm import branch_train_merge
from .maml import make_parallel_maml
from .pipeline import (
    PipelineConfig,
    make_pipelined_round,
    pipeline_bubble_fraction,
)
from .rounds import (
    LocalSGDConfig,
    make_fedsgd_round,
    make_hierarchical_local_sgd_round,
    make_local_sgd_round,
    make_multi_round,
)

__all__ = [
    "LocalSGDConfig",
    "make_local_sgd_round",
    "make_hierarchical_local_sgd_round",
    "make_fedsgd_round",
    "make_multi_round",
    "make_async_local_sgd_round",
    "make_hierarchical_async_round",
    "make_parallel_maml",
    "branch_train_merge",
    "PipelineConfig",
    "make_pipelined_round",
    "pipeline_bubble_fraction",
]
