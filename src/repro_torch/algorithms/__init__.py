"""MapReduce training algorithms of the port (local-SGD rounds)."""

from .rounds import (
    LocalSGDConfig,
    make_hierarchical_local_sgd_round,
    make_local_sgd_round,
)

__all__ = ["LocalSGDConfig", "make_hierarchical_local_sgd_round",
           "make_local_sgd_round"]
