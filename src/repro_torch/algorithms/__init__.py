"""MapReduce training algorithms of the port: local-SGD, FedSGD and
asynchronous rounds."""

from .async_rounds import (
    make_async_local_sgd_round,
    make_hierarchical_async_round,
)
from .rounds import (
    LocalSGDConfig,
    make_fedsgd_round,
    make_hierarchical_local_sgd_round,
    make_local_sgd_round,
    make_multi_round,
)

__all__ = ["LocalSGDConfig", "make_async_local_sgd_round",
           "make_fedsgd_round", "make_hierarchical_async_round",
           "make_hierarchical_local_sgd_round", "make_local_sgd_round",
           "make_multi_round"]
