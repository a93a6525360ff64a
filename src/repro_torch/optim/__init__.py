"""Optimizers over trees of tensors (client and server side)."""

from .optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from .server import diloco_optimizer, fedavg_momentum

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "diloco_optimizer", "fedavg_momentum", "global_norm", "sgd"]
