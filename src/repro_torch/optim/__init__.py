"""Optimizers over trees of tensors (client and server side) and
learning-rate schedules."""

from .optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from .schedules import constant, cosine_decay, linear_warmup
from .server import diloco_optimizer, fedadam, fedavg_momentum

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "constant", "cosine_decay", "diloco_optimizer", "fedadam",
           "fedavg_momentum", "global_norm", "linear_warmup", "sgd"]
