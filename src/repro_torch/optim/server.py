"""Server-side (outer-loop) optimizers (``repro/optim/server.py``).

They consume the mean client delta of a DrJAX reduction and update the
global model: FedAvg (+ server momentum) and the DiLoCo outer optimizer
(Nesterov momentum SGD). FedAdam waits for a later slice.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

from .optimizers import F32, Optimizer, _step0, _zeros_f32


def fedavg_momentum(lr: float = 1.0, momentum: float = 0.0) -> Optimizer:
    """Classic FedAvg: apply the mean client delta (optionally with momentum)."""

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = _zeros_f32(params)
        return state

    def update(mean_delta, state, params=None):
        step = state["step"] + 1
        if momentum:
            mu = pytree.tree_map(lambda m, d: momentum * m + d.to(F32),
                                 state["mu"], mean_delta)
            return pytree.tree_map(lambda m: lr * m, mu), {"step": step, "mu": mu}
        upd = pytree.tree_map(lambda d: lr * d.to(F32), mean_delta)
        return upd, {"step": step}

    return Optimizer(init, update)


def diloco_optimizer(lr: float = 0.7, momentum: float = 0.9) -> Optimizer:
    """DiLoCo outer optimizer: Nesterov momentum over the mean delta."""

    def init(params):
        return {"step": _step0(params), "mu": _zeros_f32(params)}

    def update(mean_delta, state, params=None):
        step = state["step"] + 1
        mu = pytree.tree_map(lambda m, d: momentum * m + d.to(F32),
                             state["mu"], mean_delta)
        upd = pytree.tree_map(
            lambda m, d: lr * (momentum * m + d.to(F32)), mu, mean_delta)
        return upd, {"step": step, "mu": mu}

    return Optimizer(init, update)
