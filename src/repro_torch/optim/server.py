"""Server-side (outer-loop) optimizers (``repro/optim/server.py``).

They consume the mean client delta of a DrJAX reduction and update the
global model: FedAvg (+ server momentum), FedAdam (Reddi et al.) and the
DiLoCo outer optimizer (Nesterov momentum SGD).
"""

from __future__ import annotations

import torch
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


def fedadam(lr: float = 1e-2, b1: float = 0.9, b2: float = 0.99,
            eps: float = 1e-3) -> Optimizer:
    """FedAdam (Reddi et al. 2021): Adam on the mean client delta."""

    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(mean_delta, state, params=None):
        step = state["step"] + 1
        m = pytree.tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d.to(F32),
                            state["m"], mean_delta)
        v = pytree.tree_map(
            lambda v_, d: b2 * v_ + (1 - b2) * torch.square(d.to(F32)),
            state["v"], mean_delta)
        upd = pytree.tree_map(lambda m_, v_: lr * m_ / (torch.sqrt(v_) + eps),
                              m, v)
        return upd, {"step": step, "m": m, "v": v}

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
