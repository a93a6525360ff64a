"""Minimal optax-style optimizers over trees of tensors
(``repro/optim/optimizers.py``).

``update(grads, state, params) -> (updates, state)`` where ``updates`` are
deltas to add to params (already negated). Moments and updates are f32;
:func:`apply_updates` adds in f32 and casts back to the param dtype
(bf16 params, f32 arithmetic). Every function returns new tensors. A
learning rate may be a schedule (``schedules.py``) of the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32

# A learning rate: a constant, or a function of the int32 step tensor.
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def _step0(params) -> torch.Tensor:
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros_f32(params):
    return pytree.tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def global_norm(tree) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32))) for l in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    # The product is taken in f32 (as the reference's dtype promotion does)
    # and cast back to the leaf dtype.
    return pytree.tree_map(lambda l: (l.to(F32) * scale).to(l.dtype), tree), norm


def _lr_at(lr: Schedule, step: torch.Tensor):
    """The learning rate at ``step`` (the int32 count after this update): a
    schedule's f32 value, or the constant itself (a Python float scales a
    f32 tensor in f32, as the reference's f32 scalar does)."""
    return lr(step) if callable(lr) else lr


def sgd(lr: Schedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD, with f32 heavy-ball momentum (``nesterov``: the lookahead
    ``momentum * mu + g``) when ``momentum`` is set."""

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = _zeros_f32(params)
        return state

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = pytree.tree_map(lambda m, g: momentum * m + g.to(F32),
                                 state["mu"], grads)
            upd = (pytree.tree_map(lambda m, g: momentum * m + g.to(F32),
                                   mu, grads) if nesterov else mu)
            new_state = {"step": step, "mu": mu}
        else:
            upd = pytree.tree_map(lambda g: g.to(F32), grads)
            new_state = {"step": step}
        return pytree.tree_map(lambda u: -lr_t * u, upd), new_state

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments (params may be bf16) and decoupled weight
    decay (``weight_decay * p`` added to the Adam direction)."""

    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        t = step.to(F32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)
        m = pytree.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32),
                            state["m"], grads)
        v = pytree.tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(F32)),
            state["v"], grads)

        def upd(m_, v_, p):
            u = (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return -lr_t * u

        return (pytree.tree_map(upd, m, v, params),
                {"step": step, "m": m, "v": v})

    return Optimizer(init, update)


def apply_updates(params, updates):
    return pytree.tree_map(lambda p, u: (p.to(F32) + u).to(p.dtype),
                           params, updates)
