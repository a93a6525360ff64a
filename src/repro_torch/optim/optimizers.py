"""Minimal optax-style optimizers over trees of tensors
(``repro/optim/optimizers.py``).

``update(grads, state, params) -> (updates, state)`` where ``updates`` are
deltas to add to params (already negated). Moments and updates are f32;
:func:`apply_updates` adds in f32 and casts back to the param dtype
(bf16 params, f32 arithmetic). Every function returns new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

F32 = torch.float32


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


def sgd(lr: float) -> Optimizer:
    """Plain SGD (the reference's momentum and Nesterov options have no
    caller in this slice)."""

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        upd = pytree.tree_map(lambda g: -lr * g.to(F32), grads)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8) -> Optimizer:
    """Adam with f32 moments (params may be bf16). The reference's decoupled
    weight decay has no caller in this slice."""

    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(F32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)
        m = pytree.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32),
                            state["m"], grads)
        v = pytree.tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(F32)),
            state["v"], grads)

        upd = pytree.tree_map(
            lambda m_, v_: -lr * ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)), m, v)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return pytree.tree_map(lambda p, u: (p.to(F32) + u).to(p.dtype),
                           params, updates)
