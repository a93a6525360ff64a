"""Branch-Train-Merge (Li et al. 2022) as a DrJAX program
(``repro/algorithms/btm.py``).

BTM trains one expert per data domain in parallel (*branch*, *train*) and
merges them by parameter averaging (*merge*): a broadcast -> map -> reduce
round whose "local step count" is a whole training run.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import core as drjax
from ..optim.optimizers import Optimizer, apply_updates
from .rounds import _value_and_grad


def branch_train_merge(loss_fn: Callable, opt: Optimizer, partition_size: int,
                       train_steps: int, *, merge: str = "mean"):
    """Returns ``btm_fn(seed_params, domain_data) -> (merged_params,
    metrics)``.

    ``domain_data`` leaves are ``(n_domains, train_steps, ...batch)``. Each
    expert takes ``train_steps`` steps of ``opt`` on its domain; the merge
    averages the experts (``"mean"``), or weights them by
    ``softmax(-final_losses) * n`` through ``reduce_weighted_mean``
    (``"weighted"``, differentiable in the losses). The metrics are the
    mean and the max over the domains of each expert's last loss.
    ``btm_fn.train_expert(params, domain_batches) -> (params, last loss)``
    is one expert's training.
    """
    if merge not in ("mean", "weighted"):
        raise ValueError(f"merge={merge!r}: expected 'mean' or 'weighted'")

    def train_expert(params, domain_batches):
        opt_state = opt.init(params)
        loss = None
        for t in range(pytree.tree_leaves(domain_batches)[0].shape[0]):
            batch = pytree.tree_map(lambda x: x[t], domain_batches)
            loss, grads = _value_and_grad(loss_fn, params, batch)
            updates, opt_state = opt.update(grads, opt_state, params)
            del grads
            params = apply_updates(params, updates)
        return params, loss

    @drjax.program(partition_size=partition_size)
    def btm_fn(seed_params, domain_data):
        branches = drjax.broadcast(seed_params)  # branch
        experts, final_losses = drjax.map_fn(train_expert,
                                             (branches, domain_data))  # train
        if merge == "weighted":
            w = torch.softmax(-final_losses, dim=0) * partition_size
            merged = drjax.reduce_weighted_mean(experts, w)
        else:
            merged = drjax.reduce_mean(experts)  # merge
        return merged, {
            "mean_final_loss": drjax.reduce_mean(final_losses),
            "max_final_loss": drjax.reduce_max(final_losses),
        }

    btm_fn.train_expert = train_expert
    return btm_fn
