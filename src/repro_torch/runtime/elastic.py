"""Elastic pod-hierarchical rounds (``repro/runtime/elastic.py``).

The paper's decoupling of the *logical* partition from the physical
devices is what makes DrJAX elastic: when a pod is lost (or gained) the
same round runs at the new pod count. Server state is placement-free and
carries over unchanged, and client state lives for one round only, so
nothing is lost with a failed pod.

Ported: :func:`make_elastic_hierarchical_round`, plain and
straggler-masked, on :class:`runtime.executor.ElasticHierarchicalRound`,
and the helpers that need no mesh, :class:`ElasticSchedule` and
:func:`rescale_partition`. ``available_mesh_shapes``,
``pod_device_pool`` and ``mesh_for_surviving_pods`` wait for the
distributed layer (ROADMAP queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import core as drjax
from ..algorithms.rounds import _make_client_update
from ..core.primitives import reciprocal
from ..optim.optimizers import apply_updates
from .executor import ElasticHierarchicalRound


@dataclasses.dataclass
class ElasticSchedule:
    """Cohort-size policy as the device pool grows or shrinks
    (``repro/runtime/elastic.py:30``): ``groups_per_device`` keeps the load
    per device constant (weak scaling, the paper's Fig. 4 regime)."""

    groups_per_device: int = 1

    def cohort_size(self, num_devices: int) -> int:
        return max(1, num_devices * self.groups_per_device)


def rescale_partition(round_data, old_n: int, new_n: int):
    """A round's stacked cohort data from ``old_n`` to ``new_n`` groups
    (``repro/runtime/elastic.py:45``): a shrink drops the tail groups, a
    growth repeats the groups in order. Leaves are tensors or numpy
    arrays; a leaf whose leading axis is not ``old_n`` (or a scalar, or a
    non-array) is returned as it is."""

    def leaf(x):
        if not hasattr(x, "shape") or x.ndim == 0 or x.shape[0] != old_n:
            return x
        if new_n <= old_n:
            return x[:new_n]
        reps = -(-new_n // old_n)
        cat = torch.cat if torch.is_tensor(x) else np.concatenate
        return cat([x] * reps, 0)[:new_n]

    return pytree.tree_map(leaf, round_data)


def make_elastic_hierarchical_round(loss_fn: Callable, client_opt, server_opt,
                                    cfg, *, straggler_mask: bool = False,
                                    device: str = "cuda"
                                    ) -> ElasticHierarchicalRound:
    """Pod-hierarchical local SGD whose per-client leg survives a change of
    the pod count without a new trace.

    ``step(params, server_state, round_data)`` takes ``round_data`` leaves
    of shape ``(num_pods, cfg.partition_size, ...)`` for any
    ``num_pods``. The per-client leg is one compiled per-pod plan
    (``cfg.partition_size`` clients), called once per pod; the cross-pod
    leg, the mean of the pod partials and the server update, is built per
    pod count. Its mean is the sum over pods times ``reciprocal(P)``, in
    the order ``reduce_mean@pods`` takes (ROADMAP.md P1), so a step is
    bitwise :func:`~repro_torch.algorithms.rounds.
    make_hierarchical_local_sgd_round` at that pod count with
    ``cfg.compression`` None (the reference's "uncompressed path"; a
    compression in ``cfg`` applies to each client's delta here, as in the
    reference).

    ``straggler_mask=True``: ``round_data = {"data": <leaves (num_pods,
    clients_per_pod, ...)>, "mask": (num_pods, clients_per_pod)}``. Each
    pod's leg takes the mean over its finishers
    (``drjax.masked_reduce_mean``; a pod with none gives zeros) and their
    count, and the cross leg weights each pod's partial by its count and
    divides by the total (a division, as the reference's is), so the
    round is the flat masked mean over all finishers. The mask is data:
    a new finisher set builds nothing.
    """
    client_update = _make_client_update(loss_fn, client_opt, cfg)
    program = drjax.program(partition_size=cfg.partition_size)

    if straggler_mask:
        @program
        def client_leg(global_params, pod_batch):
            with torch.no_grad():
                params_b = drjax.broadcast(global_params)
                deltas, losses = drjax.map_fn(
                    client_update, (params_b, pod_batch["data"]))
                mask = pod_batch["mask"]
                return (drjax.masked_reduce_mean(deltas, mask),
                        drjax.masked_reduce_mean(losses, mask),
                        drjax.reduce_sum(mask))

        def cross_leg(global_params, server_state, partials):
            pod_deltas, pod_losses, pod_fin = partials
            with torch.no_grad():
                total = pod_fin.sum()
                denom = torch.clamp(total, min=1.0)

                def wmean(d):
                    w = pod_fin.reshape((-1,) + (1,) * (d.ndim - 1))
                    s = (d * w).sum(dim=0) / denom
                    return torch.where(total > 0, s, torch.zeros_like(s))

                mean_delta = pytree.tree_map(wmean, pod_deltas)
                updates, new_state = server_opt.update(
                    mean_delta, server_state, global_params)
                new_params = apply_updates(global_params, updates)
            return new_params, new_state, {"loss": wmean(pod_losses),
                                           "finishers": total}
    else:
        @program
        def client_leg(global_params, pod_data):
            with torch.no_grad():
                params_b = drjax.broadcast(global_params)
                deltas, losses = drjax.map_fn(client_update,
                                              (params_b, pod_data))
                return drjax.reduce_mean(deltas), drjax.reduce_mean(losses)

        def cross_leg(global_params, server_state, partials):
            pod_deltas, pod_losses = partials
            with torch.no_grad():
                r = reciprocal(pod_losses.shape[0])
                mean_delta = pytree.tree_map(lambda d: d.sum(dim=0) * r,
                                             pod_deltas)
                updates, new_state = server_opt.update(
                    mean_delta, server_state, global_params)
                new_params = apply_updates(global_params, updates)
            return new_params, new_state, {"loss": pod_losses.sum(dim=0) * r}

    return ElasticHierarchicalRound(client_leg, cross_leg,
                                    clients_per_pod=cfg.partition_size,
                                    device=device)
