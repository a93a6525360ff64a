"""Elastic pod-hierarchical rounds (``repro/runtime/elastic.py``).

The paper's decoupling of the *logical* partition from the physical
devices is what makes DrJAX elastic: when a pod is lost (or gained) the
same round runs at the new pod count. Server state is placement-free and
carries over unchanged, and client state lives for one round only, so
nothing is lost with a failed pod.

Ported: :func:`make_elastic_hierarchical_round`, plain and
straggler-masked, on :class:`runtime.executor.ElasticHierarchicalRound`
(whose ``step(mesh=)`` runs it on a mesh of the surviving pods' ranks),
:class:`ElasticSchedule`, :func:`rescale_partition`, and the mesh helpers
:func:`available_mesh_shapes`, :func:`pod_device_pool` (of ranks) and
:func:`mesh_for_surviving_pods`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

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


def available_mesh_shapes(num_devices: int, model_parallelism: int = 1, *,
                          placements=None) -> List:
    """Every mesh shape that tiles a (possibly degraded) pool of
    ``num_devices`` ranks exactly (``repro/runtime/elastic.py:190``): the
    requested model parallelism first, then each halving down to 1.

    Without ``placements``: ``(data, model)`` pairs. With ``placements``
    (any spec ``launch.mesh.level_axes_for`` takes): every level but the
    outermost keeps its size and the outermost absorbs the pool; each
    entry is ``(shape, axes)``, the axes from ``level_axes_for``."""
    if placements is None:
        shapes: List[Tuple[int, int]] = []
        mp = model_parallelism
        while mp >= 1:
            if num_devices % mp == 0:
                shape = (num_devices // mp, mp)
                if shape not in shapes:
                    shapes.append(shape)
            if mp == 1:
                break
            mp //= 2
        return shapes

    from ..launch.mesh import _normalize_stack, level_axes_for

    stack = _normalize_stack(placements)
    if not stack:
        raise ValueError("placements must not be empty")
    level_axes = level_axes_for(stack)
    inner_sizes = tuple(s for _, s, _ in stack[1:])
    inner = 1
    for s in inner_sizes:
        inner *= s
    out: List[Tuple[Tuple[int, ...], Tuple[str, ...]]] = []
    mp = model_parallelism
    while mp >= 1:
        denom = inner * mp
        if denom and num_devices % denom == 0 and num_devices >= denom:
            shape: Tuple[int, ...] = (num_devices // denom,) + inner_sizes
            axes: Tuple[str, ...] = level_axes
            if model_parallelism > 1:
                shape = shape + (mp,)
                axes = axes + ("model",)
            if (shape, axes) not in out:
                out.append((shape, axes))
        if mp == 1:
            break
        mp //= 2
    return out


def pod_device_pool(num_pods: int, clients_per_pod: int,
                    devices=None) -> np.ndarray:
    """The world's ranks as a ``(num_pods, clients_per_pod)`` array: row p
    holds pod p's ranks, the unit of loss when a pod drops
    (``repro/runtime/elastic.py:258``). ``devices``: the ranks to lay out
    (default ``0 .. world_size - 1``)."""
    if devices is None:
        import torch.distributed as dist

        devices = range(dist.get_world_size())
    devs = [int(d) for d in devices]
    need = num_pods * clients_per_pod
    if len(devs) < need:
        raise ValueError(
            f"pod pool needs {need} ranks ({num_pods} pods x "
            f"{clients_per_pod} clients) but only {len(devs)} are available")
    return np.asarray(devs[:need], dtype=np.int64).reshape(num_pods,
                                                           clients_per_pod)


def mesh_for_surviving_pods(pool: np.ndarray, alive, *, device="cuda"):
    """The degraded ``(pod, data)`` mesh over the surviving pods (``alive``:
    their ids, rows of ``pool``): whole rows go, a pod is never re-tiled
    (``repro/runtime/elastic.py:276``). Built through
    ``launch.mesh.mesh_for_placements``'s rank subset; collective: every
    rank of the world calls it."""
    from ..launch.mesh import mesh_for_placements

    alive = tuple(int(a) for a in alive)
    if not alive:
        raise ValueError("need at least one surviving pod to build a mesh")
    sub = np.asarray(pool)[list(alive), :]
    return mesh_for_placements(
        {"pods": sub.shape[0], "clients": sub.shape[1]},
        devices=sub.reshape(-1), device=device)
