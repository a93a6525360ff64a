"""Asynchronous (one-round-stale) local SGD
(``repro/algorithms/async_rounds.py``).

Synchronous rounds serialize: [local steps] -> [reduce] -> [server update]
-> [broadcast]. The asynchronous round overlaps the aggregation with the
next round's training at one round of staleness:

    round r:   clients train on params_{r-1} while the server is still
               aggregating the deltas of round r-1;
    server:    applies delta_{r-1} as soon as it lands -> params_r.

The returned round has signature
``(params, pending_delta, server_state, round_data) ->
  (new_params, new_pending_delta, server_state, metrics)``
where ``pending_delta`` is the in-flight aggregate: the reduce of
``new_pending_delta`` has no data dependency on the next round's map. On
one card the clients run one after another in any case, so the port keeps
the algorithm (its staleness and its values), not an overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import core as drjax
from ..optim.optimizers import Optimizer, apply_updates
from .rounds import LocalSGDConfig, _make_client_update


def _init_pending(params):
    # Match each param's dtype (bf16 params get bf16 pending deltas) so the
    # first server update is not fed a dtype-mismatched aggregate.
    return pytree.tree_map(torch.zeros_like, params)


def make_async_local_sgd_round(loss_fn: Callable, client_opt: Optimizer,
                               server_opt: Optimizer, cfg: LocalSGDConfig):
    """Returns ``(async_round, init_pending)``. ``round_data`` leaves have
    shape (n, num_local_steps, ...); the client deltas are not compressed
    (the reference's asynchronous client update has no compression)."""
    client_update = _make_client_update(
        loss_fn, client_opt, dataclasses.replace(cfg, compression=None))

    @drjax.program(partition_size=cfg.partition_size)
    def async_round(params, pending_delta, server_state, round_data):
        with torch.no_grad():
            # 1) apply the delta that finished aggregating during the last
            #    round
            updates, server_state = server_opt.update(
                pending_delta, server_state, params)
            params = apply_updates(params, updates)
            # 2) this round's local training on the just-updated params
            params_b = drjax.broadcast(params)
            deltas, losses = drjax.map_fn(client_update,
                                          (params_b, round_data))
            # 3) aggregate: independent of (1)-(2) of the next round
            new_pending = drjax.reduce_mean(deltas)
            metrics = {"loss": drjax.reduce_mean(losses)}
        return params, new_pending, server_state, metrics

    return async_round, _init_pending


def make_hierarchical_async_round(loss_fn: Callable, client_opt: Optimizer,
                                  server_opt: Optimizer, cfg: LocalSGDConfig):
    """Pod-hierarchical asynchronous round under ``{"pods": cfg.num_pods,
    "clients": cfg.partition_size}``: the one-round-stale overlap of
    :func:`make_async_local_sgd_round`, aggregated by the two-stage
    ``hierarchical_reduce_mean``. ``round_data`` leaves are (num_pods,
    clients_per_pod, num_local_steps, ...); each client's delta is
    compressed as ``cfg.compression`` says (the reference's client update)."""
    if cfg.num_pods < 1:
        raise ValueError("make_hierarchical_async_round needs cfg.num_pods >= 1")
    client_update = _make_client_update(loss_fn, client_opt, cfg)

    @drjax.program(placements={"pods": cfg.num_pods,
                               "clients": cfg.partition_size})
    def async_round(params, pending_delta, server_state, round_data):
        with torch.no_grad():
            updates, server_state = server_opt.update(
                pending_delta, server_state, params)
            params = apply_updates(params, updates)
            params_b = drjax.broadcast(params)
            deltas, losses = drjax.map_fn(client_update,
                                          (params_b, round_data))
            new_pending = drjax.hierarchical_reduce_mean(deltas)
            metrics = {"loss": drjax.hierarchical_reduce_mean(losses)}
        return params, new_pending, server_state, metrics

    return async_round, _init_pending
