"""MapReduce training rounds: local SGD / FedAvg / DiLoCo / FedSGD
(``repro/algorithms/rounds.py``), the paper's §4 workload:

    params_b = drjax.broadcast(global_params)           # server -> groups
    deltas   = drjax.map_fn(client_update, (params_b, round_data))
    delta    = drjax.reduce_mean(deltas)                # groups -> server
    params   = server_opt(global_params, delta)

``client_update`` runs ``num_local_steps`` optimizer steps on one group's
batches, for any ``loss_fn(params, batch)`` over a dict of tensors. The
round itself runs without autograd; each client step takes its gradient
with ``torch.autograd.grad`` on a detached copy of the client's parameters.
FedSGD with learned weights is the exception: its weighted means run with
autograd on, so the round's outputs are differentiable in the weights.

Ported: ``LocalSGDConfig``, the client update, ``make_local_sgd_round``,
``make_hierarchical_local_sgd_round``, ``make_multi_round`` and
``make_fedsgd_round``, with int8 or top-k compression and straggler masks
(``cfg.straggler_mask`` and a ``mask`` argument: the masked reduction
averages over the groups that finished). The asynchronous rounds are in
``async_rounds.py``.

On a mesh (``cfg.mesh``, ``cfg.partition_axes``) each rank runs its own
clients and the means are collectives; ``cfg.use_sharding_annotations=
False`` is DrJAX-NS.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .. import core as drjax
from ..compression import api as compression
from ..core import api as core_api
from ..core import primitives as prims
from ..core.primitives import reciprocal
from ..optim.optimizers import Optimizer, apply_updates, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    partition_size: int
    num_local_steps: int = 4
    # The mesh dim(s) the clients shard over (e.g. "data"), a DeviceMesh,
    # and the sharding switch (False: DrJAX-NS, every rank runs every
    # client).
    partition_axes: Any = None
    mesh: Any = None
    use_sharding_annotations: bool = True
    grad_clip: float = 0.0
    compression: Optional[str] = None  # None | "int8" | "topk"
    topk_fraction: float = 0.01
    straggler_mask: bool = False
    # Pod-hierarchical rounds: number of slow-link domains (0 = flat). Then
    # partition_size counts clients PER POD and the round runs under the
    # nested {"pods": num_pods, "clients": partition_size} stack.
    num_pods: int = 0
    # Fused reduce+compress for the hierarchical int8 aggregation: None =
    # auto, False = force the generic composition, True = insist.
    fused_reduce: Optional[bool] = None

    def __post_init__(self):
        if self.compression not in (None, "int8", "topk"):
            raise ValueError(
                f"compression={self.compression!r}: expected None, 'int8' "
                "or 'topk'"
            )


def _tree_sub(a, b):
    return pytree.tree_map(
        lambda x, y: x.to(torch.float32) - y.to(torch.float32), a, b
    )


def _hier_axes(cfg: LocalSGDConfig):
    """Per-placement mesh axes of the nested {pods, clients} stack
    (``repro/algorithms/rounds.py:65-80``): a mapping passes through, a
    tuple of two or more axes gives its first to pods and the rest to
    clients, a single axis goes to clients (pods stay logical)."""
    axes = cfg.partition_axes
    if axes is None:
        return None
    if isinstance(axes, dict):
        return axes
    if isinstance(axes, (tuple, list)) and len(axes) >= 2:
        rest = tuple(axes[1:])
        return {"pods": axes[0], "clients": rest if len(rest) > 1 else rest[0]}
    if isinstance(axes, (tuple, list)):
        axes = axes[0]
    return {"pods": None, "clients": axes}


def _sharding(cfg: LocalSGDConfig, partition_axes) -> dict:
    return dict(partition_axes=partition_axes, mesh=cfg.mesh,
                use_sharding_annotations=cfg.use_sharding_annotations)


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``, both detached: the
    gradient of a detached copy, so the caller may run without autograd."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    return loss.detach(), grads


def _compress(delta, cfg: LocalSGDConfig):
    if cfg.compression == "int8":
        return compression.int8_roundtrip(delta)
    if cfg.compression == "topk":
        return compression.topk_sparsify_layers(delta, cfg.topk_fraction)
    return delta


def _make_client_update(loss_fn: Callable, client_opt: Optimizer,
                        cfg: LocalSGDConfig):
    """num_local_steps optimizer steps on one group's batches -> (delta,
    loss), the delta compressed as ``cfg.compression`` says."""

    def client_update(params0, client_data):
        opt_state = client_opt.init(params0)
        params = params0
        steps = pytree.tree_leaves(client_data)[0].shape[0]
        losses = []
        for t in range(steps):
            batch = pytree.tree_map(lambda x: x[t], client_data)
            loss, grads = _value_and_grad(loss_fn, params, batch)
            if cfg.grad_clip:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
            updates, opt_state = client_opt.update(grads, opt_state, params)
            del grads
            params = apply_updates(params, updates)
            del updates
            losses.append(loss)
        delta = _compress(_tree_sub(params, params0), cfg)
        return delta, torch.stack(losses).sum() * reciprocal(len(losses))

    return client_update


def make_local_sgd_round(loss_fn: Callable, client_opt: Optimizer,
                         server_opt: Optimizer, cfg: LocalSGDConfig):
    """Returns ``round_fn(global_params, server_state, round_data[, mask])``.

    ``round_data`` leaves have shape (n, num_local_steps, ...per-step batch);
    ``mask`` (n,) f32, used when ``cfg.straggler_mask``, weights the mean
    over the clients. Returns (new_params, new_server_state, metrics).
    """
    client_update = _make_client_update(loss_fn, client_opt, cfg)

    @drjax.program(partition_size=cfg.partition_size,
                   **_sharding(cfg, cfg.partition_axes))
    def round_fn(global_params, server_state, round_data, mask=None):
        with torch.no_grad():
            params_b = drjax.broadcast(global_params)
            deltas, losses = drjax.map_fn(client_update, (params_b, round_data))
            if cfg.straggler_mask and mask is not None:
                mean_delta = drjax.masked_reduce_mean(deltas, mask)
                mean_loss = drjax.masked_reduce_mean(losses, mask)
            else:
                mean_delta = drjax.reduce_mean(deltas)
                mean_loss = drjax.reduce_mean(losses)
            del deltas
            updates, new_server_state = server_opt.update(
                mean_delta, server_state, global_params
            )
            new_params = apply_updates(global_params, updates)
        return new_params, new_server_state, {"loss": mean_loss}

    return round_fn


def make_hierarchical_local_sgd_round(loss_fn: Callable, client_opt: Optimizer,
                                      server_opt: Optimizer,
                                      cfg: LocalSGDConfig):
    """Pod-hierarchical local SGD under ``{"pods": cfg.num_pods, "clients":
    cfg.partition_size}``. ``round_data`` leaves have shape (num_pods,
    clients_per_pod, num_local_steps, ...); an optional straggler ``mask``
    is (num_pods, clients_per_pod). Unmasked, the aggregation is the
    two-stage ``hierarchical_reduce_mean`` with ``cfg.compression`` applied
    to the pod partials (the bytes that cross the slow leg), so the
    per-client leg runs uncompressed; int8 takes the fused reduce+compress
    kernel unless ``cfg.fused_reduce`` is False, top-k the generic
    composition (no fused kernel). With ``cfg.straggler_mask``
    the masked reduction spans both levels in one weighted pass, so the
    round keeps the flat round's per-client compression and takes no pod
    partial path, fused or not.
    """
    if cfg.num_pods < 1:
        raise ValueError("make_hierarchical_local_sgd_round needs cfg.num_pods >= 1")
    client_cfg = (cfg if cfg.straggler_mask
                  else dataclasses.replace(cfg, compression=None))
    client_update = _make_client_update(loss_fn, client_opt, client_cfg)
    pod_compress = None
    if not cfg.straggler_mask:
        if cfg.compression == "int8":
            pod_compress = compression.int8_roundtrip
        elif cfg.compression == "topk":
            pod_compress = functools.partial(
                compression.topk_sparsify_layers, fraction=cfg.topk_fraction,
                layer_axis=1)

    @drjax.program(placements={"pods": cfg.num_pods,
                               "clients": cfg.partition_size},
                   **_sharding(cfg, _hier_axes(cfg)))
    def round_fn(global_params, server_state, round_data, mask=None):
        with torch.no_grad():
            params_b = drjax.broadcast(global_params)
            deltas, losses = drjax.map_fn(client_update, (params_b, round_data))
            if cfg.straggler_mask and mask is not None:
                mean_delta = drjax.masked_reduce_mean(deltas, mask)
                mean_loss = drjax.masked_reduce_mean(losses, mask)
            else:
                mean_delta = drjax.hierarchical_reduce_mean(
                    deltas, compress_fn=pod_compress,
                    use_fused=cfg.fused_reduce
                )
                mean_loss = drjax.hierarchical_reduce_mean(losses)
            del deltas
            updates, new_server_state = server_opt.update(
                mean_delta, server_state, global_params
            )
            new_params = apply_updates(global_params, updates)
        return new_params, new_server_state, {"loss": mean_loss}

    return round_fn


def make_multi_round(round_fn: Callable, num_rounds: int, *,
                     jit: bool = False, donate: bool = True) -> Callable:
    """``num_rounds`` rounds of ``round_fn`` as one trainer
    ``(params, server_state, all_data) -> (params, server_state, metrics)``.

    ``all_data`` leaves carry a leading ``num_rounds`` axis; each metric
    comes back stacked along a leading rounds axis, as the reference's
    ``lax.scan`` stacks it. The rounds run one after another, each the
    same call as on its own. ``jit`` and ``donate`` select the reference's
    compilation and buffer donation; they have no meaning here and are
    accepted so callers carry over.

    While a program is traced (``primitives.recording``), the trainer is
    one ``torch.ops.higher_order.scan`` node instead, as the reference's
    is one ``lax.scan``: carry ``(params, server_state)``, ``xs`` the
    round data, ``ys`` the stacked metrics. ``build_plan`` makes it one
    ``LOOP[scan]`` stage whose body is the round, and ``run_plan`` runs
    that body once per round: the same calls as the direct loop.
    """
    del jit, donate

    def trainer(params, server_state, all_data):
        if prims.is_recording() and core_api._under_trace():
            return _scanned_rounds(round_fn, params, server_state, all_data)
        metrics = []
        for r in range(num_rounds):
            round_data = pytree.tree_map(lambda x: x[r], all_data)
            params, server_state, m = round_fn(params, server_state,
                                               round_data)
            metrics.append(m)
        return params, server_state, pytree.tree_map(
            lambda *xs: torch.stack(xs), *metrics)

    return trainer


def _scanned_rounds(round_fn: Callable, params, server_state, all_data):
    """The trainer as one recorded scan node over the rounds axis."""
    carry, carry_spec = pytree.tree_flatten((params, server_state))
    xs, xs_spec = pytree.tree_flatten(all_data)
    n_carry, y_spec = len(carry), []

    def body(*leaves):
        p, s = pytree.tree_unflatten(list(leaves[:n_carry]), carry_spec)
        round_data = pytree.tree_unflatten(list(leaves[n_carry:]), xs_spec)
        p, s, metrics = round_fn(p, s, round_data)
        ys, spec = pytree.tree_flatten(metrics)
        y_spec[:] = [spec]
        # No output of a scan body may be one of its inputs: a leaf the
        # round passed through unchanged goes out as a copy.
        out = [c.clone() if any(c is x for x in leaves) else c
               for c in pytree.tree_leaves((p, s))]
        return out + ys

    outs = core_api.recorded_scan(body, carry, xs)
    params, server_state = pytree.tree_unflatten(list(outs[:n_carry]),
                                                 carry_spec)
    return params, server_state, pytree.tree_unflatten(list(outs[n_carry:]),
                                                       y_spec[0])


def make_fedsgd_round(loss_fn: Callable, server_opt: Optimizer,
                      cfg: LocalSGDConfig, *, learned_weights: bool = False):
    """Single-local-step gradient averaging (FedSGD):
    ``round_fn(global_params, server_state, batches[, weights])``, with
    ``batches`` leaves of shape (n, ...per-client batch).

    With ``learned_weights=True`` the reduction weights are a trainable
    input, the self-tuning reduction of paper §6: the means run as
    ``reduce_weighted_mean`` with weights ``softmax(weights) * n`` and with
    autograd on, so the round's loss (and its new params) carry a gradient
    to ``weights`` when they require one.
    """

    def client_grad(params, batch):
        loss, grads = _value_and_grad(loss_fn, params, batch)
        return grads, loss

    @drjax.program(partition_size=cfg.partition_size,
                   **_sharding(cfg, cfg.partition_axes))
    def round_fn(global_params, server_state, batches, weights=None):
        with torch.no_grad():
            params_b = drjax.broadcast(global_params)
            grads, losses = drjax.map_fn(client_grad, (params_b, batches))
        learned = learned_weights and weights is not None
        with torch.set_grad_enabled(learned):
            if learned:
                w = torch.softmax(weights, dim=0) * cfg.partition_size
                mean_grad = drjax.reduce_weighted_mean(grads, w)
                mean_loss = drjax.reduce_weighted_mean(losses, w)
            else:
                mean_grad = drjax.reduce_mean(grads)
                mean_loss = drjax.reduce_mean(losses)
            del grads
            neg = pytree.tree_map(lambda g: -g, mean_grad)
            updates, new_server_state = server_opt.update(
                neg, server_state, global_params)
            new_params = apply_updates(global_params, updates)
        return new_params, new_server_state, {"loss": mean_loss}

    return round_fn
