"""Mixture-of-Experts FFN (``repro/models/moe.py``): top-k routing with
capacity-limited one-hot dispatch and the load-balancing loss.

Parameters: ``router`` (D, E) in f32, ``wi``/``wg`` (E, D, F) and ``wo``
(E, F, D) in the model dtype. :func:`apply` regroups the B x S tokens into
routing groups of :func:`_group_size` tokens, routes each token in f32
(softmax over the experts, its top k, those k gates renormalised to sum
to one), and gives each expert ``max(int(cf * gs * k / E), 1)`` slots in
each group. A (token, choice) takes the next free slot of its expert in
(token, choice) order; past capacity it is dropped. Dispatch and combine
are one-hot products, the experts' gated FFNs plain batched matmuls over
the expert axis (the reference computes them outside any Pallas kernel).
As in ``mlp.apply``, the up and gate products are f32 results
(``common.matmul_f32``, the reference's ``preferred_element_type``,
``repro/models/moe.py:154-155``) and the gate ``act(g) * h`` is taken in
f32 and cast back to the model dtype. The aux loss is
``E * sum(frac_tokens * frac_gates) / k`` (GShard eq. 4).

Ties between gates go to the lower expert index, as ``jax.lax.top_k``
picks them (a stable descending sort; ``torch.topk`` leaves the order of
equal values unspecified on the card). A slot index past capacity gives
no slot, as the reference's one-hot of an out-of-range index gives an
all-zero row: a comparison with ``arange(cap)``, which, unlike
``F.one_hot``, neither raises on such an index nor reads the index back to
the host (a CUDA graph captures it).

The groups are the whole batch's: where a step splits the batch's rows
over ranks (``partitioning.batch_split``), group g is ``gs`` consecutive
tokens of the global (B·S) order, each rank's rows in
``partitioning.batch_index`` order, as the reference groups the global
batch and GSPMD carries a group across devices. A rank whose rows hold
whole groups routes them alone. Where a group spans the ranks' rows
(the whole batch's ``gs`` does not divide a rank's tokens: a decode
step's few rows, a short prefill), the rank gathers the batch's tokens
exactly over the chain (``partitioning.batch_gather``), computes the
groups its rows touch whole (routing, capacity positions in the group's
(token, choice) order, dispatch, experts, combine: what every rank of
the reference computes for a group it cannot split) and keeps its rows:
each of its tokens gets the choices, slots and weights of the
whole-batch run, bitwise. The gather's gradient is the chain's summed
cotangents, so the train step's gradient is the whole batch's. On split
rows the aux loss comes from the batch's sums over the chain
(``partitioning.batch_sum``: the choice counts exact, the gate sums f32 in
another order), as the reference's means over the whole batch. With
``aux=False`` (the serve modes, which drop it) no aux is computed and no
collective runs for it. ``group_size`` overrides the grouping: the serve
slot steps' decode routes each row as a group of one token
(``blocks.block_apply(..., route_rows=True)``), as the reference's serve
steps decode each slot alone, since capacity couples the tokens of a
group; a plain ``decode_step`` routes its batch as one group, as the
reference's.

Tensor parallelism (``models/partitioning.py``): where a step kept the
rank's experts (``wi``/``wg`` (E/m, D, F), ``wo`` (E/m, F, D);
``partitioning.local_block``), the routing is computed whole on every
rank, the dispatch and combine weights are sliced to the rank's experts
before the dispatch product, the tokens and the combine weights enter a
tensor-parallel region, and the combine's f32 partial sums are summed
over ``"model"``; with ``cfg.tp_comm == "int8"`` and
``"experts"`` resolving to ``"model"`` the sum rides int8 (:func:`_combine`,
``repro/models/moe.py:46-90``, forward-only). Without a mesh the combine is
the plain contraction, as the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import common, partitioning, tpcomm
from .partitioning import with_logical_constraint

F32 = torch.float32


def param_axes(cfg):
    return {"router": ("p_fsdp", None), "wi": ("p_experts", "p_fsdp", None),
            "wg": ("p_experts", "p_fsdp", None),
            "wo": ("p_experts", None, "p_fsdp")}


class MoE(nn.Module):
    """router (D, E) f32, wi/wg (E, D, F), wo (E, F, D), drawn in this
    order as the reference draws them."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, e, f, dt = cfg.d_model, cfg.num_experts, cfg.d_ff, cfg.torch_dtype
        init = lambda shape, dtype, std=None: nn.Parameter(  # noqa: E731
            common.normal_init(generator, shape, dtype, std, device=device))
        self.router = init((d, e), F32, 0.02)
        self.wi = init((e, d, f), dt)
        self.wg = init((e, d, f), dt)
        self.wo = init((e, f, d), dt)


def _top_k_mask(gates: torch.Tensor, k: int):
    """gates (..., E) -> (one-hot (..., k, E) in gates' dtype, values
    (..., k)), ties to the lower index."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    experts = torch.arange(gates.shape[-1], device=gates.device)
    return (idx[..., None] == experts).to(gates.dtype), vals


def _group_size(total_tokens: int, target: int = 512) -> int:
    """The largest divisor of ``total_tokens`` that is at most ``target``."""
    gs = min(target, total_tokens)
    while total_tokens % gs != 0:
        gs -= 1
    return gs


class Routing(NamedTuple):
    """One call's routing: ``gates`` (G, T, E) f32, ``onehot`` (G, T, k, E)
    of each token's choices, ``weights`` (G, T, k) the renormalised top
    gates, ``kept`` (G, T, k, E) the choices that found a slot, ``slot``
    (G, T, k, E) the slot each kept choice takes, ``capacity`` the slots
    an expert has in a group."""

    gates: torch.Tensor
    onehot: torch.Tensor
    weights: torch.Tensor
    kept: torch.Tensor
    slot: torch.Tensor
    capacity: int


def route(cfg, p: Dict[str, torch.Tensor], xg: torch.Tensor) -> Routing:
    """Routing of the grouped tokens ``xg`` (G, T, D) (f32, as the
    reference's): top-k, renormalisation and capacity assignment."""
    ng, gs, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.matmul(xg.to(F32), p["router"].to(F32))
    gates = torch.softmax(logits, dim=-1)
    onehot, topv = _top_k_mask(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(cfg.capacity_factor * gs * k / e), 1)
    chosen = onehot.to(torch.int32).reshape(ng, gs * k, e)
    # each (token, choice)'s place in its expert's queue, in (token,
    # choice) order
    pos = torch.cumsum(chosen, dim=1) - chosen
    kept = (chosen > 0) & (pos < cap)
    return Routing(gates, onehot, topv, kept.reshape(ng, gs, k, e),
                   (pos * kept).reshape(ng, gs, k, e), cap)


def _combine(cfg, eout: torch.Tensor, combine: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The expert combine (G, T, E_l*C) @ (G, E_l*C, D) of the rank's
    experts, reduced over ``"model"``: in f32, or in int8 with
    ``cfg.tp_comm == "int8"`` (``repro/models/moe.py:46-90``)."""
    part = common.matmul_f32(combine, eout)
    if (cfg.tp_comm == "int8" and partitioning.resolve_axis(
            "experts", cfg.num_experts) == partitioning.MODEL):
        return tpcomm.int8_reduce(part, dtype)
    return partitioning.reduce_sum(part).to(dtype)


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
          group_size: Optional[int] = None, aux: bool = True
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss () f32, or None
    with ``aux=False``)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    # the rank's experts, where the step's layout kept them
    tp = partitioning.local_block(cfg, p["wi"], 0, "p_experts", e)
    el = p["wi"].shape[0]
    act = common.activation(cfg.act)
    total = b * s
    # the groups of the whole batch, whose rows a step may split over ranks
    shards = 1 if group_size else partitioning.batch_shards()
    gs = group_size or _group_size(total * shards)
    xt = x.reshape(total, d)
    first = 0  # the rank's first token in the grouped tokens
    if total % gs:
        # groups span the ranks' rows: the groups this rank's rows touch,
        # from the batch's tokens
        start = partitioning.batch_index() * total
        g0, g1 = start // gs, (start + total - 1) // gs + 1
        xt = partitioning.batch_gather(xt, 0)[g0 * gs:g1 * gs]
        first = start - g0 * gs
    ng = xt.shape[0] // gs
    xg = with_logical_constraint(xt.reshape(ng, gs, d), ("batch", None, "embed"))
    r = route(cfg, p, xg)
    cap = r.capacity

    # a token picks each expert at most once, so over its k choices one
    # term of each (token, expert) sum is nonzero, as in the reference's
    # sum over k of per-choice one-hots
    kept = r.kept.any(dim=2)                                   # (G, T, E)
    slot = r.slot.sum(dim=2)
    weight = (r.kept.to(F32) * r.weights[..., None]).sum(dim=2)
    slots = torch.arange(cap, device=x.device)
    dispatch = (kept[..., None] & (slot[..., None] == slots)).to(x.dtype)
    combine = dispatch * weight[..., None].to(x.dtype)         # (G, T, E, C)
    dispatch = with_logical_constraint(dispatch, ("batch", None, "experts", None))
    combine = with_logical_constraint(combine, ("batch", None, "experts", None))

    xd = xg
    if tp:  # the tokens enter a tensor-parallel region of the rank's experts
        lo = partitioning.model_index() * el
        xd = partitioning.enter(xg)
        dispatch = dispatch.narrow(2, lo, el)
        combine = partitioning.enter(combine).narrow(2, lo, el)
    # dispatch: (G, E_l*C, T) @ (G, T, D) -> the (rank's) experts' inputs
    xin = torch.matmul(dispatch.reshape(ng, gs, el * cap).transpose(1, 2), xd)
    xin = xin.reshape(ng, el, cap, d)
    xin = with_logical_constraint(xin, ("batch", "experts", None, None))
    xe = xin.transpose(0, 1).reshape(el, ng * cap, d)
    h = common.matmul_f32(xe, p["wi"])
    g = common.matmul_f32(xe, p["wg"])
    h = (act(g) * h).to(x.dtype)
    eout = torch.bmm(h, p["wo"]).to(x.dtype)                   # (E, G*C, D)
    eout = eout.reshape(el, ng, cap, d).transpose(0, 1)
    eout = with_logical_constraint(eout, ("batch", "experts", None, None))
    eout = eout.reshape(ng, el * cap, d)
    combine = combine.reshape(ng, gs, el * cap)
    if tp:
        out = _combine(cfg, eout, combine, x.dtype)
    else:
        out = torch.matmul(combine, eout)
    if ng * gs != total:  # the rank's rows of the groups they touch
        out = out.reshape(ng * gs, d)[first:first + total]
    out = with_logical_constraint(out.reshape(b, s, d), ("batch", "seq", "embed"))
    if not aux:
        return out, None
    if shards > 1:
        # the whole batch's means, from this rank's tokens' sums over the
        # chain
        own = slice(first, first + total)
        counts = r.onehot.sum(dim=2).reshape(-1, e)[own].sum(dim=0)
        gate_sums = r.gates.reshape(-1, e)[own].sum(dim=0)
        n = total * shards
        frac_tokens = partitioning.batch_sum(counts) / n
        frac_gates = partitioning.batch_sum(gate_sums) / n
    else:
        frac_tokens = r.onehot.sum(dim=2).mean(dim=(0, 1))     # (E,)
        frac_gates = r.gates.mean(dim=(0, 1))
    loss = e * torch.sum(frac_tokens * frac_gates) / k
    return out, loss.to(F32)
