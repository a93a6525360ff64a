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

``group_size`` overrides the grouping: the serve slot steps' decode
routes each row as a group of one token (``blocks.block_apply(...,
route_rows=True)``), as the reference's serve steps decode each slot
alone, since capacity couples the tokens of a group; a plain
``decode_step`` routes its batch as one group, as the reference's.

The reference's int8 expert-combine over a tensor-parallel mesh
(``tp_comm == "int8"``) waits for the distributed layer; without a mesh
the reference takes the plain contraction, as here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import common

F32 = torch.float32


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


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
          group_size: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss () f32)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    act = common.activation(cfg.act)
    total = b * s
    gs = group_size or _group_size(total)
    ng = total // gs
    xg = x.reshape(ng, gs, d)
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

    # dispatch: (G, E*C, T) @ (G, T, D) -> the experts' inputs
    xin = torch.matmul(dispatch.reshape(ng, gs, e * cap).transpose(1, 2), xg)
    xe = xin.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    h = common.matmul_f32(xe, p["wi"])
    g = common.matmul_f32(xe, p["wg"])
    h = (act(g) * h).to(x.dtype)
    eout = torch.bmm(h, p["wo"]).to(x.dtype)                   # (E, G*C, D)
    eout = eout.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    out = torch.matmul(combine.reshape(ng, gs, e * cap), eout)

    frac_tokens = r.onehot.sum(dim=2).mean(dim=(0, 1))         # (E,)
    frac_gates = r.gates.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_gates) / k
    return out.reshape(b, s, d), aux.to(F32)
