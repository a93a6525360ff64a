"""RG-LRU recurrent block (``repro/models/rglru.py``): train, prefill,
decode and chunked prefill.

Griffin's recurrent block (RecurrentGemma, arXiv:2402.19427):

    x -- linear_in --+-- causal conv1d(4) -- RG-LRU --+
                     +-- gelu gate -------------------*-- linear_out

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    a_t = exp(-8 * softplus(lam) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Parameters (the reference's names): ``w_in`` (D, 2W), ``w_out`` (W, D),
``conv`` (4, W), ``w_a``/``w_x`` (W, W), ``b_a``/``b_x`` (W,) in the model
dtype, and ``lam`` (W,) in f32. The recurrence runs through
``kernels.ops.lru_scan`` (K4 forward and its reverse-scan backward on the
card, their plain versions on the CPU), where the reference runs
``jax.lax.associative_scan``: the results differ only in the order of f32
operations.

The serve paths carry a state per layer, ``{"h": (B, W) f32, "conv": (B,
3, W) f32}``: the LRU state and the last three conv inputs
(:func:`init_state`). :func:`prefill` (with ``state``, chunked prefill)
continues both across a chunk boundary and runs the recurrence through
``ops.lru_scan`` with ``h0``: K4 on the card. :func:`decode_step` is the
reference's fused single step, ``h = a * h + b``, in plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from . import common
from .partitioning import with_logical_constraint

F32 = torch.float32
_C = 8.0
_CONV_WIDTH = 4


class RGLRU(nn.Module):
    """The block's parameters, drawn from ``generator`` as the reference's
    ``rglru.init_params`` draws them (other numbers, the same laws)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, w, dt = cfg.d_model, cfg.lru_width, cfg.torch_dtype
        init = lambda shape, dtype=dt, std=None: nn.Parameter(
            common.normal_init(generator, shape, dtype, std, device=device))
        self.w_in = init((d, 2 * w))
        self.w_out = init((w, d))
        self.conv = init((_CONV_WIDTH, w), std=0.1)
        self.w_a = init((w, w))
        self.b_a = nn.Parameter(torch.zeros(w, dtype=dt, device=device))
        self.w_x = init((w, w))
        self.b_x = nn.Parameter(torch.zeros(w, dtype=dt, device=device))
        self.lam = init((w,), F32, 0.5)


def _gates(p: Dict[str, torch.Tensor], u: torch.Tensor):
    """u (..., W), the conv output. Returns the decay a and the gated input,
    both f32: the gate products in u's dtype, the rest in f32."""
    r = torch.sigmoid(torch.matmul(u, p["w_a"]).to(F32) + p["b_a"].to(F32))
    i = torch.sigmoid(torch.matmul(u, p["w_x"]).to(F32) + p["b_x"].to(F32))
    # softplus as the reference's logaddexp(lam, 0)
    log_a = -_C * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"])) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u.to(F32))
    return a, gated


def _causal_conv(p: Dict[str, torch.Tensor], x: torch.Tensor, state=None):
    """Depthwise causal conv of width 4 over (B, S, W), in f32, cast back:
    ``out_s = sum_t x_{s-3+t} * conv_t``, with zeros before the start or,
    given ``state`` (B, 3, W) f32, the last three inputs before this chunk
    (``repro/models/rglru.py:79 _causal_conv``). Returns (out, the last
    three inputs, or None without a state)."""
    w = p["conv"].to(F32)
    s = x.shape[1]
    if state is None:
        xf = F.pad(x.to(F32), (0, 0, _CONV_WIDTH - 1, 0))
    else:
        xf = torch.cat([state.to(F32), x.to(F32)], dim=1)
    out = xf[:, 0:s] * w[0]
    for t in range(1, _CONV_WIDTH):
        out = out + xf[:, t:t + s] * w[t]
    return out.to(x.dtype), (None if state is None
                             else xf[:, -(_CONV_WIDTH - 1):])


def param_axes(cfg):
    """``repro/models/rglru.py:48-58``."""
    return {"w_in": ("p_fsdp", "recurrent_width"),
            "w_out": ("recurrent_width", "p_fsdp"),
            "conv": (None, "recurrent_width"),
            "w_a": ("p_fsdp", "recurrent_width"), "b_a": ("recurrent_width",),
            "w_x": ("p_fsdp", "recurrent_width"), "b_x": ("recurrent_width",),
            "lam": ("recurrent_width",)}


def state_axes():
    return {"h": ("kv_batch", "recurrent_width"),
            "conv": ("kv_batch", None, "recurrent_width")}


def _in_proj(p, x):
    u = torch.matmul(x, p["w_in"])
    return torch.chunk(u, 2, dim=-1)


def _out_proj(p, h, gate, dtype):
    h = h.to(dtype) * common.activation("gelu")(gate)
    return torch.matmul(h, p["w_out"])


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Train path. x (B, S, D) -> (B, S, D) in x's dtype."""
    u, gate = _in_proj(p, x)
    u = with_logical_constraint(u, ("batch", "seq", "recurrent_width"))
    u, _ = _causal_conv(p, u)
    a, bterm = _gates(p, u)
    return _out_proj(p, ops.lru_scan(a, bterm), gate, x.dtype)


def init_state(cfg, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero serve state (``repro/models/rglru.py:132 init_state``)."""
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, _CONV_WIDTH - 1, w), dtype=F32,
                                device=device)}


def decode_step(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, state):
    """x (B, 1, D) -> (out (B, 1, D), new state): one step of the conv
    window and of ``h = a * h + b`` (``repro/models/rglru.py:147
    decode_step``)."""
    u, gate = _in_proj(p, x)
    u, conv = _causal_conv(p, u, state["conv"])
    a, bterm = _gates(p, u[:, 0])
    h = a * state["h"] + bterm
    return _out_proj(p, h[:, None], gate, x.dtype), {"h": h, "conv": conv}


def prefill(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, state=None):
    """The block over a prefix, x (B, S, D) -> (out, final state)
    (``repro/models/rglru.py:160 prefill``). With ``state``, a previous
    chunk's, the conv window and the LRU state continue across the chunk
    boundary: chunked prefill. The recurrence is ``ops.lru_scan`` with
    ``h0`` (K4 on the card)."""
    u, gate = _in_proj(p, x)
    uc, _ = _causal_conv(p, u, None if state is None else state["conv"])
    a, bterm = _gates(p, uc)
    h = ops.lru_scan(a, bterm, None if state is None else state["h"])
    out = _out_proj(p, h, gate, x.dtype)
    u32 = u.to(F32)
    if state is not None:  # the conv inputs so far: the window, then the chunk
        u32 = torch.cat([state["conv"].to(F32), u32], dim=1)
    if u32.shape[1] < _CONV_WIDTH - 1:  # a short prefix: zeros before it
        u32 = F.pad(u32, (0, 0, _CONV_WIDTH - 1 - u32.shape[1], 0))
    return out, {"h": h[:, -1].to(F32), "conv": u32[:, -(_CONV_WIDTH - 1):]}
