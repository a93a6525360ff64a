"""RWKV-6 "Finch" block (``repro/models/rwkv.py``), train mode.

An attention-free time mix with data-dependent decay (arXiv:2404.05892),
per head of N = ``rwkv_head_dim`` channels over the state S (N x N):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   w_t = exp(-exp(w0 + LoRA(x_t)))

then a squared-ReLU channel mix. Parameters (the reference's names, all
under ``tm``): ``wr``, ``wk``, ``wv``, ``wg``, ``wo`` (D, D), ``mix``
(5, D), ``ln_scale`` (D,), ``cm_rk`` (2, D), ``ck`` (D, d_ff), ``cv``
(d_ff, D), ``cr`` (D, D) in the model dtype; ``w0`` (D,), ``wA`` (D, 32),
``wB`` (32, D) and ``u`` (D,) in f32. The recurrence runs through
``kernels.ops.wkv6`` (K5 forward and its chunked reverse pass on the card,
their plain sequential versions on the CPU). The reference's training path
runs ``chunked_wkv`` instead, whose factor ``exp(-lcw)`` overflows f32
under the model's own decays (ROADMAP.md, reference caveat R5); K5
computes the same function as its ``sequential_wkv`` and stays finite.

Products that the reference writes with ``preferred_element_type=f32``
run in the model dtype and are cast to f32, as in ``models/mlp.py``.

Left out for the serve slice: the shift and WKV states, ``init_state`` and
the decode step (``sequential_wkv``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from . import common

F32 = torch.float32
_LORA = 32


def num_heads(cfg) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


class RWKV(nn.Module):
    """The block's time-mix and channel-mix parameters, drawn from
    ``generator`` with the laws of the reference's ``rwkv.init_params``
    (other numbers)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        init = lambda shape, dtype=dt, std=None: nn.Parameter(
            common.normal_init(generator, shape, dtype, std, device=device))
        const = lambda shape, value: nn.Parameter(
            torch.full(shape, value, dtype=dt, device=device))
        self.wr = init((d, d))
        self.wk = init((d, d))
        self.wv = init((d, d))
        self.wg = init((d, d))
        self.wo = init((d, d))
        self.mix = const((5, d), 0.5)
        self.w0 = init((d,), F32, 0.5)
        self.wA = init((d, _LORA), F32, 0.1)
        self.wB = init((_LORA, d), F32, 0.1)
        self.u = init((d,), F32, 0.5)
        self.ln_scale = const((d,), 1.0)
        self.cm_rk = const((2, d), 0.5)
        self.ck = init((d, f))
        self.cv = init((f, d))
        self.cr = init((d, d))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift over (B, S, D): x_{t-1}, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mixes(p: Dict[str, torch.Tensor], x, xprev):
    """The static lerp token shift of the (r, k, v, g, w) inputs."""
    mix = p["mix"].to(x.dtype)
    return [x + (xprev - x) * mix[i] for i in range(5)]


def _decay(p: Dict[str, torch.Tensor], xw: torch.Tensor) -> torch.Tensor:
    """log w_t = -exp(w0 + tanh(xw A) B), an f32 product."""
    lora = torch.tanh(torch.matmul(xw.to(F32), p["wA"]))
    return -torch.exp(p["w0"] + torch.matmul(lora, p["wB"]))


def _group_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of (B, S, H, N) f32."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def time_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The RWKV-6 attention analogue. x (B, S, D) -> (B, S, D) in x's dtype."""
    b, s, d = x.shape
    h, n = num_heads(cfg), cfg.rwkv_head_dim
    xr, xk, xv, xg, xw = _mixes(p, x, _shift(x))
    r = torch.matmul(xr, p["wr"]).reshape(b, s, h, n)
    k = torch.matmul(xk, p["wk"]).reshape(b, s, h, n)
    v = torch.matmul(xv, p["wv"]).reshape(b, s, h, n)
    g = torch.matmul(xg, p["wg"])
    logw = _decay(p, xw).reshape(b, s, h, n)
    out = ops.wkv6(r.to(F32), k.to(F32), v.to(F32), logw,
                   p["u"].reshape(h, n))
    out = _group_norm(out, p["ln_scale"].to(F32).reshape(h, n))
    out = out.reshape(b, s, d).to(x.dtype) * F.silu(g)
    return torch.matmul(out, p["wo"])


def channel_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Squared-ReLU channel mix with a sigmoid receptance gate."""
    xprev = _shift(x)
    mix = p["cm_rk"].to(x.dtype)
    xk = x + (xprev - x) * mix[0]
    xr = x + (xprev - x) * mix[1]
    kk = torch.matmul(xk, p["ck"]).to(F32)
    kk = torch.square(F.relu(kk)).to(x.dtype)
    vv = torch.matmul(kk, p["cv"]).to(F32)
    rr = torch.sigmoid(torch.matmul(xr, p["cr"]).to(F32))
    return (rr * vv).to(x.dtype)
