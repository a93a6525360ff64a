"""RWKV-6 "Finch" block (``repro/models/rwkv.py``): train, prefill, decode
and chunked prefill.

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

The serve paths carry a state per layer (:func:`init_state`): the last
inputs of the time and channel mixes' token shifts (B, D) f32 and the WKV
state (B, H, N, N) f32. With more than one token, :func:`time_mix` runs
K5 from that state (``ops.wkv6(..., s0=)``, which returns the final state
too); a single token (decode) takes the sequential step in plain PyTorch,
as the reference runs ``sequential_wkv`` there (``chunked=(mode !=
"decode")``, ``repro/models/blocks.py:160``; a chunk of one token is
sequential in the reference too).
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


def param_axes(cfg):
    """``repro/models/rwkv.py:66-84``."""
    return {"wr": ("p_fsdp", "heads"), "wk": ("p_fsdp", "heads"),
            "wv": ("p_fsdp", "heads"), "wg": ("p_fsdp", "heads"),
            "wo": ("heads", "p_fsdp"), "mix": (None, None), "w0": (None,),
            "wA": (None, None), "wB": (None, None), "u": (None,),
            "ln_scale": (None,), "cm_rk": (None, None),
            "ck": ("p_fsdp", "p_ff"), "cv": ("p_ff", "p_fsdp"),
            "cr": ("p_fsdp", None)}


def state_axes():
    return {"tm_shift": ("kv_batch", None), "cm_shift": ("kv_batch", None),
            "wkv": ("kv_batch", "heads", None, None)}


def _shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """Token shift over (B, S, D): x_{t-1}, at t = 0 zeros or ``last``
    (B, D), the previous chunk's last input (``repro/models/rwkv.py:86``)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


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


def _wkv_step(r, k, v, logw, u, state):
    """One token of WKV from ``state``, the step of the reference's
    sequential decode (``repro/models/rwkv.py:119 sequential_wkv``):
    o = r^T (S + diag(u) k v^T), S' = diag(exp(logw)) S + k v^T. r, k, v,
    logw (B, H, N) f32, u (H, N), state (B, H, N, N) f32 -> (o (B, 1, H, N),
    S')."""
    kv = k[..., :, None] * v[..., None, :]
    uu = u.to(F32)[None, :, :, None]
    o = torch.einsum("bhk,bhkv->bhv", r, state + uu * kv)
    return o[:, None], torch.exp(logw)[..., None] * state + kv


def time_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
             shift_state=None, wkv_state=None):
    """The RWKV-6 attention analogue (``repro/models/rwkv.py:203``). x
    (B, S, D) -> (out (B, S, D) in x's dtype, (new shift state (B, D) f32,
    final WKV state (B, H, N, N) f32)), from the given states or zeros.
    S > 1 runs K5 (``ops.wkv6``) from ``wkv_state``; S = 1 with a state
    (decode) the sequential step in plain PyTorch."""
    b, s, d = x.shape
    h, n = num_heads(cfg), cfg.rwkv_head_dim
    xr, xk, xv, xg, xw = _mixes(p, x, _shift(x, shift_state))
    r = torch.matmul(xr, p["wr"]).reshape(b, s, h, n)
    k = torch.matmul(xk, p["wk"]).reshape(b, s, h, n)
    v = torch.matmul(xv, p["wv"]).reshape(b, s, h, n)
    g = torch.matmul(xg, p["wg"])
    logw = _decay(p, xw).reshape(b, s, h, n)
    u = p["u"].reshape(h, n)
    r = with_logical_constraint(r, ("batch", "seq", "heads", None))
    k = with_logical_constraint(k, ("batch", "seq", "heads", None))
    v = with_logical_constraint(v, ("batch", "seq", "heads", None))
    if s == 1 and wkv_state is not None:
        out, final = _wkv_step(r[:, 0].to(F32), k[:, 0].to(F32),
                               v[:, 0].to(F32), logw[:, 0], u, wkv_state)
    else:
        out, final = ops.wkv6(r.to(F32), k.to(F32), v.to(F32), logw, u,
                              wkv_state)
    out = _group_norm(out, p["ln_scale"].to(F32).reshape(h, n))
    out = out.reshape(b, s, d).to(x.dtype) * F.silu(g)
    return torch.matmul(out, p["wo"]), (x[:, -1].to(F32), final)


def channel_mix(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                shift_state=None):
    """Squared-ReLU channel mix with a sigmoid receptance gate
    (``repro/models/rwkv.py:231``): -> (out, new shift state (B, D) f32)."""
    xprev = _shift(x, shift_state)
    mix = p["cm_rk"].to(x.dtype)
    xk = x + (xprev - x) * mix[0]
    xr = x + (xprev - x) * mix[1]
    kk = torch.matmul(xk, p["ck"]).to(F32)
    kk = torch.square(F.relu(kk)).to(x.dtype)
    kk = with_logical_constraint(kk, ("batch", "seq", "ff"))
    vv = torch.matmul(kk, p["cv"]).to(F32)
    rr = torch.sigmoid(torch.matmul(xr, p["cr"]).to(F32))
    return (rr * vv).to(x.dtype), x[:, -1].to(F32)


def init_state(cfg, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero serve state (``repro/models/rwkv.py:247 init_state``)."""
    h, n = num_heads(cfg), cfg.rwkv_head_dim
    return {"tm_shift": torch.zeros((batch, cfg.d_model), dtype=F32,
                                    device=device),
            "cm_shift": torch.zeros((batch, cfg.d_model), dtype=F32,
                                    device=device),
            "wkv": torch.zeros((batch, h, n, n), dtype=F32, device=device)}
