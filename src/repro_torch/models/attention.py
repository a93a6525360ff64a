"""GQA self-attention, train mode (``repro/models/attention.py``).

Parameters: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D), as in the
reference. ``self_attention`` dispatches on ``cfg.attn_impl``:

* ``naive``: scores in f32, additive mask, softmax, probabilities cast to
  v's dtype for the value product (the reference's ``naive_attention``);
* ``blocked``/``flash``: the reference runs ``flash_attention_xla`` (an
  online-softmax scan over (q_block, kv_block) pairs in f32 with an XLA
  backward). At lm_350m's seq 512 that is a single block pair, i.e. exact
  f32-softmax attention, which :func:`exact_attention` writes out in plain
  PyTorch (matmul, mask, f32 softmax, matmul, cast to q's dtype);
  autograd gives the backward. At longer sequences the two differ only in
  the order of the softmax sums. ``scaled_dot_product_attention`` is not
  used: the flash kernel (the reference's Pallas K2) comes in a later slice.

Left out for later slices: decode/prefill/chunk modes and KV caches,
cross-attention, local windows beyond the mask, qkv bias.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import common

F32 = torch.float32
NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, H, K) -> (B, S, H, K) in x's dtype."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], attn_out: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    flat = attn_out.reshape(*attn_out.shape[:-2], h * k)
    return torch.matmul(flat, p["wo"].reshape(h * k, d))


def _visible(sq: int, skv: int, causal: bool, window: int, device):
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window and window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def naive_attention(q, k, v, *, causal=True, window=0):
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(F32) * (1.0 / math.sqrt(hd))
    ok = _visible(sq, skv, causal, window, q.device)
    s = s + torch.where(ok, 0.0, NEG_INF).to(F32)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def exact_attention(q, k, v, *, causal=True, window=0):
    """Exact f32-softmax attention: the one-block case of the reference's
    ``flash_attention_xla`` (f32 scores, masked to -1e30, max-shifted exp,
    normalized by the row sum floored at 1e-30), cast to q's dtype."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd).to(F32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32)) * (1.0 / math.sqrt(hd))
    ok = _visible(sq, skv, causal, window, q.device)
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(F32))
    out = out / torch.clamp_min(l, 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


def self_attention(cfg, q, k, v, *, causal=True, window=0):
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if cfg.attn_impl in ("blocked", "flash"):
        return exact_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"attn_impl {cfg.attn_impl!r} is not ported")
