"""GQA self-attention, train mode (``repro/models/attention.py``).

Parameters: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D), as in the
reference. ``self_attention`` dispatches on ``cfg.attn_impl``:

* ``naive``: scores in f32, additive mask, softmax, probabilities cast to
  v's dtype for the value product (the reference's ``naive_attention``,
  plain PyTorch: it is not a kernel);
* ``blocked``/``flash``: the reference runs ``flash_attention_xla``, an
  online-softmax scan over (q_block, kv_block) pairs in f32 with an XLA
  backward from the saved logsumexp. Here both go to
  ``kernels.ops.flash_attention``: on the card the K2 kernels (forward,
  and a backward of two kernels), on the CPU their plain versions. The
  kernels tile by 64 rows whatever ``q_block``/``kv_block`` say; the
  result differs from the reference's only in the order of f32 sums.

Left out for later slices: decode/prefill/chunk modes and KV caches,
cross-attention, qkv bias.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..kernels import ops, ref
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


def naive_attention(q, k, v, *, causal=True, window=0):
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(F32) * (1.0 / math.sqrt(hd))
    ok = ref.visible_mask(sq, skv, causal, window, q.device)
    s = s + torch.where(ok, 0.0, NEG_INF).to(F32)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def self_attention(cfg, q, k, v, *, causal=True, window=0):
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if cfg.attn_impl in ("blocked", "flash"):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"attn_impl {cfg.attn_impl!r} is not ported")
