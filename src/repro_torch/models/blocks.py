"""Transformer blocks (``repro/models/blocks.py``), train mode.

``block_apply(cfg, kind, p, x, positions)`` with ``kind`` "attention" or
"recurrent" and ``p`` the block's parameters keyed ``ln1.scale``,
``attn.wq`` ... (attention) or ``rec.w_in`` ... (recurrent), then
``ln2.scale`` and ``mlp.wi`` ... (the names of :class:`Block`). Both kinds
are pre-norm residual blocks with a gated MLP. A local window applies to
attention layers only.
Left out for later slices: RWKV blocks, MoE FFNs, and the
prefill/decode/chunk modes with their caches.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import attention, common, mlp, rglru


def sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def layer_kinds(cfg):
    """Per-layer block kinds: the hybrid family repeats ``block_pattern``."""
    if cfg.family == "dense":
        return ["attention"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    raise NotImplementedError(
        f"repro_torch ports the dense and hybrid families; {cfg.name} is "
        f"{cfg.family}"
    )


def block_apply(cfg, kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    h = common.rmsnorm_apply(p["ln1.scale"], x, cfg.norm_eps)
    if kind == "attention":
        window = cfg.window_size if cfg.attention == "local" else 0
        ap = sub(p, "attn.")
        q, k, v = attention.qkv(cfg, ap, h, positions)
        attn = attention.self_attention(cfg, q, k, v, causal=True,
                                        window=window)
        x = x + attention.out_proj(ap, attn)
    elif kind == "recurrent":
        x = x + rglru.apply(cfg, sub(p, "rec."), h)
    else:
        raise ValueError(f"block kind {kind!r} is not ported")
    h2 = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
    return x + mlp.apply(cfg, sub(p, "mlp."), h2)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class Attention(nn.Module):
    """QKV/O projections: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if cfg.qkv_bias:
            raise NotImplementedError("qkv_bias is not ported")
        dt = cfg.torch_dtype
        init = lambda shape, std=None: nn.Parameter(common.normal_init(
            generator, shape, dt, std, device=device))
        self.wq = init((d, hq, hd))
        self.wk = init((d, hkv, hd))
        self.wv = init((d, hkv, hd))
        self.wo = init((hq, hd, d), 1.0 / (hq * hd) ** 0.5)


class MLP(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        init = lambda shape: nn.Parameter(common.normal_init(
            generator, shape, dt, device=device))
        self.wi = init((d, f))
        self.wg = init((d, f))
        self.wo = init((f, d))


class Block(nn.Module):
    """One layer of ``kind`` "attention" (``attn``) or "recurrent" (``rec``)."""

    def __init__(self, cfg, kind: str, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.torch_dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.torch_dtype, device)
        if kind == "attention":
            self.attn = Attention(cfg, generator, device)
        elif kind == "recurrent":
            self.rec = rglru.RGLRU(cfg, generator, device)
        else:
            raise ValueError(f"block kind {kind!r} is not ported")
        self.mlp = MLP(cfg, generator, device)
