"""Transformer blocks (``repro/models/blocks.py``), train mode.

``block_apply(cfg, kind, p, x, positions)`` with ``kind`` "attention",
"recurrent" or "rwkv" and ``p`` the block's parameters keyed ``ln1.scale``,
``attn.wq`` ... (attention), ``rec.w_in`` ... (recurrent) or ``tm.wr`` ...
(rwkv), then ``ln2.scale`` and, but for rwkv, ``mlp.wi`` ... (the names of
:class:`Block`). Attention and recurrent blocks are pre-norm residual
blocks with a gated MLP; an rwkv block is ln1, time mix, residual, ln2,
channel mix, residual, with no MLP. A local window applies to attention
layers only.
Left out for later slices: MoE FFNs, and the prefill/decode/chunk modes
with their caches and states.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import attention, common, mlp, rglru, rwkv


def sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def layer_kinds(cfg):
    """Per-layer block kinds: the hybrid family repeats ``block_pattern``,
    the ssm family (RWKV-6) is all rwkv."""
    if cfg.family == "dense":
        return ["attention"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["rwkv"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    raise NotImplementedError(
        f"repro_torch ports the dense, hybrid and ssm families; {cfg.name} is "
        f"{cfg.family}"
    )


def block_apply(cfg, kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    h = common.rmsnorm_apply(p["ln1.scale"], x, cfg.norm_eps)
    if kind == "rwkv":
        tp = sub(p, "tm.")
        x = x + rwkv.time_mix(cfg, tp, h)
        h2 = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
        return x + rwkv.channel_mix(cfg, tp, h2)
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
    """One layer of ``kind`` "attention" (``attn``), "recurrent" (``rec``) or
    "rwkv" (``tm``, which holds the channel mix too, and no ``mlp``)."""

    def __init__(self, cfg, kind: str, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.torch_dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.torch_dtype, device)
        if kind == "attention":
            self.attn = Attention(cfg, generator, device)
        elif kind == "recurrent":
            self.rec = rglru.RGLRU(cfg, generator, device)
        elif kind == "rwkv":
            self.tm = rwkv.RWKV(cfg, generator, device)
            return
        else:
            raise ValueError(f"block kind {kind!r} is not ported")
        self.mlp = MLP(cfg, generator, device)
