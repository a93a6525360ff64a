"""Transformer blocks (``repro/models/blocks.py``): train, prefill, decode
and chunked prefill.

``block_apply(cfg, kind, p, x, positions)`` with ``kind`` "attention",
"recurrent" or "rwkv" and ``p`` the block's parameters keyed ``ln1.scale``,
``attn.wq`` ... (attention), ``rec.w_in`` ... (recurrent) or ``tm.wr`` ...
(rwkv), then ``ln2.scale`` and, but for rwkv, the FFN: ``mlp.wi`` ... or,
in the MoE family, ``moe.router`` ... (the names of :class:`Block`).
Attention and recurrent blocks are pre-norm residual blocks with a gated
FFN; an rwkv block is ln1, time mix, residual, ln2, channel mix, residual,
with no FFN. A local window applies to attention layers only.

Train mode returns ``(x, aux)``, the FFN's load-balancing loss (a () f32
tensor of an MoE block, 0.0 for the others), as the reference's
``(x, aux_loss, cache)`` (``repro/models/blocks.py:95-184``). ``mode``
"prefill", "decode" or "chunk" takes the block's ``cache``
(:func:`block_cache_init`: an attention KV cache, an RG-LRU state or an
RWKV state) and returns ``(x, cache)``, the cache updated in place:
"prefill" fills a fresh cache from a prompt, "decode" advances it one
token, "chunk" (chunked prefill) continues it with a prompt chunk (the
no-ring attention layout); the serve paths drop the aux loss, as the
reference's do. In "decode" an MoE block routes each row's token as its
own group, as the reference's serve steps decode each slot at batch 1
(``launch/steps.py`` says why).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import attention, common, mlp, moe, partitioning, rglru, rwkv
from .partitioning import with_logical_constraint


def sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def layer_kinds(cfg):
    """Per-layer block kinds of a decoder-only stack
    (``repro/models/blocks.py:43-58``): the dense, MoE and VLM families are
    all attention, the hybrid family repeats ``block_pattern``, the ssm
    family (RWKV-6) is all rwkv. The encoder-decoder's stacks are
    :mod:`encdec`'s own and do not come here."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its stacks are "
                         f"models/encdec.py's")
    if cfg.family in ("dense", "moe", "vlm"):
        return ["attention"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["rwkv"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    raise ValueError(f"{cfg.name}: unknown decoder family {cfg.family!r}")


MODES = ("train", "prefill", "decode", "chunk")
EMBED = ("batch", "seq", "embed")  # the residual stream's logical axes


def block_axes(cfg, kind: str = "attention"):
    """The logical axes of one block's parameters, keyed as
    :class:`Block`'s (``repro/models/blocks.py:48-61``)."""
    ax = {"ln1.scale": (None,), "ln2.scale": (None,)}
    if kind == "attention":
        ax.update({f"attn.{k}": v for k, v in attention.param_axes(cfg).items()})
    elif kind == "recurrent":
        ax.update({f"rec.{k}": v for k, v in rglru.param_axes(cfg).items()})
    elif kind == "rwkv":
        ax.update({f"tm.{k}": v for k, v in rwkv.param_axes(cfg).items()})
    else:
        raise ValueError(f"block kind {kind!r} is not ported")
    if kind != "rwkv":
        name, ffn = ("moe", moe) if cfg.family == "moe" else ("mlp", mlp)
        ax.update({f"{name}.{k}": v for k, v in ffn.param_axes(cfg).items()})
    return ax


def block_cache_axes(cfg, kind: str):
    """The logical axes of one block's cache (``repro/models/blocks.py:
    79-86``)."""
    if kind == "attention":
        return attention.cache_axes(cfg)
    if kind == "recurrent":
        return rglru.state_axes()
    if kind == "rwkv":
        return rwkv.state_axes()
    raise ValueError(f"block kind {kind!r} is not ported")


def block_cache_init(cfg, kind: str, batch: int, max_len: int, *,
                     ring: bool = True, device=None):
    """A zero cache of one block (``repro/models/blocks.py:64``);
    ``ring=False`` builds the no-ring attention layout (slot == absolute
    position) that chunked prefill and the serve slot pool need."""
    if kind == "attention":
        window = cfg.window_size if cfg.attention == "local" else None
        return attention.init_cache(cfg, batch, max_len, window=window,
                                    ring=ring, device=device)
    if kind == "recurrent":
        return rglru.init_state(cfg, batch, device)
    if kind == "rwkv":
        return rwkv.init_state(cfg, batch, device)
    raise ValueError(f"block kind {kind!r} is not ported")


def _store(cache, new):
    """Write a recurrent block's new state into its cache, in place."""
    for key, value in new.items():
        cache[key].copy_(value)
    return cache


def _ffn(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, route_rows: bool,
         train: bool):
    """The block's FFN: (out, aux loss), aux 0.0 for a dense MLP. An MoE
    layer routes the batch's tokens in ``moe.apply``'s groups, or with
    ``route_rows`` each row as its own group of one token. On rows split
    over ranks the aux loss takes a collective, which the modes that drop
    it skip."""
    if cfg.family == "moe":
        kw = {} if train or partitioning.batch_shards() == 1 else {"aux": False}
        return moe.apply(cfg, sub(p, "moe."), x,
                         group_size=1 if route_rows else None, **kw)
    return mlp.apply(cfg, sub(p, "mlp."), x), 0.0


def block_apply(cfg, kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "train", cache=None,
                route_rows: bool = False):
    """One layer in ``mode`` (``MODES``): ``(x, aux)`` in train mode, else
    ``(x, cache)`` with the cache updated in place. ``route_rows`` (decode
    mode only) routes each row's token through an MoE layer as its own
    group: the serve slot steps' per-slot routing."""
    if route_rows and mode != "decode":
        raise ValueError("route_rows is for decode mode")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    h = common.rmsnorm_apply(p["ln1.scale"], x, cfg.norm_eps)
    if kind == "rwkv":
        tp = sub(p, "tm.")
        states = ({} if mode == "train" else
                  {"shift_state": cache["tm_shift"],
                   "wkv_state": cache["wkv"]})
        tm, (tm_shift, wkv) = rwkv.time_mix(cfg, tp, h, **states)
        x = x + tm
        if mode == "train":
            x = with_logical_constraint(x, EMBED)
        h2 = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
        cm, cm_shift = rwkv.channel_mix(
            cfg, tp, h2, shift_state=None if mode == "train"
            else cache["cm_shift"])
        x = with_logical_constraint(x + cm, EMBED)
        if mode == "train":
            return x, 0.0
        return x, _store(cache, {"tm_shift": tm_shift, "cm_shift": cm_shift,
                                 "wkv": wkv})
    if kind == "attention":
        window = cfg.window_size if cfg.attention == "local" else 0
        ap = sub(p, "attn.")
        if mode == "decode":
            out, cache = attention.decode_attention(cfg, ap, h, cache,
                                                    window=window)
        elif mode == "chunk":
            out, cache = attention.chunk_attention(cfg, ap, h, cache,
                                                   positions, window=window)
        else:
            q, k, v = attention.qkv(cfg, ap, h, positions)
            attn = attention.self_attention(cfg, q, k, v, causal=True,
                                            window=window)
            out = attention.out_proj(ap, attn,
                                     tp=attention.tp_heads(cfg, ap))
            if mode == "prefill":
                cache = attention.fill_cache(cache, k, v, window=window)
        x = x + out
    elif kind == "recurrent":
        rp = sub(p, "rec.")
        if mode == "train":
            x = x + rglru.apply(cfg, rp, h)
        else:
            if mode == "decode":
                out, new = rglru.decode_step(cfg, rp, h, cache)
            else:
                out, new = rglru.prefill(
                    cfg, rp, h, state=cache if mode == "chunk" else None)
            x = x + out
            cache = _store(cache, new)
    else:
        raise ValueError(f"block kind {kind!r} is not ported")
    x = with_logical_constraint(x, EMBED)
    h2 = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
    out, aux = _ffn(cfg, p, h2, route_rows, mode == "train")
    x = with_logical_constraint(x + out, EMBED)
    return (x, aux) if mode == "train" else (x, cache)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class Attention(nn.Module):
    """QKV/O projections: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D),
    and with ``cfg.qkv_bias`` the biases bq (Hq, hd), bk/bv (Hkv, hd)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.torch_dtype
        init = lambda shape, std=None: nn.Parameter(common.normal_init(
            generator, shape, dt, std, device=device))
        self.wq = init((d, hq, hd))
        self.wk = init((d, hkv, hd))
        self.wv = init((d, hkv, hd))
        self.wo = init((hq, hd, d), 1.0 / (hq * hd) ** 0.5)
        if cfg.qkv_bias:  # zeros, as the reference's
            zeros = lambda shape: nn.Parameter(  # noqa: E731
                torch.zeros(shape, dtype=dt, device=device))
            self.bq = zeros((hq, hd))
            self.bk = zeros((hkv, hd))
            self.bv = zeros((hkv, hd))


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
    "rwkv" (``tm``, which holds the channel mix too, and no FFN); the FFN is
    ``moe`` in the MoE family, else ``mlp``."""

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
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg, generator, device)
        else:
            self.mlp = MLP(cfg, generator, device)
