"""Encoder-decoder transformer, the seamless-m4t-medium backbone
(``repro/models/encdec.py``).

The speech frontend is a stub in the reference too: the caller passes
precomputed frame embeddings (B, S_frames, D) for the encoder. The encoder
is pre-norm blocks of non-causal self-attention (rotary positions) and a
gated FFN, then ``enc_ln``; the decoder is pre-norm blocks of causal
self-attention, cross-attention into the encoder memory and a gated FFN,
then ``final_ln`` and the f32 head.

:class:`EncDecLM` is the ``nn.Module`` that owns the parameters, named as
the reference's tree flattened (``repro/models/encdec.py:23-61``):
``embed.table``, ``enc_layers.<i>.{ln1,ln2}.scale``,
``enc_layers.<i>.attn.w{q,k,v,o}``, ``enc_layers.<i>.mlp.w{i,g,o}``,
``dec_layers.<i>.{ln1,ln_x,ln2}.scale``,
``dec_layers.<i>.{self_attn,cross_attn}.w{q,k,v,o}``,
``dec_layers.<i>.mlp.w{i,g,o}``, ``enc_ln.scale``, ``final_ln.scale`` and
``lm_head.w``. The reference stacks each stack on a leading layers axis for
``lax.scan``; here each layer is its own module and the stacks are Python
loops. Neither stack is checkpointed, whatever ``cfg.remat`` says: the
reference scans both without ``jax.checkpoint``.

Attention runs ``attention.self_attention`` (the encoder non-causal, the
decoder causal) and ``attention.cross_attention``: on the card K2 in all
three, outside ``attn_impl="naive"``.

Serving: :func:`prefill` encodes the frames once, precomputes each decoder
layer's cross-attention K/V (:func:`encode_memory_kv`, a list of one (k, v)
pair per decoder layer, each (B, Sm, Hkv, hd), where the reference stacks
them to (L, B, Sm, Hkv, hd)) and fills the decoder's self-attention caches
(a list of one ``attention.init_cache`` dict per layer); :func:`decode_step`
advances them one token. ``convert.memory_kv_from_jax`` /
``memory_kv_to_numpy`` and ``caches_from_jax`` / ``caches_to_numpy``
translate the layouts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from . import attention, blocks, common, mlp, transformer
from .blocks import EMBED
from .partitioning import with_logical_constraint

MemoryKV = List[Tuple[torch.Tensor, torch.Tensor]]


class EncBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        self.ln1 = blocks.RMSNorm(d, dt, device)
        self.attn = blocks.Attention(cfg, generator, device)
        self.ln2 = blocks.RMSNorm(d, dt, device)
        self.mlp = blocks.MLP(cfg, generator, device)


class DecBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        self.ln1 = blocks.RMSNorm(d, dt, device)
        self.self_attn = blocks.Attention(cfg, generator, device)
        self.ln_x = blocks.RMSNorm(d, dt, device)
        self.cross_attn = blocks.Attention(cfg, generator, device)
        self.ln2 = blocks.RMSNorm(d, dt, device)
        self.mlp = blocks.MLP(cfg, generator, device)


class EncDecLM(nn.Module):
    """``cfg.encoder_layers`` encoder and ``cfg.num_layers`` decoder layers
    (``repro/models/encdec.py:47 init_params``), drawn from ``generator``
    (whose device must be ``device``)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        pv, d, dt = transformer.padded_vocab(cfg), cfg.d_model, cfg.torch_dtype
        self.cfg = cfg
        self.embed = transformer.Embedding(pv, d, dt, generator, device)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, generator, device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecBlock(cfg, generator, device) for _ in range(cfg.num_layers))
        self.enc_ln = blocks.RMSNorm(d, dt, device)
        self.final_ln = blocks.RMSNorm(d, dt, device)
        self.lm_head = transformer.Readout(d, pv, dt, generator, device)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def param_axes(cfg) -> Dict[str, tuple]:
    """The logical axes of every parameter, keyed as ``EncDecLM``'s
    (``repro/models/encdec.py:64-96``, the stacks' ``"layers"`` dropped)."""
    attn = attention.param_axes(cfg)
    cross = attention.param_axes(cfg, cross=True)
    ffn = mlp.param_axes(cfg)
    enc = {"ln1.scale": (None,), "ln2.scale": (None,),
           **{f"attn.{k}": v for k, v in attn.items()},
           **{f"mlp.{k}": v for k, v in ffn.items()}}
    dec = {"ln1.scale": (None,), "ln_x.scale": (None,), "ln2.scale": (None,),
           **{f"self_attn.{k}": v for k, v in attn.items()},
           **{f"cross_attn.{k}": v for k, v in cross.items()},
           **{f"mlp.{k}": v for k, v in ffn.items()}}
    axes = {"embed.table": ("p_vocab", "p_fsdp"), "enc_ln.scale": (None,),
            "final_ln.scale": (None,), "lm_head.w": ("p_fsdp", "p_vocab")}
    for i in range(cfg.encoder_layers):
        axes.update({f"enc_layers.{i}.{k}": v for k, v in enc.items()})
    for i in range(cfg.num_layers):
        axes.update({f"dec_layers.{i}.{k}": v for k, v in dec.items()})
    return axes


def cache_axes(cfg):
    """The decoder self-attention caches' logical axes, one dict a layer."""
    return [attention.cache_axes(cfg) for _ in range(cfg.num_layers)]


def encode(cfg, params: Dict[str, torch.Tensor],
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S, D) -> encoder memory (B, S, D) in the model dtype
    (``repro/models/encdec.py:103 encode``)."""
    x = with_logical_constraint(frames.to(cfg.torch_dtype), EMBED)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.encoder_layers):
        p = blocks.sub(params, f"enc_layers.{i}.")
        ap = blocks.sub(p, "attn.")
        h = common.rmsnorm_apply(p["ln1.scale"], x, cfg.norm_eps)
        q, k, v = attention.qkv(cfg, ap, h, positions)
        a = attention.self_attention(cfg, q, k, v, causal=False, window=0)
        x = x + attention.out_proj(ap, a)
        h = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
        x = with_logical_constraint(x + mlp.apply(cfg, blocks.sub(p, "mlp."), h),
                                    EMBED)
    return common.rmsnorm_apply(params["enc_ln.scale"], x, cfg.norm_eps)


def encode_memory_kv(cfg, params: Dict[str, torch.Tensor],
                     memory: torch.Tensor) -> MemoryKV:
    """Each decoder layer's cross-attention (k, v), (B, Sm, Hkv, hd) each
    (``repro/models/encdec.py:124 encode_memory_kv``)."""
    out = []
    for i in range(cfg.num_layers):
        ca = blocks.sub(params, f"dec_layers.{i}.cross_attn.")
        out.append((attention._proj(memory, ca["wk"], ca.get("bk")),
                    attention._proj(memory, ca["wv"], ca.get("bv"))))
    return out


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

MODES = ("train", "prefill", "decode")


def _dec_block(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, positions,
               memory_kv, mode: str, cache):
    """One decoder layer (``repro/models/encdec.py:141 _dec_block``) ->
    (x, cache): causal self-attention (a decode step against ``cache``; a
    prefill fills it, in place), cross-attention into ``memory_kv`` (k, v),
    the FFN."""
    mk, mv = memory_kv
    sp = blocks.sub(p, "self_attn.")
    h = common.rmsnorm_apply(p["ln1.scale"], x, cfg.norm_eps)
    if mode == "decode":
        a, cache = attention.decode_attention(cfg, sp, h, cache)
        x = x + a
    else:
        q, k, v = attention.qkv(cfg, sp, h, positions)
        a = attention.self_attention(cfg, q, k, v, causal=True, window=0)
        x = x + attention.out_proj(sp, a)
        if mode == "prefill":
            cache = attention.fill_cache(cache, k, v)
    hx = common.rmsnorm_apply(p["ln_x.scale"], x, cfg.norm_eps)
    x = x + attention.cross_attention(cfg, blocks.sub(p, "cross_attn."), hx,
                                      mk, mv)
    h2 = common.rmsnorm_apply(p["ln2.scale"], x, cfg.norm_eps)
    x = x + mlp.apply(cfg, blocks.sub(p, "mlp."), h2)
    return with_logical_constraint(x, EMBED), cache


def decode_stack(cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 memory: Optional[torch.Tensor], *, mode: str = "train",
                 caches=None, memory_kv: Optional[MemoryKV] = None):
    """tokens (B, S) against the encoder ``memory`` (or its precomputed
    ``memory_kv``) -> (logits (B, S, padded_vocab) f32, caches)
    (``repro/models/encdec.py:161 decode_stack``). ``mode`` "train" takes
    no caches and returns None for them; "prefill" fills ``caches`` from
    the prompt; "decode" advances them one token, each layer's position
    read from its cache. Caches are updated in place."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    x = torch.nn.functional.embedding(tokens.long(), params["embed.table"])
    b, s = x.shape[:2]
    positions = (None if mode == "decode" else
                 torch.arange(s, device=x.device).expand(b, s))
    if memory_kv is None:
        memory_kv = encode_memory_kv(cfg, params, memory)
    if mode != "train" and (caches is None or len(caches) != cfg.num_layers):
        raise ValueError(f"mode {mode!r} needs one cache per decoder layer")
    for i in range(cfg.num_layers):
        x, cache = _dec_block(cfg, blocks.sub(params, f"dec_layers.{i}."), x,
                              positions, memory_kv[i], mode,
                              None if mode == "train" else caches[i])
        if mode != "train":
            caches[i] = cache
    return transformer._logits(cfg, params, x), caches


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def loss_fn(cfg, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    """batch: {frames (B, Sf, D), tokens (B, St), labels (B, St), [mask]}
    -> scalar mean cross-entropy (``repro/models/encdec.py:206 loss_fn``)."""
    memory = encode(cfg, params, batch["frames"])
    logits, _ = decode_stack(cfg, params, batch["tokens"], memory)
    return common.softmax_cross_entropy(logits, batch["labels"],
                                        batch.get("mask"))


def init_caches(cfg, batch: int, max_len: int, *, device=None):
    """One zero self-attention cache per decoder layer
    (``repro/models/encdec.py:213 init_caches``)."""
    return [attention.init_cache(cfg, batch, max_len, device=device)
            for _ in range(cfg.num_layers)]


def prefill(cfg, params: Dict[str, torch.Tensor], frames: torch.Tensor,
            tokens: torch.Tensor, *, max_len: Optional[int] = None):
    """frames (B, Sf, D) and a prompt (B, S) -> (last logits (B, V) f32,
    caches sized for ``max_len`` positions (default S), memory_kv)
    (``repro/models/encdec.py:220 prefill``)."""
    memory = encode(cfg, params, frames)
    memory_kv = encode_memory_kv(cfg, params, memory)
    b, s = tokens.shape
    caches = init_caches(cfg, b, max_len or s, device=tokens.device)
    logits, caches = decode_stack(cfg, params, tokens, memory, mode="prefill",
                                  caches=caches, memory_kv=memory_kv)
    return logits[:, -1], caches, memory_kv


def decode_step(cfg, params: Dict[str, torch.Tensor], token: torch.Tensor,
                caches, memory_kv: MemoryKV):
    """token (B, 1) -> (logits (B, V) f32, caches advanced one position)
    (``repro/models/encdec.py:233 decode_step``)."""
    logits, caches = decode_stack(cfg, params, token, None, mode="decode",
                                  caches=caches, memory_kv=memory_kv)
    return logits[:, -1], caches
