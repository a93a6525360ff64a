"""GQA self-attention (``repro/models/attention.py``): train, prefill,
decode and chunked prefill; and the encoder-decoder's cross-attention.

Parameters: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D) and, with
``cfg.qkv_bias``, bq (Hq, hd) and bk/bv (Hkv, hd), as in the reference:
each bias is added to its projection in the activation dtype, before
rotary embeddings. ``self_attention`` dispatches on ``cfg.attn_impl``:

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

The serve paths keep a KV cache per attention layer, ``{"k", "v"}``
(B, size, Hkv, hd) in the model dtype and ``"pos"``, the absolute position
of the next token (an int32 scalar, or one per batch row in the serve slot
pool): :func:`init_cache` (the ring layout for a local window, or the
no-ring layout chunked prefill needs), :func:`fill_cache` (prefill, whose
attention is ``self_attention``: K2 on the card), :func:`decode_attention`
and :func:`chunk_attention`. The reference computes those two as XLA
einsums outside any Pallas kernel, and so does the port, in plain PyTorch
with the reference's masks (``NEG_INF``, the ring slot ``pos % size``, the
window as an explicit mask on the no-ring layout); the scores are f32
products of f32 copies, as the reference's ``preferred_element_type``.
The caches are written in place and returned (the counterpart of the
reference's donated caches); their positions may differ per batch row, so
a batch of slots decodes each row at its own position.

:func:`cross_attention` (``repro/models/attention.py:711-727``) attends
the decoder's queries to precomputed encoder memory K/V, with no rotary
embedding on either side and no mask: ``naive_attention(causal=False)``
under ``attn_impl="naive"``, else K2 non-causal in every mode, a decode
step's single query included (the reference runs ``blocked_attention``
there, an XLA scan outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..kernels import ops, ref
from . import common

F32 = torch.float32
NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """(B, S, D) @ (D, H, K) [+ b (H, K)] -> (B, S, H, K) in x's dtype."""
    d, h, k = w.shape
    out = torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
    return out if b is None else out + b.to(out.dtype)


def qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor):
    q = _proj(x, p["wq"], p.get("bq"))
    k = _proj(x, p["wk"], p.get("bk"))
    v = _proj(x, p["wv"], p.get("bv"))
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


def cross_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    memory_k: torch.Tensor, memory_v: torch.Tensor):
    """x (B, Sq, D) attends to the encoder memory's K/V (B, Sm, Hkv, hd)
    -> (B, Sq, D) (``repro/models/attention.py:711 cross_attention``)."""
    q = _proj(x, p["wq"], p.get("bq"))
    if cfg.attn_impl == "naive":
        out = naive_attention(q, memory_k, memory_v, causal=False, window=0)
    elif cfg.attn_impl in ("blocked", "flash"):
        out = ops.flash_attention(q, memory_k, memory_v, causal=False,
                                  window=0)
    else:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not ported")
    return out_proj(p, out)


# ---------------------------------------------------------------------------
# KV caches: prefill, decode and chunked prefill
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, *, window=None,
               ring: bool = True, device=None) -> Dict[str, torch.Tensor]:
    """A zero cache (``repro/models/attention.py:541 init_cache``). With a
    local ``window`` and ``ring`` it is a ring buffer of ``min(window,
    max_len)`` slots; ``ring=False`` gives the no-ring layout (``max_len``
    slots, slot index == absolute position) that chunked prefill writes and
    the serve slot pool holds, the window then applied as a mask."""
    size = min(window, max_len) if (window and ring) else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def fill_cache(cache, k: torch.Tensor, v: torch.Tensor, *, window: int = 0):
    """Prefill: write a whole prefix k, v (B, S, Hkv, hd) into the cache, in
    place (``repro/models/attention.py:577 fill_cache``). A ring keeps the
    last ``size`` positions, position p at slot p % size."""
    size, s = cache["k"].shape[1], k.shape[1]
    if window and s > size:
        k, v, write, start = k[:, -size:], v[:, -size:], size, s - size
    else:
        write = min(s, size)
        k, v, start = k[:, :write], v[:, :write], 0
    slots = (start + torch.arange(write, device=k.device)) % size
    cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
    cache["pos"].fill_(s)
    return cache


def _cached_attention(cfg, q, ck, cv, ok):
    """q (B, C, Hq, hd) against the whole cache (B, size, Hkv, hd): f32
    scores of f32 copies, ``NEG_INF`` where ``ok`` (B, C, size) is false,
    softmax, probabilities in v's dtype -> (B, C, Hq, hd)."""
    b, c, hq, hd = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32), ck.to(F32)) * (
        1.0 / math.sqrt(hd))
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(cv.dtype), cv)
    return out.reshape(b, c, hq, hd)


def decode_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, cache,
                     *, window: int = 0):
    """One decode step (``repro/models/attention.py:601 decode_attention``):
    x (B, 1, D) -> (out (B, 1, D), cache), the token's k and v written at
    each row's slot and ``pos`` advanced, in place. ``pos`` is a scalar or
    one per row (the slot pool), so every row attends over its own
    positions."""
    b = x.shape[0]
    pos = cache["pos"].to(torch.int64).expand(b)
    q, k, v = qkv(cfg, p, x, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    # a ring buffer (size == window: recency by overwrite) or one slot per
    # absolute position (the no-ring layout, the window as a mask)
    ring = bool(window) and size == window
    slot = pos % size if ring else torch.clamp(pos, max=size - 1)
    rows = torch.arange(b, device=x.device)
    ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
    cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
    idx = torch.arange(size, device=x.device)
    ok = idx[None] < torch.clamp(pos + 1, max=size)[:, None]
    if window and not ring:
        ok = ok & (idx[None] > (pos - window)[:, None])
    out = _cached_attention(cfg, q, ck, cv, ok[:, None])
    cache["pos"].add_(1)
    return out_proj(p, out), cache


def chunk_attention(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, cache,
                    positions: torch.Tensor, *, window: int = 0):
    """Chunked-prefill continuation (``repro/models/attention.py:650
    chunk_attention``): C prompt tokens x (B, C, D) at ``positions`` (B, C)
    against a no-ring cache whose ``pos`` (a scalar) is the chunk's first
    position. Writes the chunk's k and v at [pos, pos + C), attends each
    query over the cached positions <= its own (the window as a mask) and
    advances ``pos`` by C, in place."""
    c = x.shape[1]
    q, k, v = qkv(cfg, p, x, positions)
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    pos0 = cache["pos"].to(torch.int64)
    q_pos = pos0 + torch.arange(c, device=x.device)
    ck.index_copy_(1, q_pos, k.to(ck.dtype))
    cv.index_copy_(1, q_pos, v.to(cv.dtype))
    idx = torch.arange(size, device=x.device)
    ok = idx[None] <= q_pos[:, None]
    if window and window > 0:
        ok = ok & (idx[None] > (q_pos[:, None] - window))
    out = _cached_attention(cfg, q, ck, cv, ok[None])
    cache["pos"].add_(c)
    return out_proj(p, out), cache
