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

Tensor parallelism (``models/partitioning.py``): :func:`param_axes`,
:func:`head_logical_axes` and :func:`cache_axes` are the reference's,
sized for its production model axis of 16 (``attention.py:56``). Where a
step kept the rank's query heads (``wq`` (D, Hq/m, hd), ``wo`` (Hq/m, hd,
D)), :func:`qkv` enters a tensor-parallel region and K2 runs on the
rank's heads alone; the kv heads are the rank's own where ``wk`` kept
them, else every rank computes them all and :func:`local_kv` takes those
its query heads read. :func:`out_proj` sums the ranks' f32 partial
products over ``"model"``. The caches follow the same layout.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..kernels import ops, ref
from . import common, partitioning
from .partitioning import with_logical_constraint

F32 = torch.float32
NEG_INF = -1e30


# the reference's production model axis (``repro/models/attention.py:56,
# 561``): its axes depend on it, not on the mesh at hand
_MODEL_AXIS = 16


def _shard_heads(cfg) -> bool:
    """Shard attention over heads when divisible, else over head_dim."""
    return cfg.num_heads % _MODEL_AXIS == 0


def head_logical_axes(cfg, kv: bool = False):
    """The logical axes of q's (or k's and v's) head and head-dim dims
    (``repro/models/attention.py:65-76``)."""
    if _shard_heads(cfg):
        if not kv:
            return ("heads", None)
        if cfg.num_kv_heads % _MODEL_AXIS == 0:
            return ("kv_heads", None)
        return (None, None)
    return (None, "kv_head_dim")


def param_axes(cfg, cross: bool = False):
    if _shard_heads(cfg):
        h, hd = "p_heads", "p_head_dim"
    else:
        h, hd = None, "kv_head_dim"
    kvh = "p_kv_heads" if cfg.num_kv_heads % _MODEL_AXIS == 0 else None
    kvd = "p_head_dim" if kvh else "kv_head_dim"
    axes = {"wq": ("p_fsdp", h, hd), "wk": ("p_fsdp", kvh, kvd),
            "wv": ("p_fsdp", kvh, kvd), "wo": (h, hd, "p_fsdp")}
    if cfg.qkv_bias:
        axes["bq"] = (h, hd)
        axes["bk"] = (kvh, kvd)
        axes["bv"] = (kvh, kvd)
    return axes


def cache_logical_axes(cfg):
    """KV-cache sharding: kv heads over the model axis when divisible, else
    head_dim (``repro/models/attention.py:564-569``)."""
    if cfg.num_kv_heads and cfg.num_kv_heads % _MODEL_AXIS == 0:
        return ("kv_batch", "seq", "kv_heads", None)
    return ("kv_batch", "seq", None, "kv_head_dim")


def cache_axes(cfg):
    kv = cache_logical_axes(cfg)
    return {"k": kv, "v": kv, "pos": ()}


def tp_heads(cfg, p: Dict[str, torch.Tensor]) -> bool:
    """Whether ``p`` holds the rank's query heads (the step's layout kept
    them: ``partitioning.local_block``)."""
    return partitioning.local_block(cfg, p["wq"], 1, param_axes(cfg)["wq"][1],
                                    cfg.num_heads)


def tp_kv_heads(cfg, p: Dict[str, torch.Tensor]) -> bool:
    """Whether ``p`` holds the rank's kv heads."""
    return partitioning.local_block(cfg, p["wk"], 1, param_axes(cfg)["wk"][1],
                                    cfg.num_kv_heads)


def _proj(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """(B, S, D) @ (D, H, K) [+ b (H, K)] -> (B, S, H, K) in x's dtype."""
    d, h, k = w.shape
    out = torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
    return out if b is None else out + b.to(out.dtype)


def qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor):
    """q, k, v (B, S, H, hd) with rotary embeddings; the rank's heads of
    each where ``p`` holds them (entering a tensor-parallel region)."""
    tp = tp_heads(cfg, p)
    xq = partitioning.enter(x) if tp else x
    xk = xq if tp_kv_heads(cfg, p) else x
    q = _proj(xq, p["wq"], p.get("bq"))
    k = _proj(xk, p["wk"], p.get("bk"))
    v = _proj(xk, p["wv"], p.get("bv"))
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    qh, kvh = head_logical_axes(cfg), head_logical_axes(cfg, kv=True)
    q = with_logical_constraint(q, ("batch", "seq") + qh)
    k = with_logical_constraint(k, ("batch", "seq") + kvh)
    v = with_logical_constraint(v, ("batch", "seq") + kvh)
    return q, k, v


def local_kv(cfg, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """The kv heads (B, S, Hkv_l, hd) that the rank's query heads ``q``
    (B, Sq, Hq_l, hd) read, from ``kv`` holding every kv head (computed
    whole on every rank); ``kv`` itself when it is the rank's already or
    the heads are not split."""
    hq_l, hkv = q.shape[2], kv.shape[2]
    if hq_l == cfg.num_heads or hkv != cfg.num_kv_heads:
        return kv
    g = cfg.num_heads // cfg.num_kv_heads
    if hq_l % g and g % hq_l:
        raise ValueError(f"{hq_l} query heads a rank do not share whole "
                         f"kv heads (group {g})")
    first = partitioning.model_index() * hq_l // g
    return partitioning.enter(kv).narrow(2, first, max(hq_l // g, 1))


def out_proj(p: Dict[str, torch.Tensor], attn_out: torch.Tensor, *,
             tp: bool = False) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, D); with ``tp`` the rank's heads' f32
    partial products summed over ``"model"``."""
    h, k, d = p["wo"].shape
    flat = attn_out.reshape(*attn_out.shape[:-2], h * k)
    if tp:
        return partitioning.reduce_sum(common.matmul_f32(
            flat, p["wo"].reshape(h * k, d))).to(attn_out.dtype)
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
    k, v = local_kv(cfg, q, k), local_kv(cfg, q, v)
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
    kv_axes = cache_logical_axes(cfg)
    ck = with_logical_constraint(ck, kv_axes)
    cv = with_logical_constraint(cv, kv_axes)
    idx = torch.arange(size, device=x.device)
    ok = idx[None] < torch.clamp(pos + 1, max=size)[:, None]
    if window and not ring:
        ok = ok & (idx[None] > (pos - window)[:, None])
    out = _cached_attention(cfg, q, local_kv(cfg, q, ck),
                            local_kv(cfg, q, cv), ok[:, None])
    cache["pos"].add_(1)
    return out_proj(p, out, tp=tp_heads(cfg, p)), cache


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
    kv_axes = cache_logical_axes(cfg)
    ck = with_logical_constraint(ck, kv_axes)
    cv = with_logical_constraint(cv, kv_axes)
    idx = torch.arange(size, device=x.device)
    ok = idx[None] <= q_pos[:, None]
    if window and window > 0:
        ok = ok & (idx[None] > (q_pos[:, None] - window))
    out = _cached_attention(cfg, q, local_kv(cfg, q, ck),
                            local_kv(cfg, q, cv), ok[None])
    cache["pos"].add_(c)
    return out_proj(p, out, tp=tp_heads(cfg, p)), cache
