"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py``).

Each function computes what its kernel computes, op for op, so that the
kernel can be held to it on the card (bitwise for K1, K3 and K4, within
the stated f32/bf16 tolerances for K2 and K5, whose sums run in another
order) and the CPU path can be held to the JAX oracle. The ``ops`` wrappers run these only for CPU tensors.
"""

from __future__ import annotations

import math

import torch


def quantize_ref(x: torch.Tensor):
    """Per-row symmetric int8: (R, C) -> (q int8 (R, C), scale f32 (R, 1)).

    ``scale = max(absmax / 127, 1e-12)``, ``q = clip(round(x / scale),
    -127, 127)`` with round-half-to-even (``torch.round``).

    The reference runs under ``jit``, where XLA compiles ``absmax / 127.0``
    (a division by a constant) as a product with the f32 reciprocal of 127;
    ``x / scale`` stays an IEEE division. This version does the same, so it
    is bitwise to the reference's kernels and jitted oracles.
    """
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scales).to(dtype)


def partial_mean_ref(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis -3 of (..., G, R, C) in f32, summed in order
    g = 0..G-1 and scaled by the f32 reciprocal of G (as the kernels do)."""
    g = x.shape[-3]
    acc = x.select(-3, 0).to(torch.float32)
    for i in range(1, g):
        acc = acc + x.select(-3, i).to(torch.float32)
    return acc * (1.0 / g)


def reduce_compress_ref(x: torch.Tensor):
    """(..., G, R, C) -> ((..., R, C) int8, (..., R, 1) f32): partial mean
    over G then per-row int8 quantization."""
    return quantize_ref(partial_mean_ref(x))


def reduce_compress_roundtrip_ref(x: torch.Tensor):
    """(..., G, R, C) -> (back x.dtype, q int8, s f32): mean + quant +
    dequant, the straight-through value the tagged reduction consumes."""
    q, s = reduce_compress_ref(x)
    return dequantize_ref(q, s, x.dtype), q, s


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add.

    ``a * b`` of an int8-valued and an f32 tensor is exact in f64 (at most
    31 significant bits). Their f64 sum with ``c`` is rounded to odd (the
    exact error of the f64 addition, a two-sum, decides whether to step
    the result off an even last bit), and a value rounded to odd at 53 bits
    rounds to the nearest f32 as the exact sum would: no double rounding.
    """
    prod = a.to(torch.float64) * b.to(torch.float64)
    acc = c.to(torch.float64)
    total = prod + acc
    bb = total - prod
    err = (prod - (total - bb)) + (acc - bb)
    even = (total.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(total)
    toward = torch.where(err > 0, math.inf, -math.inf).to(total)
    total = torch.where(nudge, torch.nextafter(total, toward), total)
    return total.to(torch.float32)


def dequant_accumulate_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """((P, R, C) int8, (P, R, 1) f32) -> (R, C) f32: the mean over P of
    ``q * scale``, as the reference's kernel computes it.

    Not ``sum(q * s) / P``: XLA contracts the reference kernel's product and
    its sum over P into fused multiply-adds (ROADMAP.md R6), so the kernel
    and its jitted oracle compute ``acc = q_0 s_0`` (one rounded product),
    ``acc = fma(q_p, s_p, acc)`` for p = 1..P-1 in order, then ``acc *
    f32(1 / P)``. This version does the same (:func:`fma_f32`), so it is
    bitwise to the interpreted Pallas kernel and to the CUDA kernel.
    """
    p = q.shape[0]
    acc = q[0].to(torch.float32) * scales[0]
    for i in range(1, p):
        acc = fma_f32(q[i], scales[i], acc)
    return acc * (1.0 / p)


# --- K2: flash attention -------------------------------------------------

NEG_INF = -1e30


def visible_mask(sq: int, skv: int, causal: bool, window: int, device):
    """(Sq, Skv) bool: which (query, key) pairs attend. Positions start at
    0 for both, also when Sq != Skv."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window and window > 0:
        ok = ok & (k_pos > q_pos - window)
    return ok


def _scores(q, k, causal, window):
    """f32 scores ``(q . k) * (1 / sqrt(hd))`` in the (B, Hkv, G, Sq, Skv)
    layout, masked to -1e30."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    s = s * (1.0 / math.sqrt(hd))
    ok = visible_mask(sq, skv, causal, window, q.device)
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def _rows(t, hkv):
    """(B, Sq, Hq) -> (B, Hkv, G, Sq, 1), the row layout of the scores."""
    b, sq, hq = t.shape
    return t.reshape(b, sq, hkv, hq // hkv).permute(0, 2, 3, 1)[..., None]


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """GQA attention, ``repro/kernels/ref.py:flash_attention_ref`` op for
    op: f32 scores times the f32 scale (as the Pallas kernel and
    ``flash_attention_xla`` multiply), masked to -1e30, softmax, f32 value
    product. Query head ``i`` reads kv head ``i // G``.

    q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (out in q's dtype, out in
    f32, logsumexp L (B, Sq, Hq) f32). ``L = m + log(max(l, 1e-30))`` with
    m the row max and l the row sum of ``exp(s - m)``, as the reference's
    ``_flash_fwd_core``; the backward reads it and the f32 output.
    """
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    s = _scores(q, k, causal, window)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    w = e / l
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    out = out.reshape(b, sq, hq, hd).contiguous()
    lse = m + torch.log(torch.clamp_min(l, 1e-30))  # (B, Hkv, G, Sq, 1)
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(b, sq, hq).contiguous()
    return out.to(q.dtype), out, lse


def _probs_and_dscores(q, k, v, lse, dout, delta, causal, window):
    """``p = exp(s - L)`` and ``ds = p * (dp - D) * scale`` in the
    (B, Hkv, G, Sq, Skv) layout, with ``dp = dout . v`` (f32)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    p = torch.exp(_scores(q, k, causal, window) - _rows(lse, hkv))
    do = dout.to(torch.float32).reshape(b, sq, hkv, hq // hkv, hd)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.to(torch.float32))
    ds = p * (dp - _rows(delta, hkv)) * (1.0 / math.sqrt(hd))
    return p, ds, do


def flash_attention_bwd_dq_ref(q, k, v, out32, lse, dout, *, causal=True,
                               window=0):
    """The dq half of ``flash_attention_xla``'s backward
    (``repro/models/attention.py:_flash_bwd_rule``) without the block scan.
    Returns (dq in q's dtype, D (B, Sq, Hq) f32) with
    ``D = rowsum(f32(dout) * out32)`` from the f32 forward output."""
    b, sq, hq, hd = q.shape
    delta = torch.sum(dout.to(torch.float32) * out32, dim=-1)
    _, ds, _ = _probs_and_dscores(q, k, v, lse, dout, delta, causal, window)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(torch.float32))
    return dq.reshape(b, sq, hq, hd).to(q.dtype), delta


def flash_attention_bwd_dkdv_ref(q, k, v, lse, delta, dout, *, causal=True,
                                 window=0):
    """The dk/dv half of the same backward, given D from
    :func:`flash_attention_bwd_dq_ref`: sums over the G query heads of each
    kv head. Returns (dk in k's dtype, dv in v's dtype)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    p, ds, do = _probs_and_dscores(q, k, v, lse, dout, delta, causal, window)
    qg = q.reshape(b, sq, hkv, hq // hkv, hd).to(torch.float32)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out32, lse, dout, *, causal=True,
                            window=0):
    """Both halves: (dq, dk, dv) in the input dtypes."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, out32, lse, dout,
                                           causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkdv_ref(q, k, v, lse, delta, dout,
                                          causal=causal, window=window)
    return dq, dk, dv


# --- K4: the RG-LRU linear recurrence ------------------------------------


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """Sequential ``h_t = a_t * h_{t-1} + b_t`` over axis 1 of (B, S, W):
    ``repro/kernels/ref.py:lru_scan_ref`` with the optional initial state
    ``h0`` (B, W) of ``repro/models/rglru.py:lru_scan``. The state is f32;
    each step rounds the product, then the sum (no fused multiply-add);
    the output is in ``a``'s dtype. Differentiable (autograd through the
    loop)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = (torch.zeros_like(a32[:, 0]) if h0 is None
         else h0.to(torch.float32))
    hs = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def lru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                     h0=None):
    """The gradient of :func:`lru_scan_ref` as a reverse scan, in f32:

        dh_t = g_t + a_{t+1} * dh_{t+1}   (dh_S = 0)
        db_t = dh_t,  da_t = dh_t * h_{t-1}   (h_{-1} = h0, or 0)
        dh0  = a_0 * dh_0

    ``h`` is the forward's output, ``g`` the gradient of the loss with
    respect to it. Returns (da in ``a``'s dtype, db in ``a``'s dtype, dh0
    f32 (B, W))."""
    a32, h32, g32 = (t.to(torch.float32) for t in (a, h, g))
    s = a.shape[1]
    dh = torch.zeros_like(a32[:, 0])
    a_next = torch.zeros_like(dh)
    das, dbs = [None] * s, [None] * s
    for t in range(s - 1, -1, -1):
        dh = g32[:, t] + a_next * dh
        if t > 0:
            h_prev = h32[:, t - 1]
        elif h0 is not None:
            h_prev = h0.to(torch.float32)
        else:
            h_prev = torch.zeros_like(dh)
        das[t], dbs[t] = dh * h_prev, dh
        a_next = a32[:, t]
    dh0 = a_next * dh
    return (torch.stack(das, dim=1).to(a.dtype),
            torch.stack(dbs, dim=1).to(a.dtype), dh0)


# --- K5: the RWKV-6 WKV recurrence ---------------------------------------

WKV_CHUNK = 64  # the K5 kernels' chunk: the forward saves S at each start


def wkv6_fwd_ref(r, k, v, logw, u, s0=None):
    """Sequential WKV6, ``repro/kernels/ref.py:wkv6_ref`` op for op, in f32,
    from the initial state ``s0`` of ``repro/models/rwkv.py:119
    sequential_wkv(..., state=)`` (zeros when None):

        o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T      (S_{-1} = s0)

    r, k, v, logw (B, S, H, N), u (H, N), s0 (B, H, N, N) -> (out (B, S, H,
    N) f32, states (B, H, ceil(S / 64), N, N) f32, the state entering each
    64-step chunk, which the K5 backward reads, final (B, H, N, N) f32, the
    state after the last step: ``sequential_wkv``'s second result).
    Differentiable (autograd through the loop)."""
    r, k, v, logw = (t.to(torch.float32) for t in (r, k, v, logw))
    b, s, h, n = r.shape
    uu = u.to(torch.float32)[None, :, :, None]
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.to(torch.float32))
    outs, states = [], []
    for t in range(s):
        if t % WKV_CHUNK == 0:
            states.append(S)
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + uu * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(outs, dim=1), torch.stack(states, dim=2), S


def wkv6_ref(r, k, v, logw, u, s0=None):
    """The WKV6 output alone: (B, S, H, N) f32."""
    return wkv6_fwd_ref(r, k, v, logw, u, s0)[0]


def wkv6_bwd_ref(r, k, v, logw, u, dout, s0=None, dfinal=None):
    """The gradient of :func:`wkv6_fwd_ref`'s output and final state as a
    reverse pass over the steps, in f32, with G_t = dL/dS_t (G_{S-1} =
    ``dfinal``, or 0) and w_t = exp(logw_t):

        dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
        dk_t = G_t v_t + u * r_t (v_t . do_t)
        dv_t = G_t^T k_t + (r_t . (u * k_t)) do_t
        dlogw_t = w_t * rowsum(S_{t-1} * G_t)
        du = sum over batch and steps of r_t * k_t (v_t . do_t)
        G_{t-1} = r_t do_t^T + diag(w_t) G_t
        ds0 = G_{-1}

    The states S_{t-1} come from the forward run again (from ``s0``).
    Returns (dr, dk, dv, dlogw (B, S, H, N), du (H, N), ds0 (B, H, N, N) or
    None without ``s0``), all f32. Differentiable (autograd through the
    loops): K5's second order recomputes through it."""
    r, k, v, logw, do = (t.to(torch.float32) for t in (r, k, v, logw, dout))
    uu = u.to(torch.float32)
    b, s, h, n = r.shape
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.to(torch.float32))
    prev = []
    for t in range(s):
        prev.append(S)
        S = torch.exp(logw[:, t])[..., None] * S + \
            k[:, t, :, :, None] * v[:, t, :, None, :]
    G = torch.zeros_like(S) if dfinal is None else dfinal.to(torch.float32)
    du = torch.zeros_like(uu)
    grads = [[None] * s for _ in range(4)]
    for t in range(s - 1, -1, -1):
        rt, kt, vt, dot = r[:, t], k[:, t], v[:, t], do[:, t]
        w = torch.exp(logw[:, t])
        dd = torch.sum(dot * vt, dim=-1, keepdim=True)
        grads[0][t] = torch.einsum("bhkv,bhv->bhk", prev[t], dot) + uu * kt * dd
        grads[1][t] = torch.einsum("bhkv,bhv->bhk", G, vt) + uu * rt * dd
        grads[2][t] = (torch.einsum("bhkv,bhk->bhv", G, kt)
                       + torch.sum(rt * uu * kt, dim=-1, keepdim=True) * dot)
        grads[3][t] = w * torch.sum(prev[t] * G, dim=-1)
        du = du + torch.sum(rt * kt * dd, dim=0)
        G = rt[..., None] * dot[..., None, :] + w[..., None] * G
    dr, dk, dv, dlogw = (torch.stack(g, dim=1) for g in grads)
    return dr, dk, dv, dlogw, du, None if s0 is None else G
