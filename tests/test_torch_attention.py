"""K2 flash attention: the port's plain versions (and ``ops.flash_attention``
on CPU tensors) against the reference.

- The forward against the Pallas kernel run in interpret mode, over the
  reference's own shape list (``tests/test_kernels.py``), local windows and
  the non-causal Sq != Skv case, at the reference's tolerances (2e-5 in f32,
  2e-2 in bf16).
- The logsumexp L and the plain backward (dq, dk, dv) against
  ``jax.vjp`` of ``flash_attention_xla`` (the reference model's attention,
  whose backward is XLA code reading the saved L), with block sizes that
  make the reference scan over several block pairs, at 2e-5 in f32.
- The ``autograd.Function`` on CPU against PyTorch's autograd through the
  plain forward, at 2e-5: the hand-written backward is the gradient, also
  under non-reentrant checkpointing.

The CUDA kernels are held to the plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import vjp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import _flash_fwd_core, flash_attention_xla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else F32_TOL


def _inputs(seed, b, sq, skv, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, hq, hd), (b, skv, hkv, hd), (b, skv, hkv, hd), (b, sq, hq, hd)))


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "b,s,hq,hkv,hd,qb,kb",
    [
        (1, 32, 4, 4, 16, 16, 16),   # MHA
        (2, 64, 8, 2, 32, 16, 16),   # GQA 4:1
        (1, 40, 8, 1, 64, 8, 16),    # MQA, ragged seq
        (2, 128, 4, 2, 16, 32, 64),  # kv_block > q_block
    ],
)
def test_forward_matches_pallas_kernel(b, s, hq, hkv, hd, qb, kb, dtype):
    q, k, v, _ = _inputs(b * s + hd, b, s, s, hq, hkv, hd)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(
        jq, jk, jv, causal=True, q_block=qb, kv_block=kb, interpret=True),
        np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    # the same (bf16-rounded) inputs on both sides
    tq, tk, tv = (_to_torch(np.asarray(a, np.float32), tdt) for a in (jq, jk, jv))
    out, out32, lse = ref.flash_attention_ref(tq, tk, tv, causal=True)
    assert out.dtype == tdt and out32.dtype == torch.float32
    assert tuple(lse.shape) == (b, s, hq)
    np.testing.assert_allclose(_np(out), want, **_tol(dtype))
    np.testing.assert_allclose(_np(ops.flash_attention(tq, tk, tv, causal=True)),
                               want, **_tol(dtype))


@pytest.mark.parametrize("window", [8, 24, 1000])
def test_forward_local_window(window):
    q, k, v, _ = _inputs(window, 2, 64, 64, 4, 2, 16)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True, window=window, q_block=16,
                                kv_block=16, interpret=True)
    out = ops.flash_attention(*(_to_torch(a) for a in (q, k, v)), causal=True,
                              window=window)
    np.testing.assert_allclose(_np(out), np.asarray(want), **F32_TOL)


def test_forward_non_causal_cross():
    q, k, v, _ = _inputs(2, 1, 24, 56, 4, 2, 32)  # Skv != Sq
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=False, q_block=8, kv_block=16,
                                interpret=True)
    out = ops.flash_attention(*(_to_torch(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(_np(out), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,hd,causal,window,qb,kb",
    [
        (2, 64, 64, 8, 2, 32, True, 0, 16, 16),   # 4 x 4 block pairs
        (1, 40, 40, 8, 1, 16, True, 0, 8, 16),    # MQA, ragged, qb < kb
        (1, 48, 48, 4, 4, 16, True, 0, 32, 8),    # qb > kb
        (2, 64, 64, 4, 2, 16, True, 24, 16, 16),  # window: pairs skipped
        (1, 24, 56, 4, 2, 32, False, 0, 8, 16),   # non-causal, Sq != Skv
    ],
)
def test_lse_and_backward_match_flash_attention_xla(b, sq, skv, hq, hkv, hd,
                                                    causal, window, qb, kb):
    q, k, v, do = _inputs(sq * hd + window, b, sq, skv, hq, hkv, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, pullback = vjp(
        lambda q_, k_, v_: flash_attention_xla(q_, k_, v_, causal, window, qb, kb),
        jq, jk, jv)
    want_grads = pullback(jnp.asarray(do))
    _, want_lse = _flash_fwd_core(jq, jk, jv, causal, window, qb, kb)

    tq, tk, tv = (_to_torch(a) for a in (q, k, v))
    got, out32, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                              window=window)
    np.testing.assert_allclose(_np(got), np.asarray(out), **F32_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse).reshape(b, sq, hq),
                               **F32_TOL)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, out32, lse, _to_torch(do),
                                        causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **F32_TOL)


@pytest.mark.parametrize(
    "shape,causal,window,remat",
    [
        ((2, 33, 33, 4, 2, 16), True, 0, False),
        ((1, 40, 40, 6, 3, 32), True, 12, False),
        ((1, 24, 56, 4, 1, 16), False, 0, False),
        ((2, 33, 33, 4, 2, 16), True, 0, True),   # under checkpoint
    ],
)
def test_autograd_function_is_the_gradient(shape, causal, window, remat):
    q, k, v, do = (_to_torch(a).requires_grad_(i < 3)
                   for i, a in enumerate(_inputs(sum(shape), *shape)))

    def attend(q_, k_, v_):
        return ops.flash_attention(q_, k_, v_, causal=causal, window=window)

    if remat:
        out = torch.utils.checkpoint.checkpoint(attend, q, k, v,
                                                use_reentrant=False)
    else:
        out = attend(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)[0]
    want = torch.autograd.grad(plain, (q, k, v), do)
    np.testing.assert_allclose(_np(out), _np(plain), **F32_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **F32_TOL)


def _second_order(b, s, hq, hkv, hd, causal, window, dtype, seed):
    """Both packages' gradient of ``sum |grad_{q,k,v} sum(out . w)|^2``
    with respect to (q, k, v), from the same (dtype-rounded) inputs."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, hq, hd))]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jw = (jnp.asarray(a, jdt) for a in arrays)
    blk = min(16, s)

    def inner(q_, k_, v_):
        out = flash_attention_xla(q_, k_, v_, causal, window, blk, blk)
        return jnp.sum((out * jw).astype(jnp.float32))

    def outer(q_, k_, v_):
        grads = jax.grad(inner, argnums=(0, 1, 2))(q_, k_, v_)
        return sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in grads)

    want = jax.grad(outer, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tw = (_to_torch(np.asarray(a.astype(jnp.float32)), dtype)
                      for a in (jq, jk, jv, jw))
    tq, tk, tv = (t.requires_grad_(True) for t in (tq, tk, tv))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad((out * tw).float().sum(), (tq, tk, tv),
                                create_graph=True)
    total = sum((g.float() ** 2).sum() for g in grads)
    got = torch.autograd.grad(total, (tq, tk, tv))
    return [_np(g) for g in got], [np.asarray(w.astype(jnp.float32))
                                   for w in want]


@pytest.mark.parametrize(
    "shape,causal,window,dtype",
    [
        ((1, 8, 2, 2, 16), True, 0, torch.float32),    # the P3 probe
        ((2, 32, 8, 2, 16), True, 12, torch.float32),  # GQA 4:1, window
        ((1, 24, 4, 1, 32), False, 0, torch.float32),  # MQA, non-causal
        ((1, 16, 4, 2, 16), True, 0, torch.bfloat16),
    ],
)
def test_second_order_matches_jax_grad_of_grad(shape, causal, window, dtype):
    """P3: the double backward through K2 is the reference's. The parent's
    port, which treated the saved f32 output and L as constants, read
    743.97 / 585.85 for sum |d/dq| / sum |d/dk| at the probe's shape where
    the reference reads 122.04 / 143.82."""
    ops.reset_launches()
    got, want = _second_order(*shape, causal, window, dtype, seed=0)
    assert ops.plain_counts()["flash_attention_bwd2_plain"] == 1
    for name, g, w in zip(("q", "k", "v"), got, want):
        top = np.abs(w).max()
        if dtype == torch.float32:
            lim = 1e-4 * top
        else:
            lim = 2.0 ** -6 * np.abs(w) + 1e-2 * top
        assert np.all(np.abs(g - w) <= lim), (name, np.abs(g - w).max(), top)
    if shape == (1, 8, 2, 2, 16):
        np.testing.assert_allclose([np.abs(g).sum() for g in got],
                                   [122.035, 143.818, 175.134], rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_order_stays_the_plain_backward_bitwise(dtype):
    """The first-order backward still runs ``bwd_dq`` and ``bwd_dkdv`` (the
    plain versions here), bitwise, and takes no second-order call."""
    q, k, v, do = (_to_torch(a, dtype)
                   for a in _inputs(3, 2, 40, 40, 6, 3, 32))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True, window=12)
    got = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        want_out, out32, lse = ref.flash_attention_ref(q, k, v, causal=True,
                                                       window=12)
        want = ref.flash_attention_bwd_ref(q, k, v, out32, lse, do,
                                           causal=True, window=12)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ops.plain_counts()["flash_attention_bwd2_plain"] == 0


def test_third_order_composes():
    """The second order keeps a graph under ``create_graph``: a third
    derivative through K2 equals autograd's through the plain forward."""
    q, k, v, w = (_to_torch(a).requires_grad_(i < 3)
                  for i, a in enumerate(_inputs(7, 1, 6, 6, 2, 1, 8)))

    def third(attend):
        out = attend(q, k, v)
        g1 = torch.autograd.grad((out * w).sum(), q, create_graph=True)[0]
        g2 = torch.autograd.grad((g1 ** 2).sum(), k, create_graph=True)[0]
        return torch.autograd.grad((g2 ** 2).sum(), (q, k, v))

    got = third(lambda *t: ops.flash_attention(*t, causal=True))
    want = third(lambda *t: ref.flash_attention_ref(*t, causal=True)[0])
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w_), rtol=1e-4,
                                   atol=1e-4 * float(w_.abs().max()))


def test_cpu_path_launches_nothing_and_odd_devices_raise():
    ops.reset_launches()
    q, k, v, do = (_to_torch(a).requires_grad_(i < 3)
                   for i, a in enumerate(_inputs(0, 1, 8, 8, 2, 1, 16)))
    torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    counts = ops.launch_counts()
    assert {n: counts[n] for n in ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkdv")} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkdv": 0}
    meta = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])


# --- the bf16 route's arithmetic (csrc/flash_attention.cu, namespace tc) ---
#
# On the card, bf16 K2 multiplies on tensor cores: bf16 operands, f32 sums.
# q.k^T and dout.v^T take two bf16 tensors and are exact there; the products
# with an f32 operand (p or ds) take it split into hi = bf16(x) and
# lo = bf16(x - hi), two products summed in f32. This plain emulation of
# that design is held to the gates the card holds the kernels to.

def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _rounded_once(x):
    return _bf16(x), torch.zeros_like(x)


def _emulated_k2(q, k, v, dout, causal, window, split):
    """(out32, L, D, dq, dk, dv) of the tensor-core design on bf16 inputs:
    scores and dp from f32 products of the bf16 values, each f32 operand
    of the other four products through ``split``."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    kf, vf = k.float(), v.float()
    s = ref._scores(q, k, causal, window)                 # (B, Hkv, G, Sq, Skv)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    hi, lo = split(e)
    pv = (torch.einsum("bhgqk,bkhd->bqhgd", hi, vf)
          + torch.einsum("bhgqk,bkhd->bqhgd", lo, vf))
    lq = l[..., 0].permute(0, 3, 1, 2)[..., None]         # (B, Sq, Hkv, G, 1)
    out32 = (pv / torch.clamp_min(lq, 1e-30)).reshape(b, sq, hq, hd)
    lse = (m + torch.log(torch.clamp_min(l, 1e-30)))[..., 0]
    lse = lse.permute(0, 3, 1, 2).reshape(b, sq, hq)
    do = dout.float()
    delta = (do * out32).sum(-1)
    p = torch.exp(s - ref._rows(lse, hkv))
    dp = torch.einsum("bqhgd,bkhd->bhgqk",
                      do.reshape(b, sq, hkv, hq // hkv, hd), vf)
    ds = p * (dp - ref._rows(delta, hkv)) * scale
    qg = q.float().reshape(b, sq, hkv, hq // hkv, hd)
    dog = do.reshape(b, sq, hkv, hq // hkv, hd)

    def two(eq, x, y):
        xh, xl = split(x)
        return torch.einsum(eq, xh, y) + torch.einsum(eq, xl, y)

    dq = two("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, hd)
    dk = two("bhgqk,bqhgd->bkhd", ds, qg)
    dv = two("bhgqk,bqhgd->bkhd", p, dog)
    return out32, lse, delta, dq, dk, dv


def _within(got, want, tol):
    """The card's f32 gate: |got - want| <= tol + tol |want|."""
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _within_bf16_step(got, want):
    """The card's bf16 gate: one bf16 step plus 1e-3 of the largest."""
    diff = (got.double() - want.double()).abs()
    lim = 2.0 ** -7 * want.double().abs() + 1e-3 * want.double().abs().max()
    return bool((diff <= lim).all())


@pytest.mark.parametrize(
    "b,s,hq,hkv,hd,window",
    [
        (1, 512, 2, 2, 64, 0),      # lm_350m's head layout
        (1, 300, 10, 1, 256, 64),   # recurrentgemma_2b's MQA window
    ],
)
def test_tensor_core_split_meets_the_card_gates(b, s, hq, hkv, hd, window):
    """The hi/lo split passes the gates of ``chip_smoke.flash_case`` and
    ``test_torch_cuda.py`` against the plain versions: out32, L and D
    within rtol = atol = 2e-5, bf16 out and gradients within one bf16
    step; p and ds rounded once to bf16 fail the out32 gate."""
    q, k, v, do = (_to_torch(a, torch.bfloat16)
                   for a in _inputs(hd + s, b, s, s, hq, hkv, hd))
    kw = dict(causal=True, window=window)
    want_out, want32, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    want_dq, want_delta = ref.flash_attention_bwd_dq_ref(
        q, k, v, want32, want_lse, do, **kw)
    want_dk, want_dv = ref.flash_attention_bwd_dkdv_ref(
        q, k, v, want_lse, want_delta, do, **kw)

    out32, lse, delta, dq, dk, dv = _emulated_k2(q, k, v, do, True, window,
                                                 _split)
    assert _within(out32, want32, 2e-5)
    assert _within(lse, want_lse, 2e-5)
    assert _within(delta, want_delta, 2e-5)
    assert _within_bf16_step(out32.bfloat16(), want_out)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert _within_bf16_step(got.bfloat16(), want)

    once32 = _emulated_k2(q, k, v, do, True, window, _rounded_once)[0]
    assert not _within(once32, want32, 2e-5)
