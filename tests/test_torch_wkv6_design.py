"""The arithmetic of K5's tensor-core design (``csrc/wkv6.cu``), emulated on
the CPU and held to the card's gates against the plain versions.

The card runs K5 as three stages a pass: per-chunk terms, an elementwise
scan over the chunk states, and the per-chunk output or gradients. Inside a
64-step chunk, pairs (i, j) in different 16-step sub-chunks factor their
decay through the boundary ``b`` of i's sub-chunk (or of the sub-chunk after
j's), ``e^{lcw_{i-1} - lcw_j} = e^{lcw_{i-1} - lcw_b} e^{lcw_b - lcw_j}``, two
factors <= 1, so those blocks are products of decayed tiles; only the
diagonal sub-blocks keep one exponential per (pair, channel). Every
exponent comes from the cumulative log-decay summed in f64 and kept as two
f32 words (hi + lo). Every product runs on TF32 tensor cores with the
3xTF32 split: ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (10 mantissa bits,
nearest), ``a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi``, each MMA adding its
eight products to an f32 accumulator, here rounded toward zero: the card
reads less error than that model and more than with the sums rounded to
nearest, so the model bounds the tensor cores' accumulation from above.

This file repeats that arithmetic in PyTorch and checks it against
``ref.wkv6_fwd_ref`` / ``ref.wkv6_bwd_ref`` at the gates of
``chip_smoke.wkv_case`` and ``tests/test_torch_cuda.py``: out within
rtol = atol = 1e-4, the chunk states and each gradient within 1e-4 of
their largest magnitude, under the model's decay law and the reference
test's mild one, ragged S included. A control that rounds each product
operand once to TF32 must fail the out gate: the split is what the gates
need. On a card (marked ``cuda``), K5's out at rwkv6_3b's shape must stand
no farther from an f64 recurrence than the emulation's does, so the
emulation models the arithmetic that sets the card's error:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_wkv6_design.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CHUNK, SUB = 64, 16
LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split3(a, b):
    """a @ b as three TF32 products of the hi/lo split, summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 to f32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _round_to_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _tensor_cores(a, b, rounding=_round_to_zero):
    """a @ b as ``warp_mma`` runs it on mma.sync m16n8k8: for each k-step
    of 8, the MMAs a_lo b_hi, a_hi b_lo, a_hi b_hi in that order, each
    adding its eight TF32 products (exact in f64) to the f32 accumulator
    and rounding the sum by ``rounding`` (toward zero unless given)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = rounding(acc.double() + x[..., k:k + 8].double()
                           @ y[..., k:k + 8, :].double())
    return acc


def _once(a, b):
    """a @ b with each operand rounded once to TF32 (the control)."""
    return _tf32(a) @ _tf32(b)


def _chunks(x, nc):
    """(B, S, H, N) -> (B, H, nc, 64, N) f32, zero past S."""
    b, s, h, n = x.shape
    pad = torch.zeros((b, nc * CHUNK - s, h, n), dtype=torch.float32)
    x = torch.cat([x.to(torch.float32), pad], dim=1)
    return x.reshape(b, nc, CHUNK, h, n).permute(0, 3, 1, 2, 4)


def _unchunk(x, s):
    b, h, nc, _, n = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h, n)[:, :s]


class _Lcw:
    """The cumulative log-decay of each chunk in log2 units, summed in f64,
    kept as hi + lo f32 words; index -1 is the chunk's start (0)."""

    def __init__(self, lw):
        acc = torch.cumsum(lw.double() * LOG2E, dim=-2)
        hi = acc.float()
        lo = (acc - hi.double()).float()
        zero = torch.zeros_like(hi[..., :1, :])
        self.hi = torch.cat([zero, hi], dim=-2)   # row a + 1 holds lcw_a
        self.lo = torch.cat([zero, lo], dim=-2)

    def decay(self, a, b):
        """2^{lcw_a - lcw_b} in f32 ((hi_a - hi_b) + (lo_a - lo_b), one
        rounding, then exp2); a, b index tensors or ints in [-1, 63],
        broadcast against each other over the rows."""
        a, b = torch.broadcast_tensors(torch.as_tensor(a) + 1,
                                       torch.as_tensor(b) + 1)
        dh = self.hi[..., a, :] - self.hi[..., b, :]
        dl = self.lo[..., a, :] - self.lo[..., b, :]
        return torch.exp2(dh + dl)


def _suffix_decay(lw):
    """2^{sum_{t > j} lw_t log2 e} per row j (f64 sum, one rounding) and the
    chunk's whole decay 2^{lcw_last}."""
    d = lw.double() * LOG2E
    total = d.sum(dim=-2, keepdim=True)
    suffix = total - torch.cumsum(d, dim=-2)
    return torch.exp2(suffix.float()), torch.exp2(total.float())[..., 0, :]


def _prefix_decay(lw):
    """2^{lcw_{i-1}} per row i (f64 sum, one rounding)."""
    d = lw.double() * LOG2E
    prefix = torch.cumsum(d, dim=-2) - d
    return torch.exp2(prefix.float())


def _rows(p):
    return torch.arange(SUB * p, SUB * p + SUB)


def _diag_pairs(lcw, p):
    """The per-pair exponentials of diagonal sub-block p: (..., 16, 16, N),
    2^{lcw_{i-1} - lcw_j} for j < i, 0 elsewhere (where the exponent is
    > 0 and may overflow: the card never evaluates those)."""
    i = _rows(p)
    e = lcw.decay(i[:, None] - 1, i[None, :])        # (..., 16, 16, N)
    return torch.where((i[:, None] > i[None, :])[..., None], e, 0.0)


def _scores(r, k, u, lcw, mm):
    """A (..., 64, 64): A_ij = sum_n r_in k_jn 2^{lcw_{i-1} - lcw_j} for
    j < i, r_i . (u k_i) on the diagonal, 0 above; off the diagonal
    sub-blocks the product of tiles decayed to and from the row's
    sub-chunk boundary."""
    a = torch.zeros(r.shape[:-1] + (CHUNK,), dtype=torch.float32)
    for p in range(CHUNK // SUB):
        i = _rows(p)
        e = _diag_pairs(lcw, p)
        blk = (r[..., i, None, :] * k[..., None, i, :] * e).sum(-1)
        bonus = (r[..., i, :] * u * k[..., i, :]).sum(-1)
        blk = blk + torch.diag_embed(bonus)
        a[..., SUB * p:SUB * p + SUB, SUB * p:SUB * p + SUB] = blk
        if p:
            beta = SUB * p - 1
            j = torch.arange(SUB * p)
            rt = r[..., i, :] * lcw.decay(i - 1, beta)
            kt = k[..., j, :] * lcw.decay(beta, j)
            a[..., SUB * p:SUB * p + SUB, :SUB * p] = mm(rt, kt.transpose(-1, -2))
    return a


def emulated_fwd(r, k, v, lw, u, mm=_tensor_cores):
    """(out (B, S, H, N), states (B, H, nc, N, N)) by the card's design."""
    s = r.shape[1]
    nc = -(-s // CHUNK)
    r, k, v, lw = (_chunks(x, nc) for x in (r, k, v, lw))
    uu = u.to(torch.float32)[None, :, None, None, :]
    # stage a: each chunk's own state term and decay
    khat_dec, dvec = _suffix_decay(lw)
    dstate = mm((k * khat_dec).transpose(-1, -2), v)
    # stage b: the scan over chunks
    states = [torch.zeros_like(dstate[:, :, 0])]
    for c in range(nc - 1):
        states.append(dvec[:, :, c, :, None] * states[-1] + dstate[:, :, c])
    states = torch.stack(states, dim=2)
    # stage c: the output, in one pass
    lcw = _Lcw(lw)
    a = _scores(r, k, uu, lcw, mm)
    rhat = r * lcw.decay(torch.arange(CHUNK) - 1, -1)
    # one accumulator: (r e^{lcw}) S_c, then A V
    out = mm(torch.cat([rhat, a], dim=-1), torch.cat([states, v], dim=-2))
    return _unchunk(out, s), states


def emulated_bwd(r, k, v, lw, u, states, dout, mm=_tensor_cores):
    """(dr, dk, dv, dlogw (B, S, H, N), du (H, N)) by the card's design,
    given the chunk states."""
    s = r.shape[1]
    nc = -(-s // CHUNK)
    r, k, v, lw, do = (_chunks(x, nc) for x in (r, k, v, lw, dout))
    uu = u.to(torch.float32)[None, :, None, None, :]
    # stage a: each chunk's own term of the reverse recursion
    rhat = r * _prefix_decay(lw)
    _, dvec = _suffix_decay(lw)
    xterm = mm(rhat.transpose(-1, -2), do)
    # stage b: the reverse scan; dstates[c] = dL/dS at chunk c's end
    ds = [torch.zeros_like(xterm[:, :, 0])]
    for c in range(nc - 1, 0, -1):
        ds.append(dvec[:, :, c, :, None] * ds[-1] + xterm[:, :, c])
    dstates = torch.stack(ds[::-1], dim=2)
    # stage c: the gradients of each chunk
    lcw = _Lcw(lw)
    rows = torch.arange(CHUNK)
    da = mm(do, v.transpose(-1, -2))
    dd = torch.diagonal(da, dim1=-2, dim2=-1)[..., None]    # (..., 64, 1)
    a = _scores(r, k, uu, lcw, mm)
    dr_ = lcw.decay(rows - 1, -1) * mm(do, states.transpose(-1, -2))
    hi_dec = lcw.decay(CHUNK - 1, rows)
    dk_ = hi_dec * mm(v, dstates.transpose(-1, -2))
    for p in range(CHUNK // SUB):
        i = _rows(p)
        e = _diag_pairs(lcw, p)
        dai = da[..., i, :][..., :, i][..., None] * (e > 0)  # j < i only
        dr_[..., i, :] += (dai * k[..., None, i, :] * e).sum(-2)
        dk_[..., i, :] += (dai * r[..., i, None, :] * e).sum(-3)
        if p:
            beta = SUB * p - 1
            j = torch.arange(SUB * p)
            kt = k[..., j, :] * lcw.decay(beta, j)
            dr_[..., i, :] += lcw.decay(i - 1, beta) * mm(
                da[..., i, :][..., :SUB * p], kt)
        if p < CHUNK // SUB - 1:
            beta = SUB * (p + 1) - 1
            later = torch.arange(SUB * (p + 1), CHUNK)
            rt = r[..., later, :] * lcw.decay(later - 1, beta)
            dk_[..., i, :] += lcw.decay(beta, i) * mm(
                da[..., later, :][..., i].transpose(-1, -2), rt)
    khat = k * hi_dec
    dv = mm(a.transpose(-1, -2), do) + mm(khat, dstates)
    dr = dr_ + uu * k * dd
    dk = dk_ + uu * r * dd
    # dlogw_t = sum_{m >= t} ((r dr')_{m+1} - (k dk')_m) + rowsum(S_{c+1} dS_c)
    rdr = torch.cat([(r * dr_)[..., 1:, :], torch.zeros_like(r[..., :1, :])],
                    dim=-2)
    w = rdr - k * dk_
    nxt = torch.cat([states[:, :, 1:], torch.zeros_like(states[:, :, :1])],
                    dim=2)
    rs = (nxt * dstates).sum(-1)[..., None, :]
    dlw = torch.flip(torch.cumsum(torch.flip(w, [-2]), dim=-2), [-2]) + rs
    du = (r * k * dd).sum(-2).sum(2).sum(0)   # over rows, chunks, batch
    return (*(_unchunk(x, s) for x in (dr, dk, dv, dlw)), du)


def _inputs(seed, b, s, h, n, law):
    """The card tests' inputs (``test_torch_cuda._wkv_inputs``), from numpy:
    r, k, v, the output gradient standard normal, u 0.5 N(0, 1); logw mild
    (``-exp(0.5 N(0, 1))``), as the model draws it (``-exp(w0 +
    lora)``, w0 ~ N(0, 0.5) per channel), whose cumulative log-decay
    passes -88 inside a 64-step chunk, or steep (``-exp(2 + 0.3 N(0,
    1))``: about e^{-7} a step, past -88 inside 16 steps)."""
    rng = np.random.default_rng(seed)
    r, k, v, do = rng.standard_normal((4, b, s, h, n))
    if law == "mild":
        lw = -np.exp(0.5 * rng.standard_normal((b, s, h, n)))
    elif law == "steep":
        lw = -np.exp(2.0 + 0.3 * rng.standard_normal((b, s, h, n)))
    else:
        w0 = 0.5 * rng.standard_normal((h, n))
        lw = -np.exp(w0 + 0.3 * rng.standard_normal((b, s, h, n)))
    u = 0.5 * rng.standard_normal((h, n))
    return tuple(torch.from_numpy(np.asarray(t, np.float32))
                 for t in (r, k, v, lw, u, do))


def _within_of_max(got, want, tol=1e-4):
    err = float((got.double() - want.double()).abs().max())
    return err <= tol * max(float(want.abs().max()), 1e-30), err


@pytest.mark.parametrize("law", ["model", "mild", "steep"])
@pytest.mark.parametrize("b,s,h,n", [(1, 200, 2, 64), (2, 129, 1, 32),
                                     (1, 37, 2, 16), (1, 81, 1, 64)])
def test_tensor_core_design_meets_the_card_gates(b, s, h, n, law):
    """The emulated forward and backward pass the card's K5 gates against
    the sequential plain versions, at ragged S and N = 16, 32, 64."""
    r, k, v, lw, u, do = _inputs(b * s + n, b, s, h, n, law)
    want_out, want_states, _ = ref.wkv6_fwd_ref(r, k, v, lw, u)
    out, states = emulated_fwd(r, k, v, lw, u)
    assert torch.isfinite(out).all() and torch.isfinite(states).all()
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    ok, err = _within_of_max(states, want_states)
    assert ok, err
    got = emulated_bwd(r, k, v, lw, u, states, do)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        ok, err = _within_of_max(g, w)
        assert ok, (name, err)


@pytest.mark.parametrize("law", ["model", "mild"])
def test_one_tf32_rounding_fails_the_out_gate(law):
    """The control: each product operand rounded once to TF32 (about 3
    decimal digits) misses out's rtol = atol = 1e-4."""
    r, k, v, lw, u, _ = _inputs(11, 1, 200, 2, 64, law)
    want = ref.wkv6_ref(r, k, v, lw, u)
    out = emulated_fwd(r, k, v, lw, u, mm=_once)[0]
    assert not bool(torch.isclose(out, want, rtol=1e-4, atol=1e-4).all())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0 * 2.0 ** -20])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 3.0 * 2.0 ** -20])
    assert torch.equal(_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(y)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11
    lo = _tf32(y - hi)
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2.0 ** -21
    assert math.isclose(float(_split3(y[None, :], y[:, None])),
                        float((y.double() ** 2).sum()), rel_tol=1e-6)


def _sequential_f64(r, k, v, lw, u):
    """The WKV6 output by the sequential recurrence in f64 (the plain
    version's loop, without its casts to f32)."""
    r, k, v, lw = (t.double() for t in (r, k, v, lw))
    uu = u.double()[None, :, :, None]
    b, s, h, n = r.shape
    state = torch.zeros((b, h, n, n), dtype=torch.float64)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + uu * kv))
        state = torch.exp(lw[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1)


def test_tensor_core_accumulation_rounds_toward_zero():
    """The accumulation model: every MMA's sum rounded toward zero, so a
    sum of positive terms never exceeds the exact one and falls short by
    less than one f32 step of the result a MMA."""
    y = torch.rand((1, 1000), generator=torch.Generator().manual_seed(1))
    exact = float((y.double() ** 2).sum())
    got = float(_tensor_cores(y, y.T))
    f32_step = 2.0 ** (math.floor(math.log2(exact)) - 23)
    assert got <= exact and exact - got < 3 * 125 * f32_step
    x = torch.tensor([[1.0, 2.0 ** -30] + [0.0] * 6])
    assert float(_tensor_cores(x, torch.ones((8, 1)))) == 1.0
    assert float(_tensor_cores(-x, torch.ones((8, 1)))) == -1.0


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["model", "mild"])
def test_card_error_within_the_emulated_designs(law):
    """K5's out on the card at rwkv6_3b's shape (1, 4096, 40, 64) stands
    no farther from an f64 recurrence than the emulation's, on the same
    inputs: the emulation's model of the tensor cores' accumulation bounds
    the card's error, so the CPU tests above see a change that moves it
    toward the gate."""
    if not compat.is_hopper():
        pytest.skip("needs a compute-capability 9.x CUDA card and nvcc")
    from repro_torch.kernels import ops

    r, k, v, lw, u, _ = _inputs(0, 1, 4096, 40, 64, law)
    truth = _sequential_f64(r, k, v, lw, u)
    outs = {
        "card": ops.wkv6_fwd(*(t.cuda() for t in (r, k, v, lw, u)))[0].cpu(),
        "emulated": emulated_fwd(r, k, v, lw, u)[0],
        "emulated_nearest": emulated_fwd(
            r, k, v, lw, u,
            mm=lambda a, b: _tensor_cores(a, b, _round_to_nearest))[0],
        "plain_f32": ref.wkv6_ref(r, k, v, lw, u)}
    errs = {name: float((out.double() - truth).abs().max())
            for name, out in outs.items()}
    print(f"wkv6 out vs f64 recurrence, (1, 4096, 40, 64) {law}: {errs}")
    assert errs["card"] <= errs["emulated"], errs
