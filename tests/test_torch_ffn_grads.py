"""The gradients of the bf16 gated FFN's up and gate products on the card,
emulated on the CPU, against ``jax.vjp`` of the reference.

The reference computes those products as ``einsum(...,
preferred_element_type=f32)`` (``repro/models/mlp.py:33-34``,
``repro/models/moe.py:154-155``) and transposes them as the f32 cotangent
against the bf16 operand with an f32 result, cast to bf16: each gradient is
``bf16(g . f32(operand))``. On the card ``common._MatmulF32`` splits the
f32 cotangent into three bf16 terms (``common.split3_bf16``, exact), runs
one bf16 GEMM with an f32 output for each and sums them in f32. Here
``common._gemm_f32_output`` is patched to take that path on CPU tensors,
where ``common._mm_f32`` is the f32 product of f32 copies: the card's
arithmetic but for the order of the f32 sums.

At x (2, 64, 256) bf16, FFN width 1024, weights 0.02 * normal and a normal
cotangent, for lm_350m's dense FFN and phi35_moe's experts (the reference's
MoE on f32 copies of its bf16 operands, as XLA's CPU backend refuses a
batched bf16 x bf16 -> f32 dot, ``tests/test_torch_model.py``): every
parameter's gradient within one bf16 step (``2^-7 |want| + 1e-3 max
|want|``), zero elements beyond; x's gradient, the bf16 sum of the up and
the gate product's, within one step of each term. Each product's
gradients alone, against ``jax.vjp`` of the reference's einsum with the
same f32 cotangent: zero elements beyond one step. Beside each the
one-rounding control (the cotangent rounded to bf16 once, as the card's
backward was) must leave elements beyond.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mlp as jmlp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import common, mlp, moe, registry  # noqa: E402
from test_torch_model import _f32_einsum_shim  # noqa: E402

ARCHS = ("lm_350m", "phi35_moe")
BF16 = torch.bfloat16
GRADS = common.matmul_f32_grads  # before any test patches it


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so this file's tests do not
    crowd out the suite's other workers; the worker's count comes back
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _beyond(got: torch.Tensor, want) -> int:
    """Elements of ``got`` more than one bf16 step from ``want``."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    diff = np.abs(got.double().numpy() - want)
    lim = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    return int((diff > lim).sum())


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(port cfg, port params, x, cotangent, reference grads of the params
    and of x) of one FFN at the shape above."""
    over = dict(dtype="bfloat16", d_model=256, d_ff=1024)
    jcfg = jreg.get_config(request.param).reduced(**over)
    tcfg = registry.get_config(request.param).reduced(**over)
    mod = jmoe if tcfg.family == "moe" else jmlp
    shapes = jax.device_get(mod.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    params = {k: (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in sorted(shapes.items())}
    x = rng.standard_normal((2, 64, 256)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 256)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def f(p, v):
        out = mod.apply(jcfg, p, v)
        return out[0] if mod is jmoe else out

    shim = _f32_einsum_shim(mod) if mod is jmoe else contextlib.nullcontext()
    with shim:
        _, vjp = jax.vjp(f, jp, jx)
        jgp, jgx = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    tp = {k: torch.from_numpy(v).to(BF16) for k, v in params.items()}
    return (tcfg, tp, torch.from_numpy(x).to(BF16),
            torch.from_numpy(cot).to(BF16), jax.device_get(jgp), jgx)


def _port_grads(cfg, params, x, cot, monkeypatch, x_terms=None):
    """Autograd of the port's FFN through ``_MatmulF32`` on the CPU: (the
    params' grads, x's grad). ``x_terms`` "abs" or "zero" replaces the up
    and the gate product's gradients in their input by their magnitudes,
    or by zeros (for :func:`_step_of_terms`)."""
    monkeypatch.setattr(common, "_gemm_f32_output",
                        lambda a: a.dtype == BF16)
    calls = []

    def recorded(a, b, g, need=(True, True)):
        da, db = GRADS(a, b, g, need)
        calls.append(1)
        if x_terms == "abs":
            da = da.abs()
        elif x_terms == "zero":
            da = torch.zeros_like(da)
        return da, db

    monkeypatch.setattr(common, "matmul_f32_grads", recorded)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xv = x.clone().requires_grad_()
    if cfg.family == "moe":
        out = moe.apply(cfg, p, xv)[0]
    else:
        out = mlp.apply(cfg, p, xv)
    names = sorted(p)
    grads = torch.autograd.grad(out, [p[k] for k in names] + [xv], cot)
    assert len(calls) == 2  # the up and the gate product
    return dict(zip(names, grads[:-1])), grads[-1]


def _step_of_terms(cfg, params, x, cot, monkeypatch) -> np.ndarray:
    """The sum of the magnitudes of the terms of x's gradient: the up and
    the gate product's gradients (through the MoE's dispatch, whose
    weights are 0 or 1), and the rest (the MoE router's). Autograd adds
    them in bf16, as the reference's ``add_any`` does."""
    rest = _port_grads(cfg, params, x, cot, monkeypatch, "zero")[1].double()
    both = _port_grads(cfg, params, x, cot, monkeypatch, "abs")[1].double()
    return ((both - rest) + rest.abs()).numpy()


def _beyond_terms(gx, jgx, step) -> int:
    """Elements of x's gradient more than one bf16 step of the magnitudes
    of its terms from the reference's. Each term is within one step of the
    reference's (``test_product_grads_match_jax_transpose``); where terms
    nearly cancel, one step of the sum is less than one of a term, and a
    term whose f32 sum lies at a bf16 rounding boundary rounds the other
    way in another summation order."""
    want = np.asarray(jnp.asarray(jgx).astype(jnp.float32), np.float64)
    diff = np.abs(gx.double().numpy() - want)
    lim = 2.0 ** -7 * step + 1e-3 * np.abs(want).max()
    return int((diff > lim).sum())


def test_card_backward_within_one_step_of_reference(case, monkeypatch):
    """Every parameter's gradient within one bf16 step of the reference's,
    zero beyond; x's within one step of each of its two terms."""
    cfg, params, x, cot, jgp, jgx = case
    gp, gx = _port_grads(cfg, params, x, cot, monkeypatch)
    step = _step_of_terms(cfg, params, x, cot, monkeypatch)
    assert gx.dtype == BF16 and _beyond_terms(gx, jgx, step) == 0
    for k in sorted(gp):
        assert gp[k].dtype == BF16
        assert _beyond(gp[k], jgp[k]) == 0, k


def test_one_rounding_control_is_beyond(case, monkeypatch):
    """The cotangent rounded to bf16 once (the card's old backward): some
    gradient through the up and gate products leaves the same gates."""
    cfg, params, x, cot, jgp, jgx = case
    monkeypatch.setattr(common, "split3_bf16", lambda g: (g.to(BF16),))
    gp, gx = _port_grads(cfg, params, x, cot, monkeypatch)
    step = _step_of_terms(cfg, params, x, cot, monkeypatch)
    assert _beyond_terms(gx, jgx, step) + _beyond(gp["wi"], jgp["wi"]) + (
        _beyond(gp["wg"], jgp["wg"])) > 0


@pytest.mark.parametrize("spec,sa,sb", [
    ("mk,kn->mn", (128, 256), (256, 1024)),
    ("emk,ekn->emn", (4, 80, 256), (4, 256, 1024))])
def test_product_grads_match_jax_transpose(spec, sa, sb, monkeypatch):
    """One product at the FFN's shapes (lm_350m's up product of 128 tokens;
    phi35_moe's experts, batched): ``matmul_f32_grads`` of an f32
    cotangent against ``jax.vjp`` of the reference's ``einsum(...,
    preferred_element_type=f32)`` (the batched one on f32 copies, as XLA's
    CPU backend refuses its bf16 x bf16 -> f32 dot): zero elements beyond
    one bf16 step; the one-rounding control leaves elements beyond."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(sa).astype(np.float32)
    b = (0.02 * rng.standard_normal(sb)).astype(np.float32)
    g = rng.standard_normal(sa[:-1] + sb[-1:]).astype(np.float32)
    ja, jb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    if len(sa) == 2:
        f = lambda u, v: jnp.einsum(  # noqa: E731
            spec, u, v, preferred_element_type=jnp.float32)
    else:
        f = lambda u, v: jnp.einsum(  # noqa: E731
            spec, u.astype(jnp.float32), v.astype(jnp.float32))
    jda, jdb = jax.vjp(f, ja, jb)[1](jnp.asarray(g))
    ta, tb = (torch.from_numpy(v).to(BF16) for v in (a, b))
    da, db = common.matmul_f32_grads(ta, tb, torch.from_numpy(g))
    assert _beyond(da, jda) == 0 and _beyond(db, jdb) == 0
    monkeypatch.setattr(common, "split3_bf16", lambda t: (t.to(BF16),))
    da1, db1 = common.matmul_f32_grads(ta, tb, torch.from_numpy(g))
    assert _beyond(da1, jda) + _beyond(db1, jdb) > 0


def test_second_order_through_the_card_path(monkeypatch):
    """A gradient taken with ``create_graph`` (MAML's outer gradient)
    through ``_MatmulF32`` on CPU tensors is differentiable again: the
    Hessian-vector product of ``sum(tanh(x @ w))`` in ``w``, through the
    card's path, against the same through the CPU's f32 copies (the
    reference's arithmetic): within one bf16 step (2^-7) in the L2 norm
    and two (2^-6) of the largest magnitude at every element. The two
    round the bf16 first-order gradient and the bf16 sum of the Hessian's
    two terms in other orders, so elements part by more than one step
    where those terms cancel."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(64, 128, generator=gen).to(BF16)
    w = (0.1 * torch.randn(128, 96, generator=gen)).to(BF16)
    u = torch.randn(64, 128, generator=gen)
    hvps = []
    for card in (True, False):
        monkeypatch.setattr(common, "_gemm_f32_output",
                            lambda a, card=card: card and a.dtype == BF16)
        xv, wv = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = torch.tanh(common.matmul_f32(xv, wv)).sum()
        gx, = torch.autograd.grad(loss, xv, create_graph=True)
        assert gx.dtype == BF16
        hvps.append(torch.autograd.grad((gx.float() * u).sum(), wv)[0])
    assert hvps[0].dtype == BF16
    got, want = (h.double() for h in hvps)
    assert float((got - want).norm() / want.norm()) <= 2.0 ** -7
    assert float((got - want).abs().max()) <= 2.0 ** -6 * float(
        want.abs().max())


def test_split3_is_exact():
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(4096, generator=gen) * torch.logspace(-20, 20, 4096)
    g[:3] = torch.tensor([0.0, 1.0 + 2.0 ** -23, -3.0e38])
    hi, mid, lo = common.split3_bf16(g)
    assert hi.dtype == mid.dtype == lo.dtype == BF16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), g)
    # two terms are not enough: the split needs its third
    assert not torch.equal(hi.float() + mid.float(), g)


@pytest.mark.parametrize("sa,sb", [((64, 256), (256, 96)),
                                   ((4, 48, 64), (4, 64, 80))])
def test_matmul_f32_grads_within_one_step(sa, sb):
    """``matmul_f32_grads`` on CPU tensors (2-d and batched) against
    ``bf16`` of the f64 product of the f32 cotangent and the bf16
    operand: within one bf16 step, zero beyond; ``need`` skips a
    gradient."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(sa, generator=gen).to(BF16)
    b = torch.randn(sb, generator=gen).to(BF16)
    g = torch.randn(sa[:-1] + sb[-1:], generator=gen)
    da, db = common.matmul_f32_grads(a, b, g)
    want_a = (g.double() @ b.double().transpose(-1, -2)).float()
    want_b = (a.double().transpose(-1, -2) @ g.double()).float()
    assert _beyond(da, want_a.numpy()) == 0 and da.dtype == BF16
    assert _beyond(db, want_b.numpy()) == 0 and db.dtype == BF16
    assert common.matmul_f32_grads(a, b, g, (False, True))[0] is None
    assert common.matmul_f32_grads(a, b, g, (True, False))[1] is None
