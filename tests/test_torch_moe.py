"""The port's MoE FFN (``repro_torch/models/moe.py``) against the
reference's (``repro/models/moe.py``), on the CPU.

- ``moe.apply`` on the same parameters (the reference's init, carried
  over by ``convert.params_from_jax``) and the same numpy-seeded input,
  for reduced phi35_moe (4 experts, top 2) and for qwen3_moe reduced with
  16 experts and its top 8: the output, the aux loss and the gradients of
  ``sum(out * cotangent) + aux`` in the input and every parameter
  (``jax.grad`` against autograd) within 2e-5 in f32, relative to each
  array's largest magnitude (the init's expert weights, of std
  ``1/sqrt(E)``, give outputs and gradients of order 100, whose sums
  cancel to small values in places); again with
  ``capacity_factor`` 0.5, where choices are dropped (asserted), and with
  several routing groups (1,024 tokens: two groups of 512).
- Ties between gates go to the lower expert index, as ``jax.lax.top_k``.
- ``group_size=1`` (the serve steps' per-slot routing) is the reference's
  routing of each token as a batch of one.
- bf16 and f32 of the same inputs route the same choices and drop the same
  ones (the router runs in f32 on the same values).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want, what=""):
    """``|got - want| <= 2e-5 |want| + 2e-5 max |want|``."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=2e-5 * float(np.abs(want).max()),
                               err_msg=what)
CASES = {
    "phi35_moe": ("phi35_moe", {}),
    "qwen3_moe_16x8": ("qwen3_moe", dict(num_experts=16, experts_per_token=8)),
    "phi35_moe_drops": ("phi35_moe", dict(capacity_factor=0.5)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so this file's tests do not
    crowd out the suite's other workers; the worker's count comes back
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layer(arch, over, seed=0):
    """(reference cfg, port cfg, reference params, port params) of one MoE
    layer, the port's a copy of the reference's."""
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = registry.get_config(arch).reduced(**over)
    jp = jax.device_get(jmoe.init_params(jax.random.PRNGKey(seed), jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x, cot


def _dropped(tcfg, tp, x, group_size=None):
    b, s, d = x.shape
    gs = group_size or moe._group_size(b * s)
    r = moe.route(tcfg, tp, torch.from_numpy(x).reshape(-1, gs, d))
    return int(r.onehot.sum()) - int(r.kept.sum())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("b,s", [(2, 16), (2, 512)])
def test_apply_and_grads_match_reference(case, b, s):
    arch, over = CASES[case]
    jcfg, tcfg, jp, tp = _layer(arch, over)
    x, cot = _inputs(tcfg, b, s)

    def jloss(p, xx):
        out, aux = jmoe.apply(jcfg, p, xx)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.apply(tcfg, params, xt)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)) + aux,
                                [xt] + list(params.values()))
    _close(out.detach().numpy(), jout, "out")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    assert aux.dtype == torch.float32
    _close(grads[0].numpy(), jgx, "x")
    for name, g in zip(params, grads[1:]):
        _close(g.numpy(), jgp[name], name)
    if over.get("capacity_factor", 1.25) < 1:
        assert _dropped(tcfg, tp, x) > 0


def test_capacity_is_per_group_and_positions_follow_token_order():
    """Two tokens, four experts, top 2: one slot an expert (``int(1.25 *
    2 * 2 / 4) = 1``); the first token's choices always find their slot,
    the second's are dropped where they meet them."""
    _, tcfg, _, tp = _layer("phi35_moe", {})
    x = _inputs(tcfg, 1, 2, seed=3)[0]
    r = moe.route(tcfg, tp, torch.from_numpy(x))
    assert r.capacity == 1
    first, second = r.onehot[0, 0].sum(0), r.onehot[0, 1].sum(0)
    assert torch.equal(r.kept[0, 0].sum(0), first.to(torch.bool))
    assert torch.equal(r.kept[0, 1].sum(0),
                       (second * (1 - first)).to(torch.bool))


def test_top_k_ties_go_to_the_lower_index():
    gates = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jone, jval = jmoe._top_k_mask(jnp.asarray(gates), k)
        tone, tval = moe._top_k_mask(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(tone.numpy(), np.asarray(jone))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


def test_group_size_one_is_batch_one_routing():
    """``group_size=1`` routes each token alone: the reference's
    ``apply`` on each token as a batch of one, row for row, while one
    group of all the tokens drops some of them."""
    jcfg, tcfg, jp, tp = _layer("phi35_moe", {})
    x, _ = _inputs(tcfg, 6, 1, seed=1)
    out, _ = moe.apply(tcfg, tp, torch.from_numpy(x), group_size=1)
    want = np.concatenate([np.asarray(jmoe.apply(jcfg, jp, jnp.asarray(
        x[i:i + 1]))[0]) for i in range(len(x))])
    _close(out.numpy(), want)
    assert _dropped(tcfg, tp, x, group_size=1) == 0
    assert _dropped(tcfg, tp, x) > 0
    joint, _ = moe.apply(tcfg, tp, torch.from_numpy(x))
    assert not torch.allclose(joint, out, **TOL)


def test_bf16_routes_and_drops_as_f32():
    """The router runs in f32 on the same values: a bf16 layer and its f32
    copy on a bf16-representable input choose and drop the same (token,
    expert) pairs, and the outputs agree within bf16's rounding."""
    _, tcfg, _, tp = _layer("phi35_moe", dict(capacity_factor=0.5))
    x = torch.from_numpy(_inputs(tcfg, 2, 32, seed=2)[0]).bfloat16()
    p16 = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
    p32 = {k: v.float() for k, v in p16.items()}
    cfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    gs = moe._group_size(64)
    r16 = moe.route(cfg16, p16, x.reshape(-1, gs, tcfg.d_model))
    r32 = moe.route(tcfg, p32, x.float().reshape(-1, gs, tcfg.d_model))
    assert torch.equal(r16.onehot, r32.onehot)
    assert torch.equal(r16.kept, r32.kept)
    assert int(r16.onehot.sum()) > int(r16.kept.sum())
    out16, aux16 = moe.apply(cfg16, p16, x)
    out32, aux32 = moe.apply(tcfg, p32, x.float())
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(float(aux16), float(aux32), rtol=1e-6)
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=2 ** -6, atol=2e-2 * float(
                                   out32.abs().max()))
