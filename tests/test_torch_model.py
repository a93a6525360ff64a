"""The port's lm_350m (reduced: f32, 2 layers, GQA 4:2) against the
reference: loss and gradients from the same parameters (the reference's
init, carried over by ``params_from_jax``) and the same tokens, at
rtol = atol = 2e-5, the reference's own f32 tolerance
(``tests/test_kernels.py``). Both attention dispatches are covered:
``naive`` and the flash/blocked one (the reference's online-softmax
``flash_attention_xla`` against the port's ``ops.flash_attention``, whose
CPU path is the plain K2 forward and backward), the latter also with
blocks small enough that the reference scans over many block pairs.

Also: ``remat="dots"`` (selective checkpointing that saves the matrix
products without batch dims) gives loss and gradients bitwise those of
``remat="none"``, and the bf16 gated FFN (dense ``mlp.apply`` and the MoE
layer) keeps its up and gate products in f32, as the reference's
``preferred_element_type=f32``: every output within one bf16 step of
``jax.jit`` of the reference.
"""

import contextlib
import dataclasses
import functools
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mlp as jmlp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import common, mlp, moe, registry, transformer  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _configs(**over):
    jcfg = jreg.get_config("lm_350m").reduced(**over)
    tcfg = registry.get_config("lm_350m").reduced(**over)
    return jcfg, tcfg


def _batch(cfg, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _check_loss_and_grads(seq, **over):
    jcfg, tcfg = _configs(**over)
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.remat) == (4, 2, "full")
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tokens, labels = _batch(jcfg, s=seq)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, wgrads = jax.value_and_grad(functools.partial(jreg.loss_fn, jcfg))(
        jparams, jbatch)

    params = {k: v.requires_grad_(True) for k, v in convert.params_from_jax(
        tcfg, jax.device_get(jparams), device="cpu").items()}
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    loss = registry.loss_fn(tcfg, params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    got = convert.params_to_numpy(tcfg, dict(zip(params, grads)))
    want_leaves = dict(_leaves(jax.device_get(wgrads)))
    got_leaves = dict(_leaves(got))
    assert set(got_leaves) == set(want_leaves)
    for name, g in got_leaves.items():
        np.testing.assert_allclose(g, want_leaves[name], err_msg=name, **TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_loss_and_grads_match_reference(attn_impl):
    _check_loss_and_grads(16, attn_impl=attn_impl)


def test_multi_block_flash_matches_reference():
    """seq 48 with q_block 8, kv_block 16: the reference's
    ``flash_attention_xla`` runs 6 x 3 block pairs with causal skipping,
    forward and backward; the port's K2 path does not tile by them."""
    _check_loss_and_grads(48, attn_impl="blocked", q_block=8, kv_block=16)


def test_conversion_roundtrip_and_module():
    jcfg, tcfg = _configs()
    jparams = jax.device_get(jreg.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert.params_from_jax(tcfg, jparams, device="cpu")
    back = dict(_leaves(convert.params_to_numpy(tcfg, params)))
    for name, leaf in _leaves(jparams):
        np.testing.assert_array_equal(back[name], leaf)

    model = transformer.TransformerLM(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
        tokens, _ = _batch(jcfg)
        logits = model(torch.from_numpy(tokens))
        want = jreg.family_module(jcfg).forward(jcfg, jparams, jnp.asarray(tokens))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_bf16_params_carry_over():
    jcfg = jreg.get_config("lm_350m").reduced(dtype="bfloat16")
    tcfg = registry.get_config("lm_350m").reduced(dtype="bfloat16")
    jparams = jax.device_get(jreg.init_params(jax.random.PRNGKey(2), jcfg))
    params = convert.params_from_jax(tcfg, jparams, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    back = dict(_leaves(convert.params_to_numpy(tcfg, params)))
    for name, leaf in _leaves(jparams):
        np.testing.assert_array_equal(back[name], leaf.astype(np.float32))


def test_init_requires_explicit_cpu_without_a_card():
    cfg = registry.get_config("lm_350m").reduced()
    params = registry.init_params(cfg, seed=0, device="cpu")
    assert all(p.device.type == "cpu" for p in params.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            registry.init_params(cfg, seed=0)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            convert.params_from_jax(cfg, {})


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,attn_impl", [("lm_350m", "naive"),
                                            ("lm_350m", "blocked"),
                                            ("phi35_moe", "blocked"),
                                            ("recurrentgemma_2b", "blocked")])
def test_remat_dots_is_bitwise_none(arch, attn_impl):
    """Loss and every gradient bitwise those of ``remat="none"`` (and of
    ``"full"``); the dense stack's backward recomputes K2's forward and
    the activations but none of the products without batch dims, which
    ``"full"`` recomputes."""
    cfg = registry.get_config(arch).reduced(attn_impl=attn_impl)
    params = registry.init_params(cfg, seed=0, device="cpu")
    batch = registry.make_batch(cfg, 2, 16, seed=3, device="cpu")
    runs = {}
    for remat in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with _CountOps() as counted:
            loss = registry.loss_fn(c, p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
        runs[remat] = (loss.detach(), grads, counted.counts)
    for remat in ("dots", "full"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        for a, b in zip(runs[remat][1], runs["none"][1]):
            assert torch.equal(a, b), remat
    if arch == "lm_350m" and attn_impl == "blocked":
        none, dots, full = (runs[r][2] for r in ("none", "dots", "full"))
        mm = "aten.mm.default"
        assert dots[mm] == none[mm] < full[mm]
        fwd = "repro.flash_attention_fwd.default"
        assert dots[fwd] == full[fwd] == 2 * none[fwd]


# ---------------------------------------------------------------------------
# the bf16 FFN products
# ---------------------------------------------------------------------------


def _f32_einsum_shim(module):
    """``module.jnp`` with ``einsum(..., preferred_element_type=f32)``
    taking f32 copies of its operands: the same values (exact products of
    the bf16 inputs summed in f32). XLA's CPU backend refuses the MoE's
    batched bf16 x bf16 -> f32 dot ("Unsupported element type for
    DotThunk"), which the reference runs on a TPU."""
    jnp_mod = module.jnp

    class Shim(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jnp_mod, name)

    shim = Shim("jnp")

    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return jnp_mod.einsum(spec, *operands,
                              preferred_element_type=preferred_element_type,
                              **kw)

    shim.einsum = einsum
    return mock.patch.object(module, "jnp", shim)


@pytest.mark.parametrize("arch", ["lm_350m", "phi35_moe"])
def test_bf16_ffn_within_one_step_of_reference(arch):
    """lm_350m's gated FFN and phi35_moe's MoE layer at d 256, FFN width
    1024, x (2, 64, 256) bf16 (the reference's init and seeded normals):
    every output within one bf16 step (``2^-7 |want| + 1e-3 max |want|``)
    of ``jax.jit`` of the reference. With the up and gate products rounded
    to bf16 before the gate (the port before this test) 1,428 of the
    32,768 dense outputs and 1,351 of the MoE's were beyond it."""
    over = dict(dtype="bfloat16", d_model=256, d_ff=1024)
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = registry.get_config(arch).reduced(**over)
    mod, port = (jmoe, moe) if tcfg.family == "moe" else (jmlp, mlp)
    jp = jax.device_get(mod.init_params(jax.random.PRNGKey(0), jcfg))
    tp = {k: convert._to_tensor(v, "cpu") for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((2, 64, 256)).astype(
        np.float32)
    xt = torch.from_numpy(x).bfloat16()
    shim = (_f32_einsum_shim(mod) if mod is jmoe
            else contextlib.nullcontext())
    with shim:
        want = jax.jit(lambda p, v: mod.apply(jcfg, p, v))(
            jp, jnp.asarray(x).astype(jnp.bfloat16))
    got = port.apply(tcfg, tp, xt)
    if mod is jmoe:
        (want, want_aux), (got, got_aux) = want, got
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=1e-5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32), np.float64)
    diff = np.abs(got.double().numpy() - want)
    lim = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    assert int((diff > lim).sum()) == 0, (int((diff > lim).sum()),
                                          float(diff.max()))


def test_matmul_f32_on_the_cpu():
    """f32 inputs: ``torch.matmul`` itself; bf16: the product of f32 copies
    (exact products summed in f32), 2-d weights and batched 3-d, with the
    gradients of that product."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 3, generator=g)
    assert torch.equal(common.matmul_f32(a, w), torch.matmul(a, w))
    a16, w16 = a.bfloat16().requires_grad_(), w.bfloat16().requires_grad_()
    out = common.matmul_f32(a16, w16)
    assert out.dtype == torch.float32
    assert torch.equal(out, torch.matmul(a16.float(), w16.float()))
    da, dw = torch.autograd.grad(out.sum(), (a16, w16))
    assert da.dtype == dw.dtype == torch.bfloat16
    e = torch.randn(4, 6, 8, generator=g).bfloat16()
    we = torch.randn(4, 8, 3, generator=g).bfloat16()
    assert torch.equal(common.matmul_f32(e, we),
                       torch.bmm(e.float(), we.float()))
