"""The port's lm_350m (reduced: f32, 2 layers, GQA 4:2) against the
reference: loss and gradients from the same parameters (the reference's
init, carried over by ``params_from_jax``) and the same tokens, at
rtol = atol = 2e-5, the reference's own f32 tolerance
(``tests/test_kernels.py``). Both attention dispatches are covered:
``naive`` and the flash/blocked one (the reference's online-softmax
``flash_attention_xla`` against the port's ``ops.flash_attention``, whose
CPU path is the plain K2 forward and backward), the latter also with
blocks small enough that the reference scans over many block pairs.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

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
