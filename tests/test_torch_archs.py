"""The port's remaining decoder architectures against the reference, on
the CPU: the dense lm_1b, lm_8b, yi_34b, internlm2_20b and qwen2_72b (qkv
bias), the MoE phi35_moe and qwen3_moe, and the VLM llava_next_34b.

- ``registry.ARCH_IDS`` is the reference's thirteen; each config equals
  the reference's field for field, full and reduced, and ``param_count`` /
  ``active_param_count`` equal the reference's for all thirteen
  architectures; the port's tensors hold exactly ``param_count`` weights
  but the vocabulary padding (and, in the encoder-decoder, the norms the
  reference's formula leaves out). The encoder-decoder's own tests are in
  ``tests/test_torch_encdec.py``.
- ``loss_fn`` and every gradient of each new architecture, reduced, f32,
  within 2e-5 (rtol = atol, the reference's model tolerance) of
  ``jax.value_and_grad`` of the reference's, from the reference's
  parameters (``convert.params_from_jax``); qwen2_72b with nonzero biases
  set in both packages (zero ones would show nothing), llava_next_34b with
  8 patch embeddings before the tokens and the loss on the text tail, the
  MoE configs with their aux loss; with ``blocked`` attention (K2's plain
  path) as well for one of each family.
- qwen2_72b's biases through prefill, decode and chunked prefill;
  llava_next_34b's prefill with embeddings (``make_prefill_fn``: logits
  and caches of patches + prompt) and decode steps after it.
- One flat local-SGD round of reduced phi35_moe against the reference's
  round, atol 1e-5.
- ``convert`` round-trips the MoE leaves (the router in f32 beside bf16
  experts) and the biases bitwise.
- ``launch.train --arch phi35_moe --reduced --device cpu`` prints the
  reference's final line.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.data import grouped as jgrouped  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.models import blocks, registry, transformer, vlm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
NEW_ARCHS = ("lm_1b", "lm_8b", "yi_34b", "internlm2_20b", "qwen2_72b",
             "phi35_moe", "qwen3_moe", "llava_next_34b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so this file's tests do not
    crowd out the suite's other workers; the worker's count comes back
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _with_biases(jcfg, jparams, seed=5):
    """The reference's parameters with nonzero numpy biases (its init makes
    them zero)."""
    if not jcfg.qkv_bias:
        return jparams
    rng = np.random.default_rng(seed)
    attn = dict(jparams["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(0.5 * rng.standard_normal(
            attn[name].shape).astype(np.float32)).astype(attn[name].dtype)
    layers = dict(jparams["layers"], attn=attn)
    return dict(jparams, layers=layers)


def _models(arch, **over):
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = registry.get_config(arch).reduced(**over)
    jparams = _with_biases(jcfg, jreg.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = convert.params_from_jax(tcfg, jax.device_get(jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, b=2, s=16, seed=0):
    """A training batch in numpy: tokens and labels, and for a VLM
    ``num_frontend_tokens`` patch embeddings before the tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# configs and parameter accounting
# ---------------------------------------------------------------------------


def test_arch_ids_are_the_references_thirteen():
    assert len(registry.ARCH_IDS) == 13
    assert set(registry.ARCH_IDS) == set(jreg.ARCH_IDS)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_config_equals_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    for full in (True, False):
        j, t = (jcfg, tcfg) if full else (jcfg.reduced(), tcfg.reduced())
        names = [f.name for f in dataclasses.fields(t)]
        assert names == [f.name for f in dataclasses.fields(j)]
        for name in names:
            assert getattr(t, name) == getattr(j, name), (arch, full, name)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    for j, t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.layer_params() == j.layer_params()
        assert t.active_layer_params() == j.active_layer_params()
    if tcfg.family == "moe":
        assert tcfg.active_param_count() < tcfg.param_count()
    if tcfg.family in ("dense", "moe", "vlm"):
        # the reference's formulas are exact for attention stacks (its RG-LRU
        # and RWKV terms are approximations): the port's tensors hold them,
        # but the vocabulary's padding to a multiple of 512
        small = tcfg.reduced()
        params = registry.init_params(small, seed=0, device="cpu")
        pad = transformer.padded_vocab(small) - small.vocab_size
        assert sum(p.numel() for p in params.values()) == (
            small.param_count() + 2 * pad * small.d_model)
    if tcfg.is_encoder_decoder:
        # and the decoder's ln_x and the encoder's final norm, which the
        # reference's formula leaves out
        small = tcfg.reduced()
        params = registry.init_params(small, seed=0, device="cpu")
        pad = transformer.padded_vocab(small) - small.vocab_size
        assert sum(p.numel() for p in params.values()) == (
            small.param_count() + 2 * pad * small.d_model
            + (small.num_layers + 1) * small.d_model)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,attn_impl",
                         [(a, "naive") for a in NEW_ARCHS]
                         + [(a, "blocked") for a in ("qwen2_72b", "phi35_moe",
                                                     "llava_next_34b")])
def test_loss_and_grads_match_reference(arch, attn_impl):
    jcfg, tcfg, jparams, tparams = _models(arch, attn_impl=attn_impl)
    nb = _batch(jcfg)
    want, wgrads = jax.value_and_grad(functools.partial(jreg.loss_fn, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    params = {k: v.requires_grad_(True) for k, v in tparams.items()}
    loss = registry.loss_fn(tcfg, params,
                            {k: torch.from_numpy(v) for k, v in nb.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    got = dict(_leaves(convert.params_to_numpy(tcfg, dict(zip(params, grads)))))
    want_leaves = dict(_leaves(jax.device_get(wgrads)))
    assert set(got) == set(want_leaves)
    for name, g in got.items():
        np.testing.assert_allclose(g, want_leaves[name], err_msg=name, **TOL)
    if tcfg.qkv_bias:
        assert all(np.abs(got[f"layers.attn.{b}"]).max() > 0
                   for b in ("bq", "bk", "bv"))


def test_moe_block_returns_its_aux_loss():
    """Train mode returns (x, aux): the MoE load-balancing loss, 0.0 for a
    dense block; ``loss_fn`` adds 0.01 of the stack's sum."""
    _, tcfg, _, tparams = _models("phi35_moe")
    _, dcfg, _, dparams = _models("lm_1b")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(8).expand(2, 8)
    _, aux = blocks.block_apply(tcfg, "attention",
                                transformer.layer_params(tparams, 0), x, pos)
    assert aux.shape == () and float(aux) > 0
    assert blocks.block_apply(dcfg, "attention",
                              transformer.layer_params(dparams, 0), x,
                              pos)[1] == 0.0
    nb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with torch.no_grad():
        emb = torch.nn.functional.embedding(nb["tokens"].long(),
                                            tparams["embed.table"])
        b, seq = nb["tokens"].shape
        _, total = transformer.apply_layers(tcfg, tparams, emb,
                                            torch.arange(seq).expand(b, seq))
        logits = transformer.forward(tcfg, tparams, nb["tokens"])
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), nb["labels"].reshape(-1).long())
        np.testing.assert_allclose(
            float(registry.loss_fn(tcfg, tparams, nb)),
            float(ce + 0.01 * total), rtol=1e-6)


# ---------------------------------------------------------------------------
# serving paths: qkv bias and VLM embeddings
# ---------------------------------------------------------------------------


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


def test_qkv_bias_in_prefill_decode_and_chunks():
    jcfg, tcfg, jparams, tparams = _models("qwen2_72b")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jparams, jnp.asarray(toks), max_len=16)
    with torch.no_grad():
        tl, tc = transformer.prefill(tcfg, tparams, torch.from_numpy(toks),
                                     max_len=16)
    _close(tl, jl, "prefill")
    for i in range(3):
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jc = jtr.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = transformer.decode_step(tcfg, tparams,
                                             torch.from_numpy(tok), tc)
        _close(tl, jl, f"decode {i}")
    jcc = jtr.init_caches(jcfg, 2, 16, ring=False)
    tcc = transformer.init_caches(tcfg, 2, 16, ring=False, device="cpu")
    pos = 0
    for c in (8, 4):
        jl, jcc = jtr.chunk_prefill(jcfg, jparams, jnp.asarray(
            toks[:, pos:pos + c]), jcc, jnp.int32(pos))
        with torch.no_grad():
            tl, tcc = transformer.chunk_prefill(
                tcfg, tparams, torch.from_numpy(toks[:, pos:pos + c]), tcc,
                pos)
        _close(tl, jl, f"chunk at {pos}")
        pos += c


def test_vlm_prefill_with_embeddings_and_decode():
    jcfg, tcfg, jparams, tparams = _models("llava_next_34b")
    nb = _batch(jcfg, b=2, s=6, seed=3)
    p = jcfg.num_frontend_tokens
    jl, jc = jreg.make_prefill_fn(jcfg, max_len=p + 10)(
        jparams, {"tokens": jnp.asarray(nb["tokens"]),
                  "embeds": jnp.asarray(nb["embeds"])})
    with torch.no_grad():
        tl, tc = registry.make_prefill_fn(tcfg, max_len=p + 10)(
            tparams, {"tokens": torch.from_numpy(nb["tokens"]),
                      "embeds": torch.from_numpy(nb["embeds"])})
    _close(tl, jl, "prefill logits")
    assert tc[0]["k"].shape[1] == p + 10 and int(tc[0]["pos"]) == p + 6
    want = convert.caches_to_numpy(tcfg, tc)
    for key in ("k", "v", "pos"):
        _close(want[key], jax.device_get(jc)[key], f"cache {key}")
    # the default size holds the patches and the prompt
    with torch.no_grad():
        _, small = vlm.prefill(tcfg, tparams, torch.from_numpy(nb["tokens"]),
                               embeds=torch.from_numpy(nb["embeds"]))
    assert small[0]["k"].shape[1] == p + 6
    decode_j, decode_t = jreg.make_decode_fn(jcfg), registry.make_decode_fn(
        tcfg)
    for i in range(2):
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jc = decode_j(jparams, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = decode_t(tparams, torch.from_numpy(tok), tc)
        _close(tl, jl, f"decode {i}")


def test_model_accepts_frontends_and_refuses_tied_embeddings():
    cfg = registry.get_config("llava_next_34b").reduced()
    assert cfg.frontend == "vision_patches"
    transformer.TransformerLM(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="tied"):
        transformer.TransformerLM(dataclasses.replace(cfg, tie_embeddings=True),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")


# ---------------------------------------------------------------------------
# a round, conversion, the training CLI
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 2, 2, 16


def test_moe_round_matches_reference():
    cohort = 2
    jcfg, tcfg, jparams, tparams = _models("phi35_moe")
    jsamp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                   cohort_size=cohort)
    tsamp = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=cohort)
    jd = jsamp.round_batch(0, STEPS, BATCH, SEQ)
    td = tsamp.round_batch(0, STEPS, BATCH, SEQ, device="cpu")

    def make(mod_rounds, mod_opt, reg, cfg):
        return mod_rounds.make_local_sgd_round(
            functools.partial(reg.loss_fn, cfg), mod_opt.sgd(0.05),
            mod_opt.fedavg_momentum(1.0),
            mod_rounds.LocalSGDConfig(partition_size=cohort,
                                      num_local_steps=STEPS, grad_clip=1.0))

    jnew, _, jm = make(jrounds, jopt, jreg, jcfg)(
        jparams, jopt.fedavg_momentum(1.0).init(jparams),
        {k: jd[k] for k in ("tokens", "labels")})
    tnew, _, tm = make(rounds, optim, registry, tcfg)(
        tparams, optim.fedavg_momentum(1.0).init(tparams),
        {k: td[k] for k in ("tokens", "labels")})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    old = dict(_leaves(jax.device_get(jparams)))
    want = dict(_leaves(jax.device_get(jnew)))
    got = dict(_leaves(convert.params_to_numpy(tcfg, tnew)))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert max(float(np.abs(want[k] - old[k]).max()) for k in old) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["phi35_moe", "qwen2_72b"])
def test_conversion_roundtrips_moe_and_bias_leaves(arch, dtype):
    jcfg = jreg.get_config(arch).reduced(dtype=dtype)
    tcfg = registry.get_config(arch).reduced(dtype=dtype)
    tree = jax.device_get(_with_biases(
        jcfg, jreg.init_params(jax.random.PRNGKey(1), jcfg)))
    params = convert.params_from_jax(tcfg, tree, device="cpu")
    names = {"phi35_moe": ("moe.router", "moe.wi", "moe.wg", "moe.wo"),
             "qwen2_72b": ("attn.bq", "attn.bk", "attn.bv")}[arch]
    for i in range(tcfg.num_layers):
        for n in names:
            want = (torch.float32 if n == "moe.router"
                    else getattr(torch, dtype))
            assert params[f"layers.{i}.{n}"].dtype == want, n
    back = dict(_leaves(convert.params_to_numpy(tcfg, params)))
    for name, leaf in _leaves(tree):
        np.testing.assert_array_equal(back[name], leaf.astype(np.float32),
                                      err_msg=name)
    model = transformer.TransformerLM(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            model.named_parameters()} == {
        k: (tuple(v.shape), v.dtype) for k, v in params.items()}


def test_train_cli_moe_reduced_on_cpu(tmp_path):
    """A fresh run: its own ``--ckpt-dir``, since ``launch.train`` resumes
    from whatever its checkpoint directory holds."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi35_moe", "--reduced", "--device", "cpu", "--rounds", "2",
         "--cohort", "2", "--local-steps", "1", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == {"arch", "algorithm", "rounds", "restarts",
                         "first_loss", "final_loss"}
    assert line["arch"] == "phi35_moe" and line["rounds"] == 2
    assert np.isfinite(line["final_loss"])
