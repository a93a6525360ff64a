"""K5 (the RWKV-6 WKV recurrence) and the ssm rwkv6_3b family of the port
against the reference, on the CPU.

- The plain forward (``ref.wkv6_ref``, the sequential recurrence) against
  the Pallas kernel run in interpret mode at the reference's own kernel
  test shapes and decay law (``tests/test_kernels.py``: ``logw =
  -exp(0.5 N(0, 1))``), and against the reference's ``wkv6_ref``,
  ``sequential_wkv`` and ``chunked_wkv``, at the reference's WKV
  tolerance, 1e-4.
- The plain backward (``ref.wkv6_bwd_ref``) against ``jax.vjp`` of
  ``sequential_wkv``, within 1e-4 of each gradient's largest magnitude,
  under the mild law and under decays drawn as the model draws them
  (``-exp(w0 + lora)``, ``w0 ~ N(0, 0.5)`` per channel).
- ``ops.wkv6`` (the autograd Function) on CPU tensors against PyTorch's
  autograd through the plain forward, also under non-reentrant
  checkpointing.
- The time mix and channel mix, and the reduced model (f32, 2 layers,
  one head of 64) at seq 16, where the reference is finite: the output,
  the loss and every gradient at rtol = atol = 2e-5; the stacked tree
  through ``convert``, bf16 and f32 leaves side by side.
- One flat round of the reduced model against the reference's (un-jitted,
  ROADMAP.md R1) round, uncompressed (atol 1e-5) and int8 (each element
  within one quantization step of its 256-wide row plus 1e-6, and at
  least 95% of the new parameters bitwise equal).
- R5, shown: at seq 64 the reference's ``chunked_wkv`` (the model's
  training path) and its reduced model give non-finite values under the
  model's own decays, its ``sequential_wkv`` does not; the port is finite,
  within 1e-4 of ``sequential_wkv``, and its reduced model matches the
  reference model with ``chunked_wkv`` replaced by ``sequential_wkv`` (the
  same contract; the replacement lives in this test only).
- ``launch.train --arch rwkv6_3b --reduced --device cpu`` prints the
  reference's final JSON line; without ``--device cpu`` it raises where
  there is no card.

The CUDA kernels are held to the plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import registry, rwkv, transformer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "rwkv6_3b"
TOL = dict(rtol=2e-5, atol=2e-5)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py:139


def _wkv_inputs(seed, b, s, h, n, law="mild"):
    """r, k, v and the output gradient standard normal, u = 0.1 N(0, 1)
    (the reference test's), and logw by ``law``: "mild" is the reference
    test's ``-exp(0.5 N(0, 1))``; "model" is ``-exp(w0 + lora)`` with
    ``w0 ~ N(0, 0.5)`` per channel (``rwkv.py:47``) and lora ``0.3 N(0,
    1)`` per step, whose strongest channels pass a cumulative log-decay of
    -88 inside a 64-step chunk."""
    rng = np.random.default_rng(seed)
    r, k, v, do = rng.standard_normal((4, b, s, h, n))
    if law == "mild":
        lw = -np.exp(0.5 * rng.standard_normal((b, s, h, n)))
    else:
        w0 = 0.5 * rng.standard_normal((h, n))
        lw = -np.exp(w0 + 0.3 * rng.standard_normal((b, s, h, n)))
    u = 0.1 * rng.standard_normal((h, n))
    return tuple(np.asarray(t, np.float32) for t in (r, k, v, lw, u, do))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _assert_rel(got, want, rel, what=""):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize(
    "b,s,h,n,chunk", [(1, 16, 1, 8, 8), (2, 48, 2, 8, 16), (1, 50, 3, 16, 16)]
)
def test_plain_wkv_matches_pallas_kernel(b, s, h, n, chunk):
    r, k, v, lw, u, _ = _wkv_inputs(b * s + n, b, s, h, n)
    j = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    kernel = np.asarray(jops.wkv6(*j, chunk=chunk, interpret=True))
    oracle = np.asarray(jref.wkv6_ref(*j))
    t = [_t(x) for x in (r, k, v, lw, u)]
    for got in (ref.wkv6_ref(*t), ops.wkv6(*t)[0]):
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, n)
        np.testing.assert_allclose(_np(got), kernel, **WKV_TOL)
        np.testing.assert_allclose(_np(got), oracle, **WKV_TOL)


@pytest.mark.parametrize("b,s,h,n", [(2, 32, 2, 8), (1, 130, 2, 16)])
def test_plain_wkv_matches_model_paths(b, s, h, n):
    """The reference model's sequential oracle and, under the mild law
    where its factors stay finite, its chunked form; the chunk states the
    plain forward returns are the sequential states at each 64th step, and
    its final state the sequential final state."""
    r, k, v, lw, u, _ = _wkv_inputs(s + n, b, s, h, n)
    j = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    seq_out, seq_final = jrwkv.sequential_wkv(*j)
    chunk_out, _ = jrwkv.chunked_wkv(*j, chunk=16)
    out, states, final = ref.wkv6_fwd_ref(*(_t(x) for x in (r, k, v, lw, u)))
    np.testing.assert_allclose(_np(out), np.asarray(seq_out), **WKV_TOL)
    np.testing.assert_allclose(_np(final), np.asarray(seq_final), **WKV_TOL)
    np.testing.assert_allclose(_np(out), np.asarray(chunk_out), **WKV_TOL)
    assert tuple(states.shape) == (b, h, -(-s // 64), n, n)
    for c in range(states.shape[2]):
        if c == 0:
            want = np.zeros((b, h, n, n), np.float32)
        else:
            want = np.asarray(jrwkv.sequential_wkv(
                *(x[:, :64 * c] for x in j[:4]), j[4])[1])
        np.testing.assert_allclose(_np(states[:, :, c]), want, **WKV_TOL)


@pytest.mark.parametrize("law", ["mild", "model"])
@pytest.mark.parametrize("b,s,h,n", [(1, 16, 1, 8), (2, 70, 2, 16)])
def test_plain_backward_matches_vjp(b, s, h, n, law):
    r, k, v, lw, u, do = _wkv_inputs(7 * s + n, b, s, h, n, law)
    out, pullback = jax.vjp(lambda *a: jrwkv.sequential_wkv(*a)[0],
                            *(jnp.asarray(x) for x in (r, k, v, lw, u)))
    want = pullback(jnp.asarray(do))
    got = ref.wkv6_bwd_ref(*(_t(x) for x in (r, k, v, lw, u, do)))
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _assert_rel(_np(g), np.asarray(w), 1e-4, name)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_autograd_function_matches_plain_autograd(checkpointed):
    r, k, v, lw, u, do = _wkv_inputs(3, 2, 70, 2, 8, "model")

    def grads(fn):
        leaves = [_t(x).requires_grad_() for x in (r, k, v, lw, u)]
        if checkpointed:
            out = torch.utils.checkpoint.checkpoint(fn, *leaves,
                                                    use_reentrant=False)
        else:
            out = fn(*leaves)
        return (out,) + torch.autograd.grad(out, leaves, _t(do))

    ops.reset_launches()
    got = grads(lambda *a: ops.wkv6(*a)[0])
    want = grads(ref.wkv6_ref)
    for gt, wt in zip(got, want):
        _assert_rel(_np(gt), _np(wt), 1e-5)
    # CPU tensors take the plain versions: no kernel launched
    counts = ops.launch_counts()
    assert counts["wkv6_fwd"] == counts["wkv6_bwd"] == 0


def _configs(**over):
    return (jreg.get_config(ARCH).reduced(**over),
            registry.get_config(ARCH).reduced(**over))


def test_config_and_reduced_config_are_the_references():
    jcfg, tcfg = _configs()
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "rwkv_head_dim", "d_ff",
              "vocab_size", "attention", "dtype", "remat", "scan_layers")
    for field in fields:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    jfull, tfull = jreg.get_config(ARCH), registry.get_config(ARCH)
    for field in fields:
        assert getattr(tfull, field) == getattr(jfull, field), field
    assert (tcfg.num_layers, tcfg.d_model, rwkv.num_heads(tcfg)) == (2, 64, 1)
    assert (tfull.num_layers, tfull.d_model, rwkv.num_heads(tfull),
            tfull.d_ff, tfull.vocab_size) == (32, 2560, 40, 8960, 65536)


def _block_params(jcfg, seed):
    """The reference's block init, with the static mixes and the group-norm
    scale drawn away from their constant init so the test sees them."""
    jp = jrwkv.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    d = jcfg.d_model
    return dict(jp, mix=jnp.asarray(rng.uniform(0, 1, (5, d)), jnp.float32),
                cm_rk=jnp.asarray(rng.uniform(0, 1, (2, d)), jnp.float32),
                ln_scale=jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32))


def test_time_mix_and_channel_mix_match_reference():
    jcfg, tcfg = _configs()
    jp = _block_params(jcfg, 3)
    x = np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model))
    x = x.astype(np.float32)
    want_tm, _ = jrwkv.time_mix(jcfg, jp, jnp.asarray(x))
    want_cm, _ = jrwkv.channel_mix(jcfg, jp, jnp.asarray(x))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    np.testing.assert_allclose(_np(rwkv.time_mix(tcfg, tp, _t(x))[0]),
                               np.asarray(want_tm), **TOL)
    np.testing.assert_allclose(_np(rwkv.channel_mix(tcfg, tp, _t(x))[0]),
                               np.asarray(want_cm), **TOL)


def _batch(cfg, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else sorted(tree.items())
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _loss_and_grads(jcfg, tcfg, seq, seed=0):
    """The reference's and the port's loss and gradients from the same
    parameters and tokens: ((jloss, jgrads), (tloss, tgrads)), gradients
    as flat dicts of the reference's leaf names."""
    jparams = jreg.init_params(jax.random.PRNGKey(seed), jcfg)
    tokens, labels = _batch(jcfg, s=seq, seed=seed)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(functools.partial(jreg.loss_fn, jcfg))(
        jparams, jbatch)
    params = {k: v.requires_grad_(True) for k, v in convert.params_from_jax(
        tcfg, jax.device_get(jparams), device="cpu").items()}
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    loss = registry.loss_fn(tcfg, params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    got = dict(_leaves(convert.params_to_numpy(tcfg, dict(zip(params, grads)))))
    return ((float(jloss), dict(_leaves(jax.device_get(jgrads)))),
            (float(loss.detach()), got))


def test_reduced_model_loss_and_grads_match_reference():
    """seq 16: every cumulative log-decay of the reference's one chunk
    stays above -88, so its chunked form is finite and holds to 2e-5."""
    jcfg, tcfg = _configs()
    (jloss, jgrads), (tloss, tgrads) = _loss_and_grads(jcfg, tcfg, seq=16)
    assert np.isfinite(jloss)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert set(tgrads) == set(jgrads)
    assert any(".tm.w0" in k for k in tgrads)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **TOL)


def test_conversion_roundtrip_of_stacked_layers():
    jcfg = jreg.get_config(ARCH).reduced(dtype="bfloat16")
    tcfg = registry.get_config(ARCH).reduced(dtype="bfloat16")
    jparams = jax.device_get(jreg.init_params(jax.random.PRNGKey(1), jcfg))
    assert isinstance(jparams["layers"], dict)  # stacked on a leading axis
    params = convert.params_from_jax(tcfg, jparams, device="cpu")
    for leaf in ("w0", "wA", "wB", "u"):
        assert params[f"layers.1.tm.{leaf}"].dtype == torch.float32, leaf
    assert params["layers.1.tm.wr"].dtype == torch.bfloat16
    back = convert.params_to_numpy(tcfg, params)
    assert back["layers"]["tm"]["u"].shape == (2, 64)
    back_leaves = dict(_leaves(back))
    want = dict(_leaves(jparams))
    assert set(back_leaves) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back_leaves[name], leaf, err_msg=name)
    # the module's own parameters have the same names, shapes and dtypes
    model = transformer.TransformerLM(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in params.items()}


STEPS, BATCH, SEQ = 2, 2, 16


def _round(compression, cohort=2):
    jcfg, tcfg = _configs()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    jsamp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                   cohort_size=cohort)
    tsamp = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=cohort)
    jd = jsamp.round_batch(0, STEPS, BATCH, SEQ)
    td = tsamp.round_batch(0, STEPS, BATCH, SEQ, device="cpu")
    jb = {k: jd[k] for k in ("tokens", "labels")}
    tb = {k: td[k] for k in ("tokens", "labels")}

    def make(mod_rounds, mod_opt, reg, cfg):
        return mod_rounds.make_local_sgd_round(
            functools.partial(reg.loss_fn, cfg), mod_opt.sgd(0.05),
            mod_opt.fedavg_momentum(1.0),
            mod_rounds.LocalSGDConfig(partition_size=cohort,
                                      num_local_steps=STEPS, grad_clip=1.0,
                                      compression=compression))

    jround = make(jrounds, jopt, jreg, jcfg)
    tround = make(rounds, optim, registry, tcfg)
    jnew, _, jm = jround(jparams, jopt.fedavg_momentum(1.0).init(jparams), jb)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    tnew, _, tm = tround(params, optim.fedavg_momentum(1.0).init(params), tb)
    return (tcfg, params, tb, dict(_leaves(jax.device_get(jparams))),
            dict(_leaves(jax.device_get(jnew))), float(jm["loss"]),
            dict(_leaves(convert.params_to_numpy(tcfg, tnew))),
            float(tm["loss"]))


def test_uncompressed_rwkv_round_matches_reference():
    _, _, _, old, jnew, jloss, tnew, tloss = _round(None)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert set(tnew) == set(jnew)
    for name, want in jnew.items():
        np.testing.assert_allclose(tnew[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert max(float(np.abs(jnew[k] - old[k]).max()) for k in old) > 0


def _row_step(d: np.ndarray) -> np.ndarray:
    flat = np.abs(d).reshape(-1)
    rows = np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
    step = np.broadcast_to(rows.max(axis=1, keepdims=True) / 127.0, rows.shape)
    return step.reshape(-1)[: flat.size].reshape(d.shape)


def test_int8_rwkv_round_within_one_step():
    """The stacked leaves of both packings fall into rows the same way
    (the port packs its per-layer leaves in the reference's order), so the
    bound is the mean over clients of each client delta's step."""
    cohort = 2
    tcfg, params, tb, old, jnew, jloss, tnew, tloss = _round("int8", cohort)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
        rounds.LocalSGDConfig(partition_size=cohort, num_local_steps=STEPS,
                              grad_clip=1.0))
    with torch.no_grad():
        deltas = [client(params, {k: v[c] for k, v in tb.items()})[0]
                  for c in range(cohort)]
    steps = [{k: _row_step(v) for k, v in
              _leaves(convert.params_to_numpy(tcfg, d))} for d in deltas]
    equal = total = 0
    for name, want in jnew.items():
        tol = sum(s[name] for s in steps) / cohort + 1e-6
        base = old[name]
        assert (np.abs((tnew[name] - base) - (want - base)) <= tol).all(), name
        equal += int((tnew[name] == want).sum())
        total += want.size
    assert equal / total >= 0.95, equal / total


def test_r5_reference_chunked_wkv_overflows_where_the_port_does_not():
    """ROADMAP.md R5: under the model's decay law the reference's chunked
    form (``models/rwkv.py:170``, ``k * exp(-lcw)``) and the Pallas kernel's
    (``kernels/wkv6.py:51``) overflow inside one 64-step chunk; the
    sequential recurrence they stand for is finite, and so is the port."""
    r, k, v, lw, u, _ = _wkv_inputs(5, 1, 64, 2, 64, "model")
    j = [jnp.asarray(x) for x in (r, k, v, lw, u)]
    lcw = np.cumsum(lw, axis=1)
    assert (-lcw[:, -1] > 88.7).any()  # e^{-lcw} leaves f32's range
    chunked = np.asarray(jrwkv.chunked_wkv(*j)[0])
    pallas = np.asarray(jops.wkv6(*j, chunk=64, interpret=True))
    oracle = np.asarray(jrwkv.sequential_wkv(*j)[0])
    assert not np.isfinite(chunked).all()
    assert not np.isfinite(pallas).all()
    assert np.isfinite(oracle).all()
    got = _np(ops.wkv6(*(_t(x) for x in (r, k, v, lw, u)))[0])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, **WKV_TOL)


def test_r5_reduced_model_at_seq_64(monkeypatch):
    """At seq 64 every logit of the reference's reduced model is non-finite
    (its own init; ``chunked_wkv`` overflows); the port's loss and
    gradients are finite and match the reference model with
    ``chunked_wkv`` replaced by ``sequential_wkv`` (the same contract) at
    rtol = atol = 2e-5."""
    jcfg, tcfg = _configs()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tokens, _ = _batch(jcfg, s=64)
    logits = jtransformer.forward(jcfg, jparams, jnp.asarray(tokens))
    if isinstance(logits, tuple):
        logits = logits[0]
    logits = np.asarray(logits)
    assert not np.isfinite(logits).any()
    monkeypatch.setattr(
        jrwkv, "chunked_wkv",
        lambda r, k, v, logw, u, state=None, chunk=64:
            jrwkv.sequential_wkv(r, k, v, logw, u, state=state))
    (jloss, jgrads), (tloss, tgrads) = _loss_and_grads(jcfg, tcfg, seq=64)
    assert np.isfinite(jloss) and np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    for name, g in tgrads.items():
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **TOL)


def test_train_cli_rwkv_reduced_on_cpu(tmp_path):
    """A fresh run: its own ``--ckpt-dir``, since ``launch.train`` resumes
    from whatever its checkpoint directory holds."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--rounds", "2", "--cohort", "2",
         "--local-steps", "1", "--seq", "64", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    # the keys of the final line of the reference's ``launch.train``
    assert set(line) == {"arch", "algorithm", "rounds", "restarts",
                         "first_loss", "final_loss"}
    assert line["arch"] == ARCH and line["rounds"] == 2
    assert np.isfinite(line["first_loss"]) and np.isfinite(line["final_loss"])


def test_train_cli_defaults_to_the_card():
    """Without ``--device cpu`` ``launch.train`` asks for the card, and raises
    where there is none (no quiet CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--rounds", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert '"final_loss"' not in out.stdout
