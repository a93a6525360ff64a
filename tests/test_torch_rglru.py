"""K4 (the RG-LRU scan) and the hybrid recurrentgemma_2b family of the port
against the reference, on the CPU.

- The plain forward against the Pallas kernel run in interpret mode and
  against the reference's sequential oracle, over the shapes of the
  reference's own kernel tests (``tests/test_kernels.py``), at 1e-5 in
  f32 and 2e-2 in bf16; with an initial state against the model's
  associative scan (``repro.models.rglru.lru_scan``) at 1e-5.
- The plain backward (the reverse scan) against ``jax.vjp`` of that
  associative scan, within 2e-5 of each gradient's largest magnitude.
- ``ops.lru_scan`` (the autograd Function) on CPU tensors against
  PyTorch's autograd through the plain forward, also under non-reentrant
  checkpointing.
- ``rglru.apply`` and the reduced hybrid model (f32, recurrent, recurrent,
  attention; MQA 4:1, window 32) against the reference: the block's output,
  the loss and every gradient at rtol = atol = 2e-5, with ``naive`` and
  ``blocked`` attention; the list-of-layers tree through ``convert``.
- One flat round of the reduced hybrid model against the reference's
  (un-jitted) round: atol 1e-5 uncompressed; with int8 each element within
  one quantization step of its 256-wide row plus 1e-6, and at least 95% of
  the new parameters bitwise equal (a roundtrip that did nothing would
  pass the step bound alone).
- ``launch.train`` with ``--arch recurrentgemma_2b --reduced --device
  cpu`` prints the reference's final JSON line; without ``--device cpu`` it
  raises where there is no card.

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
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import registry, rglru  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma_2b"
TOL = dict(rtol=2e-5, atol=2e-5)


def _scan_inputs(seed, b, s, w):
    """a in (0, 1) (a sigmoid, as the RG-LRU decay), b and the output
    gradient g standard normal, h0 standard normal; numpy f32."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    x, g = rng.standard_normal((2, b, s, w))
    h0 = rng.standard_normal((b, w))
    return tuple(np.asarray(t, np.float32) for t in (a, x, g, h0))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "b,s,w,chunk,wb",
    [(1, 16, 8, 8, 8), (2, 40, 24, 16, 8), (2, 100, 32, 32, 32)],
)
def test_plain_scan_matches_pallas_kernel(b, s, w, chunk, wb, dtype):
    a, x, _, _ = _scan_inputs(b * s + w, b, s, w)
    ja, jx = jnp.asarray(a, dtype), jnp.asarray(x, dtype)
    kernel = np.asarray(jops.lru_scan(ja, jx, chunk=chunk, width_block=wb,
                                      interpret=True), np.float32)
    oracle = np.asarray(jref.lru_scan_ref(ja, jx), np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    # the same (bf16-rounded) inputs on both sides
    ta, tx = _t(np.asarray(ja, np.float32), tdt), _t(np.asarray(jx, np.float32), tdt)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else \
        dict(rtol=1e-5, atol=1e-5)
    for got in (ref.lru_scan_ref(ta, tx), ops.lru_scan(ta, tx)):
        assert got.dtype == tdt and tuple(got.shape) == (b, s, w)
        np.testing.assert_allclose(_np(got), kernel, **tol)
        np.testing.assert_allclose(_np(got), oracle, **tol)


@pytest.mark.parametrize("b,s,w", [(1, 16, 8), (2, 37, 13), (3, 64, 32)])
def test_initial_state_matches_associative_scan(b, s, w):
    a, x, _, h0 = _scan_inputs(s + w, b, s, w)
    want = np.asarray(jrglru.lru_scan(jnp.asarray(a), jnp.asarray(x),
                                      h0=jnp.asarray(h0)))
    got = ref.lru_scan_ref(_t(a), _t(x), _t(h0))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ops.lru_scan(_t(a), _t(x), _t(h0))), want,
                               rtol=1e-5, atol=1e-5)


def _assert_rel(got, want, rel, what=""):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(1, 16, 8), (2, 45, 13)])
def test_plain_backward_matches_vjp(b, s, w, with_h0):
    a, x, g, h0 = _scan_inputs(7 * s + w, b, s, w)
    if with_h0:
        h, pullback = jax.vjp(
            lambda a_, b_, h_: jrglru.lru_scan(a_, b_, h0=h_),
            jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
        want = pullback(jnp.asarray(g))
    else:
        h, pullback = jax.vjp(jrglru.lru_scan, jnp.asarray(a), jnp.asarray(x))
        want = pullback(jnp.asarray(g))
    th0 = _t(h0) if with_h0 else None
    th = ref.lru_scan_ref(_t(a), _t(x), th0)
    np.testing.assert_allclose(_np(th), np.asarray(h), rtol=1e-5, atol=1e-5)
    da, db, dh0 = ref.lru_scan_bwd_ref(_t(a), th, _t(g), th0)
    assert da.dtype == db.dtype == dh0.dtype == torch.float32
    got = (da, db, dh0) if with_h0 else (da, db)
    for name, gt, wt in zip(("da", "db", "dh0"), got, want):
        _assert_rel(_np(gt), np.asarray(wt), 2e-5, name)


@pytest.mark.parametrize("checkpointed", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_autograd_function_matches_plain_autograd(with_h0, checkpointed):
    a, x, g, h0 = _scan_inputs(3, 2, 33, 11)

    def grads(fn):
        leaves = [_t(a).requires_grad_(), _t(x).requires_grad_()]
        if with_h0:
            leaves.append(_t(h0).requires_grad_())
        args = leaves + ([] if with_h0 else [None])
        if checkpointed:
            out = torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False)
        else:
            out = fn(*args)
        return (out,) + torch.autograd.grad(out, leaves, _t(g))

    ops.reset_launches()
    got = grads(ops.lru_scan)
    want = grads(ref.lru_scan_ref)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(_np(gt), _np(wt), rtol=2e-5, atol=2e-5)
    # CPU tensors take the plain versions: no kernel launched
    assert ops.launch_counts()["lru_scan_fwd"] == 0


def _configs(**over):
    return (jreg.get_config(ARCH).reduced(**over),
            registry.get_config(ARCH).reduced(**over))


def test_reduced_config_is_the_references():
    jcfg, tcfg = _configs()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "window_size",
                  "block_pattern", "lru_width", "act", "dtype", "remat",
                  "attention"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.num_layers, tcfg.num_kv_heads, tcfg.window_size) == (3, 1, 32)
    full = registry.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.head_dim, full.lru_width) == \
        (26, 2560, 256, 2560)


def test_rglru_block_matches_reference():
    jcfg, tcfg = _configs()
    jp = jrglru.init_params(jax.random.PRNGKey(3), jcfg)
    # a block's bias is zero at init; give it values so the test sees it
    rng = np.random.default_rng(0)
    jp = dict(jp, b_a=jnp.asarray(rng.standard_normal(jcfg.lru_width) * 0.1,
                                  jnp.float32),
              b_x=jnp.asarray(rng.standard_normal(jcfg.lru_width) * 0.1,
                              jnp.float32))
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jrglru.apply(jcfg, jp, jnp.asarray(x)))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    got = rglru.apply(tcfg, tp, _t(x))
    np.testing.assert_allclose(_np(got), want, **TOL)


def _batch(cfg, b=2, s=48, seed=0):
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


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_hybrid_loss_and_grads_match_reference(attn_impl):
    """seq 48 > window 32, so the local window masks; the reference's
    blocked attention scans 6 x 6 block pairs of 8."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    assert isinstance(jparams["layers"], list)
    tokens, labels = _batch(jcfg)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, wgrads = jax.value_and_grad(functools.partial(jreg.loss_fn, jcfg))(
        jparams, jbatch)
    params = {k: v.requires_grad_(True) for k, v in convert.params_from_jax(
        tcfg, jax.device_get(jparams), device="cpu").items()}
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    loss = registry.loss_fn(tcfg, params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    got = dict(_leaves(convert.params_to_numpy(tcfg, dict(zip(params, grads)))))
    want_leaves = dict(_leaves(jax.device_get(wgrads)))
    assert set(got) == set(want_leaves)
    assert any(".rec.lam" in k for k in got)
    for name, g in got.items():
        np.testing.assert_allclose(g, want_leaves[name], err_msg=name, **TOL)


def test_conversion_roundtrip_of_layer_list():
    jcfg = jreg.get_config(ARCH).reduced(dtype="bfloat16")
    tcfg = registry.get_config(ARCH).reduced(dtype="bfloat16")
    jparams = jax.device_get(jreg.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert.params_from_jax(tcfg, jparams, device="cpu")
    assert params["layers.0.rec.lam"].dtype == torch.float32
    assert params["layers.0.rec.w_a"].dtype == torch.bfloat16
    assert params["layers.2.attn.wq"].dtype == torch.bfloat16
    back = convert.params_to_numpy(tcfg, params)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 3
    back_leaves = dict(_leaves(back))
    want = dict(_leaves(jparams))
    assert set(back_leaves) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back_leaves[name], leaf, err_msg=name)
    # the module's own parameters have the same names, shapes and dtypes
    from repro_torch.models import transformer

    model = transformer.TransformerLM(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.named_parameters()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in params.items()}


STEPS, BATCH, SEQ = 2, 2, 40


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


def test_uncompressed_hybrid_round_matches_reference():
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


def test_int8_hybrid_round_within_one_step():
    """Both packings put each leaf of the layer list in its own rows, so
    the rows are the same; the bound is the mean over clients of each
    client delta's step."""
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


def test_train_cli_hybrid_reduced_on_cpu(tmp_path):
    """A fresh run: its own ``--ckpt-dir``, since ``launch.train`` resumes
    from whatever its checkpoint directory holds."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--rounds", "2", "--cohort", "2",
         "--local-steps", "1", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    # the keys of the final line of the reference's ``launch.train``
    assert set(line) == {"arch", "algorithm", "rounds", "restarts",
                         "first_loss", "final_loss"}
    assert line["arch"] == ARCH and line["rounds"] == 2
    assert np.isfinite(line["final_loss"])


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
