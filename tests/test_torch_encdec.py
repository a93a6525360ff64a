"""The port's encoder-decoder (seamless_m4t_medium, ``models/encdec.py``)
against the reference's ``repro/models/encdec.py`` on the CPU, at the
reduced config (2 encoder and 2 decoder layers, d 64, 4:2 heads of 16,
f32), from the reference's parameters (``convert.params_from_jax``) and
the same numpy inputs:

- the parameter tree: names and shapes of :class:`encdec.EncDecLM` equal
  the reference's flattened tree, and the full config's count is the
  reference's ``jax.eval_shape`` count;
- ``encode``, ``decode_stack`` (train mode) and ``loss_fn`` with every
  gradient, ``attn_impl`` naive and blocked (K2's plain path, non-causal in
  the encoder and the cross-attention), at rtol = atol = 2e-5 against the
  un-jitted reference;
- one flat local-SGD round on a frames batch, atol 1e-5;
- ``prefill`` and 8 greedy ``decode_step``s token for token, logits at
  2e-5, the self-attention caches and the memory K/V through ``convert``;
  the registry's and ``launch.steps``' serve functions;
- conversion both ways and a checkpoint written by either package restored
  by the other, bitwise;
- ``launch.train``, ``launch.serve.main`` and the serve helpers that
  take decoders only refuse it.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import encdec, registry, transformer  # noqa: E402

ARCH = "seamless_m4t_medium"
TOL = dict(rtol=2e-5, atol=2e-5)
FRAMES = 32  # encoder frames; the text is max(32 // 8, 16) = 16 tokens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so this file's tests do not
    crowd out the suite's other workers."""
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


@functools.lru_cache(maxsize=None)
def _models(attn_impl="naive", dtype="float32"):
    jcfg = jreg.get_config(ARCH).reduced(attn_impl=attn_impl, dtype=dtype)
    tcfg = registry.get_config(ARCH).reduced(attn_impl=attn_impl, dtype=dtype)
    jparams = jax.device_get(jreg.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jparams


def _tparams(tcfg, jparams):
    return convert.params_from_jax(tcfg, jparams, device="cpu")


def _batch(cfg, b=2, seed=0, lead=()):
    """A frames batch (numpy leaves) of ``registry.make_batch``."""
    cfg = registry.get_config(ARCH).reduced(dtype=cfg.dtype)
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in registry.make_batch(cfg, b, FRAMES, seed=seed,
                                            lead=lead, device="cpu").items()}


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# parameters and batches
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference():
    jcfg, tcfg, jparams = _models()
    model = encdec.EncDecLM(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    mine = {k: v.detach() for k, v in model.named_parameters()}
    want = {k: v.shape for k, v in _leaves(jparams)}
    got = {k: tuple(v.shape) for k, v in
           _leaves(convert.params_to_numpy(tcfg, mine))}
    assert got == want
    assert registry.init_params(tcfg, seed=0, device="cpu").keys() == \
        mine.keys()
    # at full size the port's module holds the reference's init's count
    # (its ``jax.eval_shape``): ``param_count`` plus the vocabulary padding
    # to a multiple of 512 and the decoder's ln_x and the encoder's final
    # norm, which the formula leaves out
    full = registry.get_config(ARCH)
    shapes = jax.eval_shape(lambda: jreg.init_params(
        jax.random.PRNGKey(0), jreg.get_config(ARCH)))
    ref_count = sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes))
    pad = transformer.padded_vocab(full) - full.vocab_size
    assert ref_count == 978_384_896 == (
        full.param_count() + 2 * pad * full.d_model
        + (full.num_layers + 1) * full.d_model)


def test_batch_shapes_follow_train_batch_spec():
    jcfg, tcfg, _ = _models()
    spec = jreg.train_batch_spec(jcfg, 3, 256)
    shapes = registry.train_batch_shapes(tcfg, 3, 256)
    assert {k: s.shape for k, s in spec.items()} == {
        k: shape for k, (shape, _) in shapes.items()}
    assert shapes["tokens"][0] == (3, 32)
    a = registry.make_batch(tcfg, 2, 64, seed=1, device="cpu")
    b = registry.make_batch(tcfg, 2, 64, seed=1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(
        a["frames"], registry.make_batch(tcfg, 2, 64, seed=2,
                                         device="cpu")["frames"])
    assert int(a["tokens"].max()) < tcfg.vocab_size


# ---------------------------------------------------------------------------
# encoder, decoder stack, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_encode_and_decode_stack_match_reference(attn_impl):
    jcfg, tcfg, jparams = _models(attn_impl)
    tparams = _tparams(tcfg, jparams)
    nb = _batch(jcfg)
    jmem = jenc.encode(jcfg, jparams, jnp.asarray(nb["frames"]))
    jlogits, _ = jenc.decode_stack(jcfg, jparams, jnp.asarray(nb["tokens"]),
                                   jmem)
    with torch.no_grad():
        mem = encdec.encode(tcfg, tparams, torch.from_numpy(nb["frames"]))
        logits, caches = encdec.decode_stack(
            tcfg, tparams, torch.from_numpy(nb["tokens"]), mem)
    assert caches is None and logits.dtype == torch.float32
    _close(mem, jmem, "memory")
    _close(logits, jlogits, "logits")


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_loss_and_grads_match_reference(attn_impl):
    jcfg, tcfg, jparams = _models(attn_impl)
    nb = _batch(jcfg, seed=1)
    want, wgrads = jax.value_and_grad(functools.partial(jreg.loss_fn, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    params = {k: v.requires_grad_(True)
              for k, v in _tparams(tcfg, jparams).items()}
    loss = registry.loss_fn(tcfg, params,
                            {k: torch.from_numpy(v) for k, v in nb.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    got = dict(_leaves(convert.params_to_numpy(tcfg, dict(zip(params,
                                                                grads)))))
    want_leaves = dict(_leaves(jax.device_get(wgrads)))
    assert set(got) == set(want_leaves)
    for name, g in got.items():
        np.testing.assert_allclose(g, want_leaves[name], err_msg=name, **TOL)
    # every cross-attention weight takes part
    assert all(np.abs(got[f"dec_layers.cross_attn.{w}"]).max() > 0
               for w in ("wq", "wk", "wv", "wo"))


def test_cross_attention_has_no_rope_and_no_mask():
    """The last query attends to every memory position, the first too, and
    moving the memory's positions (a permutation of its rows) leaves the
    output alone: no rotary embedding, no causal mask."""
    _, tcfg, jparams = _models("blocked")
    tparams = _tparams(tcfg, jparams)
    p = {k[len("dec_layers.0.cross_attn."):]: v for k, v in tparams.items()
         if k.startswith("dec_layers.0.cross_attn.")}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, tcfg.d_model),
                                             dtype=np.float32))
    mem = torch.from_numpy(rng.standard_normal((2, 11, tcfg.d_model),
                                               dtype=np.float32))
    from repro_torch.models import attention

    def run(m):
        mk = attention._proj(m, p["wk"])
        mv = attention._proj(m, p["wv"])
        return attention.cross_attention(tcfg, p, x, mk, mv)

    with torch.no_grad():
        out = run(mem)
        perm = torch.from_numpy(rng.permutation(11))
        torch.testing.assert_close(run(mem[:, perm]), out, rtol=1e-5,
                                   atol=1e-6)
        naive = attention.cross_attention(
            registry.get_config(ARCH).reduced(), p, x,
            attention._proj(mem, p["wk"]), attention._proj(mem, p["wv"]))
    torch.testing.assert_close(naive, out, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# a round
# ---------------------------------------------------------------------------


def test_round_matches_reference():
    cohort, local = 2, 2
    jcfg, tcfg, jparams = _models()
    tparams = _tparams(tcfg, jparams)
    nb = _batch(jcfg, seed=2, lead=(cohort, local))

    def make(mod_rounds, mod_opt, reg, cfg):
        return mod_rounds.make_local_sgd_round(
            functools.partial(reg.loss_fn, cfg), mod_opt.sgd(0.05),
            mod_opt.fedavg_momentum(1.0),
            mod_rounds.LocalSGDConfig(partition_size=cohort,
                                      num_local_steps=local, grad_clip=1.0))

    jnew, _, jm = make(jrounds, jopt, jreg, jcfg)(
        jparams, jopt.fedavg_momentum(1.0).init(jparams),
        {k: jnp.asarray(v) for k, v in nb.items()})
    tnew, _, tm = make(rounds, optim, registry, tcfg)(
        tparams, optim.fedavg_momentum(1.0).init(tparams),
        {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    old = dict(_leaves(jparams))
    want = dict(_leaves(jax.device_get(jnew)))
    got = dict(_leaves(convert.params_to_numpy(tcfg, tnew)))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert max(float(np.abs(want[k] - old[k]).max()) for k in old) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_prefill_and_greedy_decode_match_reference(attn_impl):
    jcfg, tcfg, jparams = _models(attn_impl)
    tparams = _tparams(tcfg, jparams)
    nb = _batch(jcfg, seed=4)
    frames, prompt = nb["frames"], nb["tokens"][:, :8]
    new, max_len = 8, 8 + 8
    jl, jc, jmkv = jenc.prefill(jcfg, jparams, jnp.asarray(frames),
                                jnp.asarray(prompt), max_len=max_len)
    with torch.no_grad():
        tl, tc, tmkv = encdec.prefill(tcfg, tparams,
                                      torch.from_numpy(frames),
                                      torch.from_numpy(prompt),
                                      max_len=max_len)
    assert len(tc) == tcfg.num_layers and len(tmkv) == tcfg.num_layers
    _close(tl, jl, "prefill logits")
    for got, want, what in zip(convert.memory_kv_to_numpy(tmkv),
                               jax.device_get(jmkv), ("mk", "mv")):
        assert got.shape == (tcfg.num_layers, 2, FRAMES, 2, 16)
        _close(got, want, what)
    for i in range(new):
        want_tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        got_tok = torch.argmax(tl, -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(got_tok.numpy(), want_tok,
                                      err_msg=f"token {i}")
        jl, jc = jenc.decode_step(jcfg, jparams, jnp.asarray(want_tok), jc,
                                  jmkv)
        with torch.no_grad():
            tl, tc = encdec.decode_step(tcfg, tparams, got_tok, tc, tmkv)
        _close(tl, jl, f"decode {i}")
    got_c, want_c = convert.caches_to_numpy(tcfg, tc), jax.device_get(jc)
    assert set(got_c) == set(want_c) == {"k", "v", "pos"}
    for key in got_c:
        _close(got_c[key], want_c[key], f"cache {key}")
    assert int(tc[0]["pos"]) == 8 + new


def test_serve_functions_and_layout_conversion():
    """``make_prefill_fn`` takes frames and drops the memory K/V, as the
    reference's; ``launch.steps``' decode step takes them; the reference's
    caches and memory K/V continue in the port."""
    jcfg, tcfg, jparams = _models()
    tparams = _tparams(tcfg, jparams)
    nb = _batch(jcfg, seed=5)
    batch = {"frames": nb["frames"], "tokens": nb["tokens"][:, :6]}
    jl, jc = jreg.make_prefill_fn(jcfg, max_len=10)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = steps.make_prefill_step(tcfg, max_len=10)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, "prefill_fn")
    assert not tl.requires_grad and tc[0]["k"].shape[1] == 10
    # continue the reference's state in the port
    _, jc, jmkv = jenc.prefill(jcfg, jparams, jnp.asarray(batch["frames"]),
                               jnp.asarray(batch["tokens"]), max_len=10)
    caches = convert.caches_from_jax(tcfg, jax.device_get(jc), device="cpu")
    mkv = convert.memory_kv_from_jax(tcfg, jax.device_get(jmkv),
                                     device="cpu")
    tok = np.full((2, 1), 7, np.int32)
    jl, _ = jreg.make_decode_fn(jcfg)(jparams, jnp.asarray(tok), jc, jmkv)
    tl, caches = steps.make_decode_step(tcfg)(tparams, torch.from_numpy(tok),
                                              caches, mkv)
    _close(tl, jl, "decode_step")
    assert int(caches[0]["pos"]) == 7


def test_decoder_only_serving_refuses_encdec():
    _, tcfg, _ = _models()
    with pytest.raises(ValueError, match="token-only decoder"):
        registry.make_chunk_prefill_fn(tcfg)
    with pytest.raises(ValueError, match="token-only decoder"):
        registry.cache_batch_dims(tcfg)
    with pytest.raises(SystemExit, match="token-only decoder"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        transformer.TransformerLM(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")


def test_launch_train_refuses_encdec(tmp_path):
    args = train.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--rounds", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="encoder-decoder"):
        train.train(args)


# ---------------------------------------------------------------------------
# conversion and checkpoints across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversion_roundtrip_is_bitwise(dtype):
    _, tcfg, jparams = _models(dtype=dtype)
    params = _tparams(tcfg, jparams)
    assert all(v.dtype == getattr(torch, dtype) for v in params.values())
    assert sum(k.startswith("enc_layers.") for k in params) == 2 * 9
    assert sum(k.startswith("dec_layers.") for k in params) == 2 * 14
    back = dict(_leaves(convert.params_to_numpy(tcfg, params)))
    for name, leaf in _leaves(jparams):
        np.testing.assert_array_equal(back[name], leaf.astype(np.float32),
                                      err_msg=name)


def _state(dtype):
    jcfg, tcfg, jparams = _models(dtype=dtype)
    server = jopt.fedadam(1e-2)
    delta = jax.tree_util.tree_map(lambda p: p * 0.01, jparams)
    _, jserver = server.update(delta, server.init(jparams), jparams)
    jstate = jax.device_get({"params": jparams, "server": jserver})
    return tcfg, jstate, convert.state_from_jax(tcfg, jstate, device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_restore_across_packages(tmp_path, dtype):
    tcfg, jstate, state = _state(dtype)
    # the port's checkpoint in the reference
    CheckpointManager(str(tmp_path / "port")).save(
        3, convert.state_to_numpy(tcfg, state))
    restored, _ = JManager(str(tmp_path / "port")).restore(3, jstate)
    got, want = (jax.tree_util.tree_leaves(restored),
                 jax.tree_util.tree_leaves(jstate))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the reference's checkpoint in the port
    JManager(str(tmp_path / "ref")).save(5, jstate)
    step, tree, _ = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        convert.state_to_numpy(tcfg, state))
    assert step == 5
    back = convert.state_from_jax(tcfg, tree, device="cpu")
    for part in ("params", "server"):
        flat = dict(convert._flatten(back[part]))
        want_flat = dict(convert._flatten(state[part]))
        assert flat.keys() == want_flat.keys()
        for k, t in flat.items():
            assert t.dtype == want_flat[k].dtype and torch.equal(
                t, want_flat[k]), (part, k)
