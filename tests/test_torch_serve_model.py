"""The port's serve paths against the reference, on the CPU.

- ``transformer.prefill`` (last logits and every cache leaf),
  ``decode_step`` (4 steps from the prefill's caches) and
  ``chunk_prefill`` (two chunks from no-ring caches), for reduced lm_350m,
  stablelm_3b, recurrentgemma_2b and rwkv6_3b (f32, the reference's
  parameters through ``convert.params_from_jax``), within the model
  tolerance 2e-5 (``tests/test_kernels.py:18-21``). The rwkv prompts stay
  short: the reference's prefill and chunk modes run ``chunked_wkv``,
  whose factors overflow within a 64-step chunk under the model's decays
  (ROADMAP.md, R5).
- The recurrentgemma ring cache (prefill of a prompt longer than the
  reduced window of 32, then decode steps), and the same request through
  the no-ring layout the slot pool holds (chunks, the window as a mask).
- A reference cache continued by the port (``convert.caches_from_jax``),
  and the slot pool's layout across the packages.
- K5 from an initial state: the plain version (``ops.wkv6`` on CPU
  tensors) against ``sequential_wkv(..., state=)`` (forward and final
  state within 1e-4, every gradient, ds0 included, within 1e-4 of the
  largest magnitude of ``jax.vjp``). The reference's chunked form is not
  the oracle (R5).
- K4's and K5's first order stays the plain backward, bitwise, with no
  plain second-order call.
- MoE ``decode_step`` at B 2 routes the batch as one group, as the
  reference's; the slot steps' per-row routing is the control.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import registry as jreg  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

TOL = 2e-5
ARCHS = ("lm_350m", "stablelm_3b", "recurrentgemma_2b", "rwkv6_3b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _models(arch, **over):
    jcfg = jreg.get_config(arch).reduced(**over)
    tcfg = registry.get_config(arch).reduced(**over)
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(tcfg, jax.device_get(jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """The reference's serve functions under ``jax.jit``, as its serve
    runtime runs them (one compile per shape, not per call)."""
    return (jax.jit(functools.partial(jtr.prefill, jcfg),
                    static_argnames="max_len"),
            jax.jit(functools.partial(jtr.decode_step, jcfg)),
            jax.jit(functools.partial(jtr.chunk_prefill, jcfg)))


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _close_caches(tcfg, tcaches, jcaches, what):
    got = jax.tree_util.tree_leaves(convert.caches_to_numpy(tcfg, tcaches))
    want = jax.tree_util.tree_leaves(jax.device_get(jcaches))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{what} leaf {i}")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _decode(jcfg, tcfg, jparams, tparams, jlast, jcaches, tcaches, steps):
    """``steps`` greedy decode steps in both packages from the reference's
    tokens, each step's logits and the caches after the last compared."""
    tok = np.argmax(np.asarray(jlast), -1)[:, None].astype(np.int32)
    for i in range(steps):
        jl, jcaches = _jitted(jcfg)[1](jparams, jnp.asarray(tok), jcaches)
        with torch.no_grad():
            tl, tcaches = transformer.decode_step(tcfg, tparams,
                                                  torch.from_numpy(tok),
                                                  tcaches)
        _close(tl, jl, f"decode {i}")
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    _close_caches(tcfg, tcaches, jcaches, "decoded caches")
    return jcaches, tcaches


def test_moe_decode_routes_the_batch_as_one_group():
    """Reduced phi35_moe (f32) at B 2: ``transformer.decode_step`` routes
    the two rows' tokens as one group, as the reference's ``decode_step``
    (``repro/models/transformer.py:245``): 4 greedy steps from the
    reference's prefill, logits within 2e-5 of the largest magnitude. The
    control: the slot steps' per-row routing (``route_rows=True``, capacity
    1 an expert alone against 1 for two tokens together at top 2 of 4)
    moves some step's logits away from the reference's."""
    jcfg, tcfg, jparams, tparams = _models("phi35_moe")
    toks = _tokens(5, 2, 8, jcfg.vocab_size)
    jlast, jcaches = _jitted(jcfg)[0](jparams, jnp.asarray(toks), max_len=16)
    tok = np.argmax(np.asarray(jlast), -1)[:, None].astype(np.int32)
    tcaches = convert.caches_from_jax(tcfg, jax.device_get(jcaches),
                                      device="cpu")
    rows = convert.caches_from_jax(tcfg, jax.device_get(jcaches),
                                   device="cpu")
    moved = 0
    for i in range(4):
        jl, jcaches = _jitted(jcfg)[1](jparams, jnp.asarray(tok), jcaches)
        want = np.asarray(jl)
        with torch.no_grad():
            tl, tcaches = transformer.decode_step(tcfg, tparams,
                                                  torch.from_numpy(tok),
                                                  tcaches)
            rl, rows = transformer.decode_step(tcfg, tparams,
                                               torch.from_numpy(tok), rows,
                                               route_rows=True)
        np.testing.assert_allclose(tl.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=f"decode {i}")
        moved += not np.allclose(rl.numpy(), want, rtol=TOL,
                                 atol=TOL * np.abs(want).max())
        tok = np.argmax(want, -1)[:, None].astype(np.int32)
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_chunks_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    toks = _tokens(1, 2, 12, jcfg.vocab_size)
    jlast, jcaches = _jitted(jcfg)[0](jparams, jnp.asarray(toks), max_len=20)
    with torch.no_grad():
        tlast, tcaches = transformer.prefill(tcfg, tparams,
                                             torch.from_numpy(toks),
                                             max_len=20)
    _close(tlast, jlast, "prefill logits")
    _close_caches(tcfg, tcaches, jcaches, "prefill caches")
    _decode(jcfg, tcfg, jparams, tparams, jlast, jcaches, tcaches, 4)

    jc = jtr.init_caches(jcfg, 2, 20, ring=False)
    tc = transformer.init_caches(tcfg, 2, 20, ring=False, device="cpu")
    pos = 0
    for c in (8, 4):
        chunk = toks[:, pos:pos + c]
        jl, jc = _jitted(jcfg)[2](jparams, jnp.asarray(chunk), jc,
                                  jnp.int32(pos))
        with torch.no_grad():
            tl, tc = transformer.chunk_prefill(tcfg, tparams,
                                               torch.from_numpy(chunk), tc,
                                               pos)
        _close(tl, jl, f"chunk at {pos}")
        pos += c
    _close_caches(tcfg, tc, jc, "chunked caches")
    _close(tl, tlast, "chunked prefill against full prefill")


def test_ring_cache_past_the_window():
    """recurrentgemma's local attention (reduced window 32): a 40-token
    prompt fills a 32-slot ring (positions 8..39 at p % 32) and decodes on
    through it, as the reference does; the same prompt through chunks of
    the no-ring layout (window as a mask) gives the same logits."""
    jcfg, tcfg, jparams, tparams = _models("recurrentgemma_2b")
    assert tcfg.window_size == 32
    toks = _tokens(2, 1, 40, jcfg.vocab_size)
    jlast, jcaches = _jitted(jcfg)[0](jparams, jnp.asarray(toks), max_len=48)
    with torch.no_grad():
        tlast, tcaches = transformer.prefill(tcfg, tparams,
                                             torch.from_numpy(toks),
                                             max_len=48)
    assert tcaches[2]["k"].shape[1] == 32  # the attention layer's ring
    _close(tlast, jlast, "prefill logits")
    _close_caches(tcfg, tcaches, jcaches, "ring caches")
    _decode(jcfg, tcfg, jparams, tparams, jlast, jcaches, tcaches, 4)
    tc = transformer.init_caches(tcfg, 1, 48, ring=False, device="cpu")
    pos = 0
    with torch.no_grad():
        for c in (32, 8):
            tl, tc = transformer.chunk_prefill(
                tcfg, tparams, torch.from_numpy(toks[:, pos:pos + c]), tc, pos)
            pos += c
    assert tc[2]["k"].shape[1] == 48
    _close(tl, jlast, "no-ring chunks against the ring prefill")


@pytest.mark.parametrize("arch", ["stablelm_3b", "recurrentgemma_2b"])
def test_port_continues_a_reference_cache(arch):
    """The reference prefills; its caches, converted, decode on in the port
    as they do in the reference; and back again."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    toks = _tokens(3, 2, 9, jcfg.vocab_size)
    jlast, jcaches = _jitted(jcfg)[0](jparams, jnp.asarray(toks), max_len=16)
    tcaches = convert.caches_from_jax(tcfg, jax.device_get(jcaches),
                                      device="cpu")
    _close_caches(tcfg, tcaches, jcaches, "converted")
    _decode(jcfg, tcfg, jparams, tparams, jlast, jcaches, tcaches, 3)


@pytest.mark.parametrize("arch", ["stablelm_3b", "recurrentgemma_2b",
                                  "rwkv6_3b"])
def test_slot_pool_matches_reference_layout(arch):
    """``init_slot_pool`` and ``slot_pool_bytes`` against the reference's:
    the same leaves (the stacked position leaf (slots, L) unstacked into
    one (slots,) per layer) and the same bytes."""
    jcfg = jreg.get_config(arch).reduced()
    tcfg = registry.get_config(arch).reduced()
    jpool = jax.device_get(jreg.init_slot_pool(jcfg, 3, 16))
    tpool = registry.init_slot_pool(tcfg, 3, 16, device="cpu")
    back = convert.caches_to_numpy(tcfg, tpool, pool=True)
    want = jax.tree_util.tree_leaves(jpool)
    got = jax.tree_util.tree_leaves(back)
    assert [w.shape for w in want] == [g.shape for g in got]
    assert registry.slot_pool_bytes(tcfg, 3, 16) == jreg.slot_pool_bytes(
        jcfg, 3, 16)
    again = convert.caches_from_jax(tcfg, jpool, device="cpu", pool=True)
    assert [t.shape for t in jax.tree_util.tree_leaves(again)] == [
        t.shape for t in jax.tree_util.tree_leaves(tpool)]


# ---------------------------------------------------------------------------
# K5 from an initial state; the first orders of K4 and K5
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, b, s, h, n):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((b, s, h, n)).astype(np.float32)
                   for _ in range(4))
    w0 = 0.5 * rng.standard_normal((h, n))
    lw = -np.exp(w0 + 0.3 * rng.standard_normal((b, s, h, n)))
    u = 0.5 * rng.standard_normal((h, n))
    s0 = 0.3 * rng.standard_normal((b, h, n, n))
    dfinal = rng.standard_normal((b, h, n, n))
    return [x.astype(np.float32) for x in (r, k, v, lw, u, s0, do, dfinal)]


@pytest.mark.parametrize("b,s,h,n", [(1, 1, 2, 8), (2, 37, 2, 16),
                                     (1, 70, 1, 16)])
def test_wkv6_initial_state_matches_sequential_wkv(b, s, h, n):
    r, k, v, lw, u, s0, do, dfinal = _wkv_inputs(b * s + n, b, s, h, n)
    j = [jnp.asarray(x) for x in (r, k, v, lw, u, s0)]
    (jout, jfinal), pullback = jax.vjp(
        lambda *a: jrwkv.sequential_wkv(*a[:5], state=a[5]), *j)
    want = pullback((jnp.asarray(do), jnp.asarray(dfinal)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (r, k, v, lw, u, s0)]
    out, final = ops.wkv6(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal),
                               rtol=1e-4, atol=1e-4)
    got = torch.autograd.grad((out, final), leaves,
                              (torch.from_numpy(do), torch.from_numpy(dfinal)))
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (name, err)


def test_first_orders_stay_the_plain_backward_bitwise():
    """Through ``ops.lru_scan`` and ``ops.wkv6`` (CPU tensors), the first
    order is the plain backward's, bitwise; no plain second-order call is
    made, and a training call (no s0, no loss on the final state) gives
    the zero-state backward."""
    gen = torch.Generator().manual_seed(4)
    a = torch.rand((2, 13, 6), generator=gen) * 0.9
    b, g = (torch.randn((2, 13, 6), generator=gen) for _ in range(2))
    h0 = torch.randn((2, 6), generator=gen)
    ops.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    got = torch.autograd.grad(ops.lru_scan(*leaves), leaves, g)
    want = ref.lru_scan_bwd_ref(a, ref.lru_scan_ref(a, b, h0), g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))

    r, k, v, lw, u, s0, do, _ = (torch.from_numpy(x) for x in _wkv_inputs(
        5, 1, 20, 2, 8))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u)]
    out, _ = ops.wkv6(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do)
    assert want[5] is None
    assert all(torch.equal(x, y) for x, y in zip(got, want[:5]))
    assert ops.plain_counts() == {"flash_attention_bwd2_plain": 0,
                                  "lru_scan_bwd2_plain": 0,
                                  "wkv6_bwd2_plain": 0}
