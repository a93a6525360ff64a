"""Second-order algorithms of the port against the reference: parallel
MAML and Branch-Train-Merge (``repro_torch/algorithms/{maml,btm}.py``),
and the second order through K4 and K5 on the CPU.

- MAML on reduced lm_350m (f32), with ``attn_impl="blocked"`` (K2's plain
  versions and their second order, ``ops._FlashAttentionBackward``) and
  ``"naive"``: ``parallel_maml_loss`` within 2e-5 of the reference's, and
  ``maml_train_step``'s outer gradient (the second order through every
  layer) within 1e-4 of each leaf's largest magnitude of the reference's
  ``jax.grad``, for 3 tasks and 1 and 2 inner steps; the new params of the
  step within 1e-5 of the reference's step from that gradient. The
  reference runs under ``jax.jit`` (R1 affects plan building only), as its
  BTM test does.
- ``branch_train_merge`` with ``optim.sgd(0.05)``, mean and weighted
  merges: merged params within the rounds' atol of 1e-5, the metrics
  within 1e-6 relative; a plain composition of ``train_expert`` bitwise
  the mean merge.
- The reference's ``tests/test_algorithms.py`` checks of MAML (it trains,
  and its gradient program holds the ``reduce_sum`` transpose) and BTM
  (finite metrics, ``max >= mean``).
- K4's and K5's plain backward (the CPU path of ``ops.lru_scan`` and
  ``ops.wkv6``) differentiated again: the second order against autograd
  through the plain sequential loop, within 1e-4 of the largest magnitude.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_programs import load_model  # noqa: E402
from repro import core as jdrjax  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.algorithms.btm import branch_train_merge as jbtm  # noqa: E402
from repro.algorithms.maml import make_parallel_maml as jmaml  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.algorithms import (  # noqa: E402
    branch_train_merge, make_parallel_maml)
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.core.primitives import reciprocal  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import registry  # noqa: E402

TASKS, BATCH, SEQ = 3, 2, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _models(attn_impl):
    jcfg, tcfg, jparams, tparams = load_model()
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    return (jcfg, tcfg, jparams, tparams,
            functools.partial(jreg.loss_fn, jcfg),
            functools.partial(registry.loss_fn, tcfg))


def _tokens(seed, lead):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, lead + (SEQ + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _task_data():
    support, query = (_tokens(s, (TASKS, BATCH)) for s in (1, 2))
    (js, ts), (jq, tq) = _both(support), _both(query)
    return {"support": js, "query": jq}, {"support": ts, "query": tq}


def _close_leaves(got: dict, want: dict, rel: float):
    """Each leaf within ``rel`` of its largest magnitude."""
    assert set(got) == set(want)
    for k in got:
        g = got[k].detach().to(torch.float32).numpy()
        w = want[k].detach().to(torch.float32).numpy()
        top = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= rel * top, (k, np.abs(g - w).max(), top)


# ---------------------------------------------------------------------------
# MAML
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_maml(attn_impl, inner_steps):
    """The reference's meta-loss and outer gradient (``jax.jit`` of its
    ``jax.value_and_grad``), the gradient in the port's layout."""
    jcfg, tcfg, jparams, _, jloss, _ = _models(attn_impl)
    jtasks, _ = _task_data()
    jloss_fn, _ = jmaml(jloss, TASKS, inner_lr=0.05, inner_steps=inner_steps)
    meta, grads = jax.jit(jax.value_and_grad(jloss_fn))(jparams, jtasks)
    return float(meta), convert.params_from_jax(
        tcfg, jax.device_get(grads), device="cpu")


@pytest.mark.parametrize("inner_steps", [1, 2])
@pytest.mark.parametrize("attn_impl", ["blocked", "naive"])
def test_maml_matches_reference(attn_impl, inner_steps):
    _, tcfg, _, tparams, _, tloss = _models(attn_impl)
    _, ttasks = _task_data()
    tloss_fn, tstep = make_parallel_maml(tloss, TASKS, inner_lr=0.05,
                                         inner_steps=inner_steps)
    ops.reset_launches()
    new, meta = tstep(tparams, ttasks, outer_lr=0.2)
    if attn_impl == "blocked":
        # one second-order call per layer, task and inner step
        assert ops.plain_counts()["flash_attention_bwd2_plain"] == (
            TASKS * inner_steps * tcfg.num_layers)
    want_meta, want = _reference_maml(attn_impl, inner_steps)
    np.testing.assert_allclose(float(meta), want_meta, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        np.testing.assert_allclose(float(tloss_fn(tparams, ttasks)),
                                   want_meta, rtol=2e-5, atol=2e-5)
    grads = {k: (tparams[k].to(torch.float32) - new[k]) / 0.2 for k in new}
    _close_leaves(grads, want, 1e-4)
    for k in new:
        # the reference's step: (w_f32 - outer_lr * g) in the leaf's dtype
        step = (tparams[k].to(torch.float32) - 0.2 * want[k]).to(
            tparams[k].dtype)
        np.testing.assert_allclose(new[k].numpy(), step.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_maml_outer_gradient_is_the_second_order():
    """First-order MAML (the inner gradient detached) reads far beyond the
    tolerance from the reference's outer gradient, which the port's
    matches: the parity test sees the second order through K2."""
    _, _, _, tparams, _, tloss = _models("blocked")
    _, ttasks = _task_data()
    _, want = _reference_maml("blocked", 1)

    def first_order(params, task):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            g = torch.autograd.grad(tloss(leaves, task["support"]),
                                    list(leaves.values()))
        return tloss({k: v - 0.05 * gk for (k, v), gk in
                      zip(params.items(), g)}, task["query"])

    leaves = {k: v.detach().requires_grad_(True) for k, v in tparams.items()}
    loss = sum(first_order(leaves, {p: {k: v[i] for k, v in b.items()}
                                    for p, b in ttasks.items()})
               for i in range(TASKS)) / TASKS
    fo = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    worst = max(float((fo[k] - want[k]).abs().max() / want[k].abs().max())
                for k in want)
    assert worst > 1e-2
    _, tstep = make_parallel_maml(tloss, TASKS, inner_lr=0.05)
    new, _ = tstep(tparams, ttasks, outer_lr=0.2)
    _close_leaves({k: (tparams[k] - new[k]) / 0.2 for k in new}, want, 1e-4)


def test_maml_trains():
    """The reference's ``TestMAML.test_maml_trains``: a scalar quadratic
    model, 40 outer steps lower the meta-loss, within 1e-6 of the
    reference's."""
    def tloss(w, batch):
        return torch.mean((w - batch) ** 2)

    def jloss(w, batch):
        return jnp.mean((w - batch) ** 2)

    tmaml, tstep = make_parallel_maml(tloss, 4, inner_lr=0.1, inner_steps=1)
    jmaml_loss, jstep = jmaml(jloss, 4, inner_lr=0.1, inner_steps=1)
    sup, qry = [1.0, 2.0, 3.0, 4.0], [1.5, 2.5, 3.5, 4.5]
    ttasks = {"support": torch.tensor(sup), "query": torch.tensor(qry)}
    jtasks = {"support": jnp.array(sup), "query": jnp.array(qry)}
    w, jw = torch.tensor(0.0), jnp.float32(0.0)
    jstep = jax.jit(functools.partial(jstep, outer_lr=0.1))
    l0 = tmaml(w, ttasks)
    for _ in range(40):
        w, _ = tstep(w, ttasks, outer_lr=0.1)
        jw, _ = jstep(jw, jtasks)
    assert tmaml(w, ttasks) < l0
    np.testing.assert_allclose(float(w), float(jw), rtol=1e-6, atol=1e-6)


def test_maml_gradient_program_holds_the_transpose():
    """The reference's ``test_maml_jaxpr_closure``: the outer gradient's
    traced program holds ``drjax_reduce_sum`` (the broadcast's
    transpose), in both packages."""
    def tloss(w, batch):
        return torch.mean((w - batch) ** 2)

    def jloss(w, batch):
        return jnp.mean((w - batch) ** 2)

    tmaml, _ = make_parallel_maml(tloss, 3)
    jmaml_loss, _ = jmaml(jloss, 3)

    def grad_of(w, tasks):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(tmaml(w, tasks), w)[0]

    tasks = {"support": torch.zeros(3), "query": torch.ones(3)}
    counts = interp.count_primitives(interp.trace(grad_of, torch.tensor(0.0),
                                                  tasks))
    jcounts = jdrjax.count_primitives(jax.make_jaxpr(jax.grad(jmaml_loss))(
        jnp.float32(0.0), {"support": jnp.zeros(3), "query": jnp.ones(3)}))
    assert "drjax_reduce_sum" in counts and "drjax_reduce_sum" in jcounts
    assert "drjax_broadcast" in counts


# ---------------------------------------------------------------------------
# Branch-Train-Merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("merge", ["mean", "weighted"])
def test_btm_matches_reference(merge):
    jcfg, tcfg, jparams, tparams, jloss, tloss = _models("blocked")
    steps = 2
    data = _tokens(3, (TASKS, steps, BATCH))
    jdata, tdata = _both(data)
    jfn = jax.jit(jbtm(jloss, jopt.sgd(0.05), TASKS, steps, merge=merge))
    tfn = branch_train_merge(tloss, optim.sgd(0.05), TASKS, steps,
                             merge=merge)
    merged, metrics = tfn(tparams, tdata)
    jmerged, jmetrics = jfn(jparams, jdata)
    want = convert.params_from_jax(tcfg, jax.device_get(jmerged), device="cpu")
    for k in merged:
        np.testing.assert_allclose(merged[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("mean_final_loss", "max_final_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-6)
        assert np.isfinite(float(metrics[k]))
    assert float(metrics["max_final_loss"]) >= float(metrics["mean_final_loss"])
    batch = {k: v[0, 0] for k, v in tdata.items()}
    assert np.isfinite(float(tloss(merged, batch)))
    if merge == "mean":
        experts = [tfn.train_expert(tparams, {k: v[i] for k, v in
                                              tdata.items()})[0]
                   for i in range(TASKS)]
        for k in merged:
            plain = torch.stack([e[k] for e in experts]).sum(0) * \
                reciprocal(TASKS)
            assert torch.equal(merged[k], plain), k


# ---------------------------------------------------------------------------
# K4 and K5: the plain backward differentiated again
# ---------------------------------------------------------------------------


def _second_order(fn, inputs, weights):
    """d/d inputs of sum |grad_inputs sum(fn(inputs) . weights)|^2."""
    inputs = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*inputs)
    grads = torch.autograd.grad((out * weights).sum(), inputs,
                                create_graph=True)
    total = sum((g ** 2).sum() for g in grads)
    return torch.autograd.grad(total, inputs)


def _check_second_order(got, want):
    for g, w in zip(got, want):
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * top, (
            float((g - w).abs().max()), top)


def test_lru_scan_second_order_is_the_plain_loops():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((2, 11, 6), generator=gen) * 0.9
    b = torch.randn((2, 11, 6), generator=gen)
    h0 = torch.randn((2, 6), generator=gen)
    w = torch.randn((2, 11, 6), generator=gen)
    got = _second_order(ops.lru_scan, (a, b, h0), w)
    want = _second_order(ref.lru_scan_ref, (a, b, h0), w)
    _check_second_order(got, want)


def test_wkv6_second_order_is_the_plain_loops():
    gen = torch.Generator().manual_seed(1)
    shape = (1, 9, 2, 8)
    r, k, v = (torch.randn(shape, generator=gen) * 0.5 for _ in range(3))
    logw = -torch.rand(shape, generator=gen) - 0.05
    u = torch.randn((2, 8), generator=gen) * 0.5
    w = torch.randn(shape, generator=gen)
    got = _second_order(lambda *t: ops.wkv6(*t)[0], (r, k, v, logw, u), w)
    want = _second_order(ref.wkv6_ref, (r, k, v, logw, u), w)
    _check_second_order(got, want)
