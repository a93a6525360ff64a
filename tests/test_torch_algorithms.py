"""The rest of the optimizers and rounds against the reference: SGD with
momentum and Nesterov, AdamW with weight decay, the learning-rate schedules
and FedAdam on identical inputs (1e-6); FedSGD rounds with and without
learned weights, the weights' gradient against ``jax.grad`` (1e-5);
``make_multi_round``; the flat and hierarchical asynchronous rounds (1e-5),
``init_pending``'s dtypes and a bf16 asynchronous round.

Reduced lm_350m (f32) from the reference's parameters and data; the
reference's local-SGD and asynchronous rounds run un-jitted, as its own
tests run them, its FedSGD rounds under ``jax.jit`` (R1 affects plan
building only)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import async_rounds as jasync  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.data import grouped as jgrouped  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import optimizers as jopt_mod  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import async_rounds, rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.models import registry  # noqa: E402

STEPS, BATCH, SEQ = 2, 2, 16


# ---------------------------------------------------------------------------
# optimizers and schedules on identical inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _schedules(mod):
    return {
        "constant": mod.constant(0.05),
        "warmup": mod.linear_warmup(0.1, 3),
        "cosine": mod.cosine_decay(0.1, 2, 7, floor=0.2),
    }


def test_schedules_match_reference():
    for name, (fn, jfn) in {k: (v, _schedules(jopt)[k])
                            for k, v in _schedules(optim).items()}.items():
        for step in range(10):
            got = fn(torch.tensor(step, dtype=torch.int32))
            want = jfn(jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{name} step {step}")


def _run_optimizer(topt, jopt_, steps=4, dtype=np.float32):
    """The same params and gradients through both optimizers; updates and
    params after every step within 1e-6."""
    rng = np.random.default_rng(np.random.SeedSequence([21]))
    p = rng.standard_normal(500).astype(dtype)
    tp, jp = {"p": torch.from_numpy(p)}, {"p": jnp.asarray(p)}
    ts, js = topt.init(tp), jopt_.init(jp)
    for _ in range(steps):
        g = (rng.standard_normal(500) * 10.0 ** rng.integers(-4, 1, 500))
        g = g.astype(np.float32)
        tu, ts = topt.update({"p": torch.from_numpy(g)}, ts, tp)
        ju, js = jopt_.update({"p": jnp.asarray(g)}, js, jp)
        np.testing.assert_allclose(tu["p"].numpy(), np.asarray(ju["p"]),
                                   rtol=1e-6, atol=1e-7)
        tp = optim.apply_updates(tp, tu)
        jp = jopt_mod.apply_updates(jp, ju)
    np.testing.assert_allclose(tp["p"].numpy(), np.asarray(jp["p"]),
                               rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == steps


@pytest.mark.parametrize("kind", [
    "sgd_momentum", "sgd_nesterov", "sgd_cosine", "adamw_decay",
    "adamw_warmup", "fedadam"])
def test_optimizers_match_reference(kind):
    def make(mod):
        s = _schedules(mod)
        return {
            "sgd_momentum": lambda: mod.sgd(0.05, momentum=0.9),
            "sgd_nesterov": lambda: mod.sgd(0.05, momentum=0.9, nesterov=True),
            "sgd_cosine": lambda: mod.sgd(s["cosine"], momentum=0.5),
            "adamw_decay": lambda: mod.adamw(0.01, weight_decay=0.1),
            "adamw_warmup": lambda: mod.adamw(s["warmup"], weight_decay=0.01),
            "fedadam": lambda: mod.fedadam(1e-2),
        }[kind]()

    _run_optimizer(make(optim), make(jopt))


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _data(cohort, round_idx=0, steps=STEPS, pods=0):
    jd = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                cohort_size=cohort).round_batch(
        round_idx, steps, BATCH, SEQ)
    td = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                               cohort_size=cohort).round_batch(
        round_idx, steps, BATCH, SEQ, device="cpu")
    lead = (pods, cohort // pods) if pods else (cohort,)
    jb = {k: jd[k].reshape(lead + jd[k].shape[1:]) for k in ("tokens", "labels")}
    tb = {k: td[k].reshape(lead + tuple(td[k].shape[1:]))
          for k in ("tokens", "labels")}
    return jb, tb


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


def _assert_params_close(tcfg, tparams, jparams, atol=1e-5):
    got = dict(_leaves(convert.params_to_numpy(tcfg, tparams)))
    for name, want in _leaves(jax.device_get(jparams)):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=atol,
                                   err_msg=name)


def _batches(b):
    """FedSGD's per-client batch: the first local step of each client."""
    return {k: v[:, 0] for k, v in b.items()}


@pytest.mark.parametrize("learned", [False, True], ids=["mean", "learned"])
def test_fedsgd_round_matches_reference(setup, learned):
    jcfg, tcfg, jparams, tparams = setup
    n = 4
    cfg_kw = dict(partition_size=n, num_local_steps=1)
    jb, tb = _data(n, steps=1)
    jb, tb = _batches(jb), _batches(tb)
    jserver, tserver = jopt.fedadam(1e-2), optim.fedadam(1e-2)
    jround = jax.jit(jrounds.make_fedsgd_round(
        functools.partial(jreg.loss_fn, jcfg), jserver,
        jrounds.LocalSGDConfig(**cfg_kw), learned_weights=learned))
    tround = rounds.make_fedsgd_round(
        functools.partial(registry.loss_fn, tcfg), tserver,
        rounds.LocalSGDConfig(**cfg_kw), learned_weights=learned)
    w0 = np.array([0.3, -0.2, 0.0, 0.5], np.float32)
    jstate, tstate = jserver.init(jparams), tserver.init(tparams)
    if not learned:
        jnew, _, jm = jround(jparams, jstate, jb)
        tnew, ts, tm = tround(tparams, tstate, tb)
        assert int(ts["step"]) == 1
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * abs(float(jm["loss"]))
        _assert_params_close(tcfg, tnew, jnew)
        return

    def jloss(w):
        return jround(jparams, jstate, jb, w)[2]["loss"]

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w0))
    w = torch.tensor(w0, requires_grad=True)
    tnew, _, tm = tround(tparams, tstate, tb, w)
    (tg,) = torch.autograd.grad(tm["loss"], w)
    tl = float(tm["loss"].detach())
    assert abs(tl - float(jl)) <= 1e-6 * abs(float(jl))
    assert np.any(tg.numpy() != 0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-5)
    jnew = jround(jparams, jstate, jb, jnp.asarray(w0))[0]
    _assert_params_close(tcfg, {k: v.detach() for k, v in tnew.items()}, jnew)
    # the new params carry the weights' gradient too, as in the reference
    assert tnew["lm_head.w"].requires_grad


def test_multi_round_matches_reference_and_single_rounds(setup):
    jcfg, tcfg, jparams, tparams = setup
    n, num = 2, 2
    kw = dict(partition_size=n, num_local_steps=STEPS, grad_clip=1.0)
    jround = jrounds.make_local_sgd_round(
        functools.partial(jreg.loss_fn, jcfg), jopt.sgd(0.05),
        jopt.fedavg_momentum(1.0, momentum=0.9), jrounds.LocalSGDConfig(**kw))
    server = optim.fedavg_momentum(1.0, momentum=0.9)
    tround = rounds.make_local_sgd_round(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05), server,
        rounds.LocalSGDConfig(**kw))
    data = [_data(n, r) for r in range(num)]
    jall = {k: jnp.stack([d[0][k] for d in data]) for k in ("tokens", "labels")}
    tall = {k: torch.stack([d[1][k] for d in data]) for k in ("tokens", "labels")}
    jnew, _, jm = jrounds.make_multi_round(jround, num)(
        jparams, jopt.fedavg_momentum(1.0, momentum=0.9).init(jparams), jall)
    trainer = rounds.make_multi_round(tround, num, jit=True, donate=True)
    tnew, tstate, tm = trainer(tparams, server.init(tparams), tall)
    assert tm["loss"].shape == (num,)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-6)
    _assert_params_close(tcfg, tnew, jnew)
    # the same rounds one at a time, bitwise
    p, s = tparams, server.init(tparams)
    for r in range(num):
        p, s, m = tround(p, s, data[r][1])
        assert float(m["loss"]) == float(tm["loss"][r])
    assert all(torch.equal(p[k], tnew[k]) for k in p)
    assert all(torch.equal(s["mu"][k], tstate["mu"][k]) for k in p)


@pytest.mark.parametrize("pods", [0, 2], ids=["flat", "hier_2x2"])
def test_async_rounds_match_reference(setup, pods):
    jcfg, tcfg, jparams, tparams = setup
    cohort = 4
    per = cohort // pods if pods else cohort
    kw = dict(partition_size=per, num_local_steps=STEPS, grad_clip=1.0,
              num_pods=pods)
    jmake = (jasync.make_hierarchical_async_round if pods
             else jasync.make_async_local_sgd_round)
    tmake = (async_rounds.make_hierarchical_async_round if pods
             else async_rounds.make_async_local_sgd_round)
    jround, jinit = jmake(functools.partial(jreg.loss_fn, jcfg), jopt.sgd(0.05),
                          jopt.fedavg_momentum(1.0), jrounds.LocalSGDConfig(**kw))
    jround = jax.jit(jround)
    tround, tinit = tmake(functools.partial(registry.loss_fn, tcfg),
                          optim.sgd(0.05), optim.fedavg_momentum(1.0),
                          rounds.LocalSGDConfig(**kw))
    jp, jpend = jparams, jinit(jparams)
    js = jopt.fedavg_momentum(1.0).init(jparams)
    tp, tpend = tparams, tinit(tparams)
    ts = optim.fedavg_momentum(1.0).init(tparams)
    for r in range(2):
        jb, tb = _data(cohort, r, pods=pods)
        jp, jpend, js, jm = jround(jp, jpend, js, jb)
        tp, tpend, ts, tm = tround(tp, tpend, ts, tb)
        jl = float(jm["loss"])
        assert abs(float(tm["loss"]) - jl) <= 1e-6 * abs(jl)
        _assert_params_close(tcfg, tp, jp)
        _assert_params_close(tcfg, tpend, jpend)
    assert int(ts["step"]) == 2


def test_init_pending_preserves_dtype():
    _, init_pending = async_rounds.make_async_local_sgd_round(
        lambda p, b: p["w"].sum(), optim.sgd(0.05), optim.fedavg_momentum(1.0),
        rounds.LocalSGDConfig(partition_size=2, num_local_steps=1))
    pending = init_pending({"w": torch.ones(3, dtype=torch.bfloat16),
                            "b": torch.zeros((), dtype=torch.float32)})
    assert pending["w"].dtype == torch.bfloat16
    assert pending["b"].dtype == torch.float32
    assert all(not v.float().any() for v in pending.values())


def test_bf16_async_round_matches_reference():
    """bf16 params through two asynchronous rounds in both packages: the
    dtypes kept and the values the reference's."""

    def tiny_loss(p, batch):
        pred = (p["w"].to(torch.float32) * batch["x"]).sum(-1)
        return torch.mean((pred - batch["y"]) ** 2)

    def jtiny_loss(p, batch):
        pred = (p["w"].astype(jnp.float32) * batch["x"]).sum(-1)
        return jnp.mean((pred - batch["y"]) ** 2)

    kw = dict(partition_size=2, num_local_steps=1)
    tround, tinit = async_rounds.make_async_local_sgd_round(
        tiny_loss, optim.sgd(0.05), optim.fedavg_momentum(1.0),
        rounds.LocalSGDConfig(**kw))
    jround, jinit = jasync.make_async_local_sgd_round(
        jtiny_loss, jopt.sgd(0.05), jopt.fedavg_momentum(1.0),
        jrounds.LocalSGDConfig(**kw))
    rng = np.random.default_rng(np.random.SeedSequence([22]))
    x = rng.standard_normal((2, 1, 8, 4)).astype(np.float32)
    y = rng.standard_normal((2, 1, 8)).astype(np.float32)
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    jp = {"w": jnp.ones((4,), jnp.bfloat16)}
    tpend, jpend = tinit(tp), jinit(jp)
    ts, js = optim.fedavg_momentum(1.0).init(tp), jopt.fedavg_momentum(1.0).init(jp)
    for _ in range(2):
        tp, tpend, ts, tm = tround(tp, tpend, ts, {"x": torch.from_numpy(x),
                                                   "y": torch.from_numpy(y)})
        jp, jpend, js, jm = jround(jp, jpend, js, {"x": jnp.asarray(x),
                                                   "y": jnp.asarray(y)})
    assert tp["w"].dtype == torch.bfloat16 and np.isfinite(float(tm["loss"]))
    np.testing.assert_allclose(tp["w"].float().numpy(),
                               np.asarray(jp["w"], np.float32), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
