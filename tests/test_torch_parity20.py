"""Twenty rounds of reduced lm_350m in the port against the jitted
reference round, from the same parameters (``params_from_jax``) and the
same data: cohort 4, 2 local steps, batch 2, seq 16.

Forms: flat local SGD, flat int8, hierarchical 2 x 2 with the fused int8
reduce, and DiLoCo. Each round's loss within 1e-6 relative; final params
within 1e-5 uncompressed and 1e-4 with int8 (a delta that differs in the
last bit may flip one int8 value of its row, and rounds compound it).

DiLoCo's client AdamW runs at eps 1e-3, as in ``tests/test_torch_round.py``:
at ``launch.train``'s 1e-8 a gradient far below eps moves by lr * g / eps, so
gradients that agree to f32 rounding give updates ~1e-3 apart (ROADMAP
R4). Even at 1e-3 its trajectory is chaotic at this size: the reference
against itself with one parameter changed by one ulp reads params 4.3e-6
apart after 4 rounds, 2.5e-4 after 5, and ends ~1e-2 apart in loss and
~1.5 in params after 20 (``test_diloco_reference_drifts_from_itself``);
the port against the reference read 4.6e-6 and 1.9e-4 after 4 and 5
rounds. So DiLoCo is held for the first 4 rounds.

The reference round runs under ``jax.jit``, as its ``launch.train`` runs it (R1
breaks plan building of jitted programs, not the jitted round).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.data import grouped as jgrouped  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROUNDS, COHORT, STEPS, BATCH, SEQ = 20, 4, 2, 2, 16

FORMS = {  # name: (compression, pods, algorithm, rounds, params atol)
    "flat": (None, 0, "local_sgd", ROUNDS, 1e-5),
    "flat_int8": ("int8", 0, "local_sgd", ROUNDS, 1e-4),
    "hier_2x2_fused_int8": ("int8", 2, "local_sgd", ROUNDS, 1e-4),
    "diloco_eps1e-3": (None, 0, "diloco", 4, 1e-5),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _opts(mod, algorithm):
    if algorithm == "diloco":
        return mod.adamw(0.05, eps=1e-3), mod.diloco_optimizer(0.7, 0.9)
    return mod.sgd(0.05), mod.fedavg_momentum(1.0)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_twenty_rounds_match_jitted_reference(form):
    compression, pods, algorithm, num_rounds, atol = FORMS[form]
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    kw = dict(partition_size=COHORT // pods if pods else COHORT,
              num_local_steps=STEPS, grad_clip=1.0, compression=compression,
              num_pods=pods)
    jclient, jserver = _opts(jopt, algorithm)
    tclient, tserver = _opts(optim, algorithm)
    jmake = (jrounds.make_hierarchical_local_sgd_round if pods
             else jrounds.make_local_sgd_round)
    tmake = (rounds.make_hierarchical_local_sgd_round if pods
             else rounds.make_local_sgd_round)
    jround = jax.jit(jmake(functools.partial(jreg.loss_fn, jcfg), jclient,
                           jserver, jrounds.LocalSGDConfig(**kw)))
    tround = tmake(functools.partial(registry.loss_fn, tcfg), tclient, tserver,
                   rounds.LocalSGDConfig(**kw))
    jsamp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                   cohort_size=COHORT)
    tsamp = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=COHORT)
    lead = (pods, COHORT // pods) if pods else (COHORT,)
    js, ts = jserver.init(jparams), tserver.init(tparams)
    worst = 0.0
    for r in range(num_rounds):
        jd = jsamp.round_batch(r, STEPS, BATCH, SEQ)
        td = tsamp.round_batch(r, STEPS, BATCH, SEQ, device="cpu")
        jb = {k: jd[k].reshape(lead + jd[k].shape[1:]) for k in ("tokens", "labels")}
        tb = {k: td[k].reshape(lead + tuple(td[k].shape[1:]))
              for k in ("tokens", "labels")}
        jparams, js, jm = jround(jparams, js, jb)
        tparams, ts, tm = tround(tparams, ts, tb)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        worst = max(worst, abs(tl - jl) / abs(jl))
        assert abs(tl - jl) <= 1e-6 * abs(jl), (r, tl, jl)
    params_diff = _params_diff(convert.params_to_numpy(tcfg, tparams),
                               jax.device_get(jparams))
    print(f"{form}: worst relative loss difference {worst:.3g}, "
          f"params within {params_diff:.3g}")
    assert params_diff <= atol
    assert int(ts["step"]) == num_rounds


def _params_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


def test_diloco_reference_drifts_from_itself():
    """The control behind DiLoCo's 4 rounds: the jitted reference, from its
    parameters and from the same with one element one ulp away, stays
    within 1e-5 for 4 rounds at client eps 1e-3, then drifts: past 1e-5
    in params by round 5 and past 1e-6 relative in loss within 20."""
    cfg = jreg.get_config("lm_350m").reduced()
    p0 = jreg.init_params(jax.random.PRNGKey(0), cfg)
    w = np.array(p0["lm_head"]["w"])
    w.flat[0] = np.nextafter(w.flat[0], np.float32(1))
    p1 = dict(p0, lm_head={"w": jax.numpy.asarray(w)})
    client, server = _opts(jopt, "diloco")
    jround = jax.jit(jrounds.make_local_sgd_round(
        functools.partial(jreg.loss_fn, cfg), client, server,
        jrounds.LocalSGDConfig(partition_size=COHORT, num_local_steps=STEPS,
                               grad_clip=1.0)))
    samp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=COHORT)
    s0 = s1 = server.init(p0)
    loss_drift, params_drift = [], []
    for r in range(ROUNDS):
        d = samp.round_batch(r, STEPS, BATCH, SEQ)
        b = {k: d[k] for k in ("tokens", "labels")}
        p0, s0, m0 = jround(p0, s0, b)
        p1, s1, m1 = jround(p1, s1, b)
        loss_drift.append(abs(float(m0["loss"]) - float(m1["loss"]))
                          / abs(float(m0["loss"])))
        params_drift.append(_params_diff(jax.device_get(p0), jax.device_get(p1)))
    print("DiLoCo, the reference against itself one ulp away: loss "
          + " ".join(f"{d:.2g}" for d in loss_drift) + "; params "
          + " ".join(f"{d:.2g}" for d in params_drift))
    assert max(params_drift[:4]) <= 1e-5 < params_drift[4]
    assert max(loss_drift) > 1e-6
