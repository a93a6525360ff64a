"""Programs held by the port's plan and executor tests
(``test_torch_plan.py``, ``test_torch_executor.py``), in both packages:
the oracle programs of the reference's interpreter tests, written in torch
with its higher-order ops where they loop or branch (closed-over values
passed as the ops' additional inputs), and the shipped rounds at reduced
lm_350m with their declared input depths: the local-SGD, async,
multi-round and FedSGD rounds, the pipelined round (2 stages of one layer
each, 4 microbatches), a MAML train step (its outer gradient) and
Branch-Train-Merge."""

import functools

import numpy as np
import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.scan import scan_op
from torch._higher_order_ops.while_loop import while_loop_op
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from repro import compression as jcomp
from repro import core as jdrjax
from repro import optim as jopt
from repro.algorithms import async_rounds as jasync
from repro.algorithms import btm as jbtm
from repro.algorithms import maml as jmaml
from repro.algorithms import pipeline as jpipeline
from repro.algorithms import rounds as jrounds
from repro.data import grouped as jgrouped
from repro.models import blocks as jblocks
from repro.models import registry as jreg
from repro_torch import compression as tcomp
from repro_torch import convert, optim
from repro_torch import core as drjax
from repro_torch.algorithms import async_rounds, rounds
from repro_torch.algorithms import btm as tbtm
from repro_torch.algorithms import maml as tmaml
from repro_torch.algorithms import pipeline as tpipeline
from repro_torch.core import interpreter as interp
from repro_torch.data import grouped
from repro_torch.models import blocks, registry, transformer


def jplan(fn, placements, *args):
    return jdrjax.build_plan(jax.make_jaxpr(fn)(*args), placements)


def tplan(fn, placements, *args):
    return interp.build_plan(interp.trace(fn, *args), placements)


def _t(a):
    return torch.tensor(np.asarray(a))


def flat(tree):
    return pytree.tree_leaves(tree)


def assert_bitwise(outs, direct):
    assert len(outs) == len(direct)
    for a, b in zip(outs, direct):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the oracle programs, in both packages
# ---------------------------------------------------------------------------


def _quadratic_data(n=4, steps=2, dim=3):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal(dim).astype(np.float32),
              "b": np.float32(0.0)}
    data = {"x": rng.standard_normal((n, steps, 8, dim)).astype(np.float32),
            "y": rng.standard_normal((n, steps, 8)).astype(np.float32)}
    return params, data


def _quadratic_round(pkg):
    """The flat quadratic local-SGD round (``quadratic_setup``)."""
    mod_opt, mod_rounds = (jopt, jrounds) if pkg == "jax" else (optim, rounds)
    if pkg == "jax":
        def loss_fn(params, batch):
            pred = batch["x"] @ params["w"] + params["b"]
            return jnp.mean((pred - batch["y"]) ** 2)
    else:
        def loss_fn(params, batch):
            pred = batch["x"] @ params["w"] + params["b"]
            return torch.mean((pred - batch["y"]) ** 2)
    server = mod_opt.fedavg_momentum(1.0)
    cfg = mod_rounds.LocalSGDConfig(partition_size=4, num_local_steps=2)
    round_fn = mod_rounds.make_local_sgd_round(loss_fn, mod_opt.sgd(0.05),
                                               server, cfg)
    p, d = _quadratic_data()
    if pkg == "jax":
        params = {k: jnp.asarray(v) for k, v in p.items()}
        data = {k: jnp.asarray(v) for k, v in d.items()}
    else:
        params = {k: _t(v) for k, v in p.items()}
        data = {k: _t(v) for k, v in d.items()}
    return round_fn, (params, server.init(params), data), 4


def maml(pkg, grad_of=False):
    def program(mod, grad):
        def loss(x, y):
            return (x - y) ** 2

        def maml_loss(model, lr, task):
            g = grad(loss)(model, task)
            return loss(model - lr * g, task)

        @mod.program(partition_size=3)
        def f(model, lr, tasks):
            return mod.reduce_mean(mod.map_fn(
                maml_loss, (mod.broadcast(model), mod.broadcast(lr), tasks)))
        return f

    vals = (np.float32(0.1), np.float32(0.05),
            np.array([1.0, 2.0, 3.0], np.float32))
    if pkg == "jax":
        f = program(jdrjax, jax.grad)
        return (jax.grad(f) if grad_of else f), tuple(map(jnp.asarray, vals)), 3
    f = program(drjax, torch.func.grad)
    if grad_of:
        def gf(model, lr, tasks):
            m = model.detach().requires_grad_(True)
            with torch.enable_grad():
                return torch.autograd.grad(f(m, lr, tasks), m)[0]
        return gf, tuple(map(_t, vals)), 3
    return f, tuple(map(_t, vals)), 3


def _scan(pkg):
    args = (np.float32(0.3), np.array([1.0, 2.0, 3.0], np.float32))
    if pkg == "jax":
        @jdrjax.program(partition_size=3)
        def prog(m, ys):
            def body(m, _):
                g = jdrjax.reduce_mean(jdrjax.map_fn(
                    lambda mm, y: mm - y, (jdrjax.broadcast(m), ys)))
                return m - 0.5 * g, g

            # torch's scan takes its length from its xs: both scan over a
            # zero xs of length 2
            return jax.lax.scan(body, m, jnp.zeros(2))
        return prog, tuple(map(jnp.asarray, args)), 3

    @drjax.program(partition_size=3)
    def tprog(m, ys):
        def body(m, t, ys):
            g = drjax.reduce_mean(drjax.map_fn(
                lambda mm, y: mm - y, (drjax.broadcast(m), ys)))
            return [m - 0.5 * g, g]

        return scan_op(body, [m], [torch.zeros(2)], (ys,))
    return tprog, tuple(map(_t, args)), 3


def _while(pkg, in_predicate):
    args = (np.float32(0.5), np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    if pkg == "jax":
        @jdrjax.program(partition_size=4)
        def prog(x, ys):
            def cond_fn(c):
                i, acc = c
                if not in_predicate:
                    return i < 3
                spread = jdrjax.reduce_max(jdrjax.map_fn(
                    lambda a, b: a * b, (jdrjax.broadcast(acc), ys)))
                return (spread < 10.0) & (i < 10)

            def body_fn(c):
                i, acc = c
                g = jdrjax.reduce_sum(jdrjax.map_fn(
                    lambda a, b: a * b, (jdrjax.broadcast(acc), ys)))
                return i + 1, acc + 0.1 * g

            return jax.lax.while_loop(cond_fn, body_fn, (0, x))[1]
        return prog, tuple(map(jnp.asarray, args)), 4

    @drjax.program(partition_size=4)
    def tprog(x, ys):
        def cond_fn(i, acc, ys):
            if not in_predicate:
                return i < 3
            spread = drjax.reduce_max(drjax.map_fn(
                lambda a, b: a * b, (drjax.broadcast(acc), ys)))
            return (spread < 10.0) & (i < 10)

        def body_fn(i, acc, ys):
            g = drjax.reduce_sum(drjax.map_fn(
                lambda a, b: a * b, (drjax.broadcast(acc), ys)))
            return i + 1, acc + 0.1 * g

        return while_loop_op(cond_fn, body_fn,
                             (torch.tensor(0, dtype=torch.int32), x), (ys,))[1]
    return tprog, tuple(map(_t, args)), 4


def _cond(pkg, flag=True):
    """``cond`` with communication in both branches."""
    args = (np.bool_(flag), np.float32(2.0),
            np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    if pkg == "jax":
        @jdrjax.program(partition_size=4)
        def prog(flag, x, ys):
            def summed(ops):
                x, ys = ops
                return jdrjax.reduce_sum(jdrjax.map_fn(
                    lambda a, b: a * b, (jdrjax.broadcast(x), ys)))

            def biggest(ops):
                x, ys = ops
                return jdrjax.reduce_max(ys) * x

            return jax.lax.cond(flag, summed, biggest, (x, ys))
        return prog, tuple(map(jnp.asarray, args)), 4

    @drjax.program(partition_size=4)
    def tprog(flag, x, ys):
        def summed(x, ys):
            return (drjax.reduce_sum(drjax.map_fn(
                lambda a, b: a * b, (drjax.broadcast(x), ys))),)

        def biggest(x, ys):
            return (drjax.reduce_max(ys) * x,)

        return cond_op(flag, summed, biggest, (x, ys))[0]
    return tprog, tuple(map(_t, args)), 4


def _nested(pkg):
    """The nested 2 x 4 two-level reduce."""
    mod = jdrjax if pkg == "jax" else drjax

    @mod.program(placements={"pods": 2, "clients": 4})
    def pod_round(model, tasks):
        grads = mod.map_fn(lambda m, t: 2.0 * (m - t),
                           (mod.broadcast(model), tasks))
        pod_partials = mod.reduce_mean(grads, placement="clients")
        return mod.reduce_mean(pod_partials, placement="pods")

    args = (np.float32(0.5), np.arange(8, dtype=np.float32).reshape(2, 4))
    conv = jnp.asarray if pkg == "jax" else _t
    return pod_round, tuple(map(conv, args)), {"pods": 2, "clients": 4}


def _fused_int8(pkg):
    """The fused int8 hierarchical reduce of a tree of client deltas."""
    mod, comp = (jdrjax, jcomp) if pkg == "jax" else (drjax, tcomp)

    @mod.program(placements={"pods": 2, "clients": 2})
    def f(tree):
        return mod.hierarchical_reduce_mean(tree, compress_fn=comp.int8_roundtrip)

    rng = np.random.default_rng(5)
    tree = {"a": (rng.standard_normal((2, 2, 300)) * 1e-2).astype(np.float32),
            "b": (rng.standard_normal((2, 2, 7, 40)) * 1e-2).astype(np.float32)}
    conv = jnp.asarray if pkg == "jax" else _t
    return f, ({k: conv(v) for k, v in tree.items()},), {"pods": 2, "clients": 2}


PROGRAMS = {
    "quadratic_round": _quadratic_round,
    "maml": maml,
    "maml_grad": functools.partial(maml, grad_of=True),
    "scan": _scan,
    "while_body": functools.partial(_while, in_predicate=False),
    "while_predicate": functools.partial(_while, in_predicate=True),
    "cond_true": functools.partial(_cond, flag=True),
    "cond_false": functools.partial(_cond, flag=False),
    "nested_2x4": _nested,
    "fused_int8": _fused_int8,
}


def both(name):
    jfn, jargs, place = PROGRAMS[name]("jax")
    tfn, targs, _ = PROGRAMS[name]("torch")
    return jfn, jargs, tfn, targs, place


# ---------------------------------------------------------------------------
# the shipped rounds at reduced lm_350m
# ---------------------------------------------------------------------------


STEPS, BATCH, SEQ = 1, 1, 8


@functools.lru_cache(maxsize=None)
def load_model():
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(tcfg, jax.device_get(jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def _round_data(cohort, lead, rounds_axis=0):
    jsamp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                   cohort_size=cohort)
    tsamp = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=cohort)
    jb, tb = [], []
    for r in range(max(rounds_axis, 1)):
        jd = jsamp.round_batch(r, STEPS, BATCH, SEQ)
        td = tsamp.round_batch(r, STEPS, BATCH, SEQ, device="cpu")
        jb.append({k: jd[k].reshape(lead + jd[k].shape[1:])
                   for k in ("tokens", "labels")})
        tb.append({k: td[k].reshape(lead + tuple(td[k].shape[1:]))
                   for k in ("tokens", "labels")})
    if rounds_axis:
        return ({k: jnp.stack([b[k] for b in jb]) for k in jb[0]},
                {k: torch.stack([b[k] for b in tb]) for k in tb[0]})
    return jb[0], tb[0]


def _tokens(seed, lead):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, lead + (SEQ + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


PIPE_STAGES, PIPE_MICRO = 2, 4


def pipelined(model):
    """Reduced lm_350m's layers as a pipeline, in both packages: stage s
    applies layer s (``block_apply``, closed over its parameters) to the
    (batch, seq, d) activation; M microbatches of seeded activations and a
    zero buffer."""
    jcfg, tcfg, jparams, tparams = model
    positions = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ))
    jpos, tpos = jnp.asarray(positions), torch.from_numpy(positions.copy())

    def jstage(s):
        layer = jax.tree_util.tree_map(lambda a: a[s], jparams["layers"])
        return lambda x: jblocks.block_apply(jcfg, "attention", layer, x,
                                             jpos)[0]

    def tstage(s):
        layer = transformer.layer_params(tparams, s)
        return lambda x: blocks.block_apply(tcfg, "attention", layer, x,
                                            tpos)[0]

    rng = np.random.default_rng(11)
    mb = rng.standard_normal((PIPE_MICRO, BATCH, SEQ, tcfg.d_model)).astype(
        np.float32)
    act0 = np.zeros((PIPE_STAGES, BATCH, SEQ, tcfg.d_model), np.float32)
    jr = jpipeline.make_pipelined_round(
        [jstage(s) for s in range(PIPE_STAGES)],
        jpipeline.PipelineConfig(PIPE_STAGES, PIPE_MICRO))
    tr = tpipeline.make_pipelined_round(
        [tstage(s) for s in range(PIPE_STAGES)],
        tpipeline.PipelineConfig(PIPE_STAGES, PIPE_MICRO))
    return (jr, (jnp.asarray(mb), jnp.asarray(act0)), tr,
            (_t(mb), _t(act0)), (("stages", PIPE_STAGES, "stages"),))


def shipped(kind, model):
    jcfg, tcfg, jparams, tparams = model
    jloss = functools.partial(jreg.loss_fn, jcfg)
    tloss = functools.partial(registry.loss_fn, tcfg)
    if kind == "pipeline":
        return pipelined(model)
    if kind == "maml_step":
        jtasks, ttasks = zip(*(_both(_tokens(s, (2, BATCH))) for s in (1, 2)))
        _, jstep = jmaml.make_parallel_maml(jloss, 2, inner_lr=0.05)
        _, tstep = tmaml.make_parallel_maml(tloss, 2, inner_lr=0.05)
        return (jstep, (jparams, dict(zip(("support", "query"), jtasks))),
                tstep, (tparams, dict(zip(("support", "query"), ttasks))), 2)
    if kind == "btm":
        jd, td = _both(_tokens(3, (2, STEPS, BATCH)))
        jfn = jbtm.branch_train_merge(jloss, jopt.sgd(0.05), 2, STEPS)
        tfn = tbtm.branch_train_merge(tloss, optim.sgd(0.05), 2, STEPS)
        return jfn, (jparams, jd), tfn, (tparams, td), 2
    jserver, tserver = jopt.fedavg_momentum(1.0), optim.fedavg_momentum(1.0)
    pods = 2 if kind == "hier_int8" else 0
    compression = {"flat_int8": "int8", "topk": "topk",
                   "hier_int8": "int8"}.get(kind)
    cohort = 4 if pods else 2
    per = cohort // pods if pods else cohort

    def cfg(mod):
        return mod.LocalSGDConfig(partition_size=per, num_local_steps=STEPS,
                                  grad_clip=1.0, compression=compression,
                                  num_pods=pods, topk_fraction=0.05)

    lead = (pods, per) if pods else (cohort,)
    jstate, tstate = jserver.init(jparams), tserver.init(tparams)
    place = {"pods": pods, "clients": per} if pods else cohort
    if kind == "async":
        jr, jinit = jasync.make_async_local_sgd_round(
            jloss, jopt.sgd(0.05), jserver, cfg(jrounds))
        tr, tinit = async_rounds.make_async_local_sgd_round(
            tloss, optim.sgd(0.05), tserver, cfg(rounds))
        jb, tb = _round_data(cohort, lead)
        return (jr, (jparams, jinit(jparams), jstate, jb), tr,
                (tparams, tinit(tparams), tstate, tb), place)
    if kind == "fedsgd_learned":
        jr = jrounds.make_fedsgd_round(jloss, jserver, cfg(jrounds),
                                       learned_weights=True)
        tr = rounds.make_fedsgd_round(tloss, tserver, cfg(rounds),
                                      learned_weights=True)
        jb, tb = _round_data(cohort, lead)
        jb = jax.tree_util.tree_map(lambda x: x[:, 0], jb)
        tb = {k: v[:, 0] for k, v in tb.items()}
        w = np.array([0.3, -0.2], np.float32)
        return (jr, (jparams, jstate, jb, jnp.asarray(w)), tr,
                (tparams, tstate, tb, _t(w)), place)
    jmake = (jrounds.make_hierarchical_local_sgd_round if pods
             else jrounds.make_local_sgd_round)
    tmake = (rounds.make_hierarchical_local_sgd_round if pods
             else rounds.make_local_sgd_round)
    jr = jmake(jloss, jopt.sgd(0.05), jserver, cfg(jrounds))
    tr = tmake(tloss, optim.sgd(0.05), tserver, cfg(rounds))
    if kind == "multi_round":
        jb, tb = _round_data(cohort, lead, rounds_axis=2)
        return (jrounds.make_multi_round(jr, 2), (jparams, jstate, jb),
                rounds.make_multi_round(tr, 2), (tparams, tstate, tb), place)
    jb, tb = _round_data(cohort, lead)
    return jr, (jparams, jstate, jb), tr, (tparams, tstate, tb), place


SHIPPED = ["flat", "flat_int8", "topk", "hier_int8", "async", "multi_round",
           "fedsgd_learned", "pipeline", "maml_step", "btm"]


def shipped_plans(kind, model):
    """Both packages' plans of a shipped round. The inputs' depths are
    declared (every argument at the server but the round data, whose group
    axes lead it; a multi-round trainer's data leads with its rounds axis,
    so it is server data): the depth heuristic would take a reduced model's
    2-layer leaves for 2 groups."""
    jr, jargs, tr, targs, place = shipped(kind, model)
    depth = 2 if isinstance(place, dict) else 1
    data_at = {"async": 3, "fedsgd_learned": 2, "pipeline": 1,
               "maml_step": 1, "btm": 1}.get(kind, 2)
    jdepths = [depth if i == data_at else 0 for i, a in enumerate(jargs)
               for _ in jax.tree_util.tree_leaves(a)]
    tdepths = [depth if i == data_at else 0 for i, a in enumerate(targs)
               for _ in pytree.tree_leaves(a)]
    if kind == "multi_round":
        jdepths, tdepths = [0] * len(jdepths), [0] * len(tdepths)
    gm = interp.trace(tr, *targs)
    tp = interp.build_plan(gm, place, partitioned_invars=tdepths)
    jp = jdrjax.build_plan(jax.make_jaxpr(jr)(*jargs), place,
                           partitioned_invars=jdepths)
    return jp, tp, tr, targs


