"""One DrJAX training round of reduced lm_350m in the port against the
reference's round, from the same parameters and the same data.

The reference rounds run un-jitted (plan building of jitted rounds fails on
the installed JAX; the round itself is the same function). Without
compression: params within atol 1e-5, loss within rtol 1e-5. The DiLoCo
round's client AdamW uses eps = 1e-3 here: at its default 1e-8 a gradient
much smaller than eps moves by lr * dg / eps = 5e6 * dg, so gradients that
agree to f32 rounding (~1e-10) give updates ~5e-4 apart in any two
implementations that are not bitwise. AdamW itself is held to the reference
on identical gradients at eps = 1e-8.

With int8 (flat, and hierarchical 2 x 2 and 2 x 3 fused): each element
within one
quantization step of its 256-wide row plus 1e-6, since a 1-ulp difference
in a delta may flip one int8 value. The quantized values are the client
deltas (flat) or the pod partials (hierarchical) and the applied update is
their mean, so the bound is the mean of their steps. The row is taken in
both packings (the reference packs the layer-stacked leaves, the port one
leaf per layer) and the larger step counts. Since that bound would also
pass a roundtrip that did nothing, at least 95% of the new parameters must
also equal the reference's bitwise. The data streams are bit-identical.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.data import grouped as jgrouped  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.models import registry  # noqa: E402

STEPS, BATCH, SEQ = 2, 2, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


def _data(cohort, pods=0):
    jsamp = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                   cohort_size=cohort)
    tsamp = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                                  cohort_size=cohort)
    jd = jsamp.round_batch(0, STEPS, BATCH, SEQ)
    td = tsamp.round_batch(0, STEPS, BATCH, SEQ, device="cpu")
    lead = (pods, cohort // pods) if pods else (cohort,)
    jb = {k: jd[k].reshape(lead + jd[k].shape[1:]) for k in ("tokens", "labels")}
    tb = {k: td[k].reshape(lead + tuple(td[k].shape[1:]))
          for k in ("tokens", "labels")}
    return jb, tb


def _opts(mod, algorithm):
    client = mod.adamw(0.05, eps=1e-3) if algorithm == "diloco" else mod.sgd(0.05)
    server = (mod.diloco_optimizer(0.7, 0.9) if algorithm == "diloco"
              else mod.fedavg_momentum(1.0))
    return client, server


def _run(setup, algorithm, compression=None, pods=0, cohort=2, jit=False):
    jcfg, tcfg, jparams = setup
    jb, tb = _data(cohort, pods)
    jclient, jserver = _opts(jopt, algorithm)
    tclient, tserver = _opts(optim, algorithm)
    per = cohort // pods if pods else cohort
    jround_cfg = jrounds.LocalSGDConfig(
        partition_size=per, num_local_steps=STEPS, grad_clip=1.0,
        compression=compression, num_pods=pods)
    tround_cfg = rounds.LocalSGDConfig(
        partition_size=per, num_local_steps=STEPS, grad_clip=1.0,
        compression=compression, num_pods=pods)
    jmake = (jrounds.make_hierarchical_local_sgd_round if pods
             else jrounds.make_local_sgd_round)
    tmake = (rounds.make_hierarchical_local_sgd_round if pods
             else rounds.make_local_sgd_round)
    jround = jmake(functools.partial(jreg.loss_fn, jcfg), jclient, jserver,
                   jround_cfg)
    tround = tmake(functools.partial(registry.loss_fn, tcfg), tclient, tserver,
                   tround_cfg)
    if jit:
        jround = jax.jit(jround)
    jnew, _, jm = jround(jparams, jserver.init(jparams), jb)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    tnew, tstate, tm = tround(params, tserver.init(params), tb)
    assert int(tstate["step"]) == 1
    return (jax.device_get(jparams), jax.device_get(jnew), float(jm["loss"]),
            convert.params_to_numpy(tcfg, tnew), float(tm["loss"]))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


def _row_step(d: np.ndarray) -> np.ndarray:
    flat = np.abs(d).reshape(-1)
    rows = np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
    step = np.broadcast_to(rows.max(axis=1, keepdims=True) / 127.0, rows.shape)
    return step.reshape(-1)[: flat.size].reshape(d.shape)


@pytest.mark.parametrize("algorithm", ["local_sgd", "diloco"])
def test_uncompressed_round_matches_reference(setup, algorithm):
    old, jnew, jloss, tnew, tloss = _run(setup, algorithm)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    got = dict(_leaves(tnew))
    for name, want in _leaves(jnew):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)
    moved = sum(float(np.abs(w - o).max()) for (_, w), (_, o)
                in zip(_leaves(jnew), _leaves(old)))
    assert moved > 0


def test_cohort3_round_matches_jitted_reference(setup):
    """P1: at a cohort that is not a power of two the reference's driver
    (which jits) averages with f32(1/3); so does the port."""
    old, jnew, jloss, tnew, tloss = _run(setup, "local_sgd", cohort=3, jit=True)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    got = dict(_leaves(tnew))
    for name, want in _leaves(jnew):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)


def _quantized_values(setup, cohort, pods):
    """What the int8 round quantizes, computed uncompressed by the port: one
    delta per client (flat) or one partial mean per pod (hierarchical)."""
    _, tcfg, jparams = setup
    _, tb = _data(cohort, pods)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
        rounds.LocalSGDConfig(partition_size=cohort, num_local_steps=STEPS,
                              grad_clip=1.0))
    flat = {k: v.reshape((cohort,) + tuple(v.shape[2:])) for k, v in tb.items()} \
        if pods else tb
    with torch.no_grad():
        deltas = [client(params, {k: v[c] for k, v in flat.items()})[0]
                  for c in range(cohort)]
    if not pods:
        return deltas
    per = cohort // pods
    return [{k: sum(d[k] for d in deltas[p * per:(p + 1) * per]) / per
             for k in deltas[0]} for p in range(pods)]


def _steps(tcfg, value):
    """Per element, max of its row step in the reference's packing (the
    layer-stacked leaf) and in the port's (one leaf per layer)."""
    out = {}
    for name, v in _leaves(convert.params_to_numpy(tcfg, value)):
        step = _row_step(v)
        if name.startswith("layers."):
            step = np.maximum(step, np.stack([_row_step(x) for x in v]))
        out[name] = step
    return out


@pytest.mark.parametrize("pods,cohort", [(0, 2), (2, 4), (2, 6)],
                         ids=["flat", "hier_2x2_fused", "hier_2x3_fused"])
def test_int8_round_within_one_step(setup, pods, cohort):
    old, jnew, jloss, tnew, tloss = _run(setup, "local_sgd", "int8", pods=pods,
                                         cohort=cohort)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    values = _quantized_values(setup, cohort, pods)
    steps = [_steps(setup[1], v) for v in values]
    got = dict(_leaves(tnew))
    equal = total = 0
    for (name, want), (_, base) in zip(_leaves(jnew), _leaves(old)):
        tol = sum(s[name] for s in steps) / len(steps) + 1e-6
        assert (np.abs((got[name] - base) - (want - base)) <= tol).all(), name
        equal += int((got[name] == want).sum())
        total += want.size
    # The step bound alone would pass a roundtrip that did nothing (it is
    # off by at most half a step); both sides quantizing the same values
    # agree bitwise almost everywhere (0.99 measured on both forms).
    assert equal / total >= 0.95, equal / total


def test_adamw_matches_reference_on_identical_grads():
    """AdamW at its default eps = 1e-8, on gradients spanning 1e-10..1."""
    from repro.optim import optimizers as jopt_mod

    rng = np.random.default_rng(0)
    p = rng.standard_normal(1000).astype(np.float32)
    jo, to = jopt.adamw(0.05), optim.adamw(0.05)
    jp, tp = {"p": jnp.asarray(p)}, {"p": torch.from_numpy(p)}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = (rng.standard_normal(1000) * 10.0 ** rng.integers(-10, 0, 1000))
        g = g.astype(np.float32)
        ju, js = jo.update({"p": jnp.asarray(g)}, js, jp)
        tu, ts = to.update({"p": torch.from_numpy(g)}, ts, tp)
        jp = jopt_mod.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
        np.testing.assert_allclose(tu["p"].numpy(), np.asarray(ju["p"]),
                                   rtol=0, atol=1e-7)
    np.testing.assert_allclose(tp["p"].numpy(), np.asarray(jp["p"]),
                               rtol=0, atol=1e-7)


def test_streams_bit_identical():
    for corpus_args in ({"vocab_size": 256}, {"vocab_size": 32768, "seed": 3}):
        jc = jgrouped.GroupedCorpus(**corpus_args)
        tc = grouped.GroupedCorpus(**corpus_args)
        np.testing.assert_array_equal(tc.group_batches(5, 2, 3, 2, 8),
                                      jc.group_batches(5, 2, 3, 2, 8))
        js = jgrouped.CohortSampler(jc, cohort_size=4, oversample=1)
        ts = grouped.CohortSampler(tc, cohort_size=4, oversample=1)
        for r in range(3):
            np.testing.assert_array_equal(ts.cohort(r), js.cohort(r))
            jd = js.round_batch(r, 2, 2, 8)
            td = ts.round_batch(r, 2, 2, 8, device="cpu")
            for k in ("tokens", "labels"):
                assert td[k].dtype == torch.int32
                np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


# ---------------------------------------------------------------------------
# R7 (ROADMAP.md): the reference's off-TPU fused reduce forms the f32
# partial as a gemm with weights 1/G and rounds a non-f32 partial to its
# dtype before quantizing; its Pallas kernel, which the port follows, does
# neither. 3 clients a pod (f32) and bf16 leaves show it.
# ---------------------------------------------------------------------------


def _pallas_roundtrip(x):
    """The reference's K3b Pallas kernel, interpreted, per pod."""
    from repro.kernels import reduce_compress as jrc

    return jax.vmap(lambda p: jrc.reduce_compress_roundtrip(
        p, interpret=True))(x)


def _k3b_bitwise(buf):
    from repro_torch.kernels import ref

    back, q, s = ref.reduce_compress_roundtrip_ref(buf)
    jbuf = jnp.asarray(buf.float().numpy()).astype(
        jnp.bfloat16 if buf.dtype == torch.bfloat16 else jnp.float32)
    jback, jq, js = _pallas_roundtrip(jbuf)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback).astype(np.float32))


def test_r7_hier_2x3_k3b_bitwise_to_the_interpreted_kernel(setup):
    """The 2 x 3 round's packed client deltas, (2, 3, R, 256) f32: the
    port's K3b plain version bitwise to the interpreted Pallas kernel."""
    from repro_torch.compression import api as compression

    _, tcfg, jparams = setup
    _, tb = _data(6, 2)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams),
                                     device="cpu")
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
        rounds.LocalSGDConfig(partition_size=3, num_local_steps=STEPS,
                              grad_clip=1.0))
    with torch.no_grad():
        deltas = [[client(params, {k: v[p, c] for k, v in tb.items()})[0]
                   for c in range(3)] for p in range(2)]
    stacked = {k: torch.stack([torch.stack([d[k] for d in pod])
                               for pod in deltas]) for k in deltas[0][0]}
    bufs, _ = compression.flat_pack(stacked, lead_ndim=2)
    (buf,) = bufs.values()
    assert buf.shape[:2] == (2, 3) and buf.dtype == torch.float32
    _k3b_bitwise(buf)


def _bf16_round(pkg):
    """A fused-int8 hierarchical round (2 pods x 2 clients) whose client
    deltas are bf16 leaves: each client's delta is (data - params) / 16 in
    bf16 (a power of two, so both packages round alike), the pod partials
    cross int8, and the round returns params + the mean delta in f32."""
    if pkg == "jax":
        from repro import compression as comp
        from repro import core as mod
        tree_map = jax.tree_util.tree_map

        def sub(a, b):
            return (b - a.astype(jnp.bfloat16)) * 0.0625

        def add(p, m):
            return p + m.astype(jnp.float32)
    else:
        from torch.utils import _pytree as pytree

        from repro_torch import compression as comp
        from repro_torch import core as mod
        tree_map = pytree.tree_map

        def sub(a, b):
            return (b - a.to(torch.bfloat16)) * 0.0625

        def add(p, m):
            return p + m.float()

    @mod.program(placements={"pods": 2, "clients": 2})
    def round_fn(params, data):
        deltas = mod.map_fn(lambda p, d: tree_map(sub, p, d),
                            (mod.broadcast(params), data))
        mean = mod.hierarchical_reduce_mean(deltas,
                                            compress_fn=comp.int8_roundtrip)
        return tree_map(add, params, mean)

    return round_fn


def _bf16_inputs():
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal(300).astype(np.float32),
              "b": rng.standard_normal((7, 40)).astype(np.float32)}
    data = {"a": rng.standard_normal((2, 2, 300)).astype(np.float32),
            "b": rng.standard_normal((2, 2, 7, 40)).astype(np.float32)}
    return params, data


def test_r7_bf16_leaf_round(monkeypatch):
    """bf16 leaves: the port's K3b plain version bitwise to the interpreted
    kernel on the round's packed deltas; the port's round bitwise to the
    reference's round run through that kernel; and within one int8 step
    of the pod partials' row, plus 2^-7 of the update and 1e-6, of the
    reference's CPU round. The 2^-7: that round rounds each partial to
    bf16 before quantizing (its scale comes from a rounded absmax) and
    rounds the roundtrip and the pod mean to bf16 again, up to a bf16 unit
    (2^-8) each beyond the step; measured at 1.6 steps without it
    (ROADMAP.md queue 3, R7)."""
    from repro.kernels import ops as jops
    from repro_torch.compression import api as compression

    params, data = _bf16_inputs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    td = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in data.items()}
    got = _bf16_round("torch")(tp, td)
    jargs = ({k: jnp.asarray(v) for k, v in params.items()},
             {k: jnp.asarray(v, jnp.bfloat16) for k, v in data.items()})
    cpu_round = _bf16_round("jax")(*jargs)

    deltas = {k: (td[k] - tp[k].to(torch.bfloat16)) * 0.0625 for k in td}
    bufs, _ = compression.flat_pack(deltas, lead_ndim=2)
    (buf,) = bufs.values()
    assert buf.dtype == torch.bfloat16
    _k3b_bitwise(buf)

    monkeypatch.setattr(
        jops, "reduce_compress_roundtrip",
        lambda x, axis=0, qaxis=-1, **kw: jops._reduce_compress_roundtrip_pallas(
            x, axis, qaxis % (x.ndim - 1), 256, True))
    kernel_round = _bf16_round("jax")(*jargs)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(kernel_round[k]))
        partial = deltas[k].float().mean(dim=1).numpy()
        step = np.mean([_row_step(partial[p]) for p in range(2)], axis=0)
        want = np.asarray(cpu_round[k])
        tol = step + 2.0 ** -7 * np.abs(want - params[k]) + 1e-6
        assert (np.abs(got[k].numpy() - want) <= tol).all(), k
