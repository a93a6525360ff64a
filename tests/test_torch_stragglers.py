"""Straggler-masked rounds in the port against the reference: the simulated
durations and masks, the weighted and masked reductions with their
gradients, masked rounds of reduced lm_350m (flat and hierarchical) and
``launch.train --stragglers``.

Durations and masks must be bitwise (both draw from numpy with the same
seeding). The reductions and their gradients match at rtol = atol = 1e-6
(f32). The reference's rounds run un-jitted (plan building of jitted
rounds fails on the installed JAX; the round itself is the same function).
An uncompressed masked round: params within atol 1e-5, loss within rtol
1e-5, as the unmasked rounds in ``test_torch_round.py``. A masked int8
round compresses per client, so each element lies within the masked mean
of the clients' quantization steps plus 1e-6, and at least 95% of the new
parameters equal the reference's bitwise.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jdrjax  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import stragglers as jstrag  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import stragglers  # noqa: E402
from test_torch_round import STEPS, _data, _leaves, _steps  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


# --- durations, masks, round time ---------------------------------------

@pytest.mark.parametrize("sim", [{}, {"median_s": 10.0, "sigma": 0.8},
                                 {"seed": 5, "sigma": 1.3}])
def test_durations_bitwise(sim):
    for round_idx in (0, 1, 17):
        for n in (1, 4, 64):
            np.testing.assert_array_equal(
                stragglers.StragglerSimulator(**sim).durations(round_idx, n),
                jstrag.StragglerSimulator(**sim).durations(round_idx, n))


# (durations, deadline, min_finishers, mask, round time or None): every case
# of the reference's tests/test_runtime.py TestStragglers and
# TestStragglerEdgeCases.
MASK_CASES = [
    ([1.0, 2.0, 50.0, 3.0], 10.0, None, [1, 1, 0, 1], None),
    ([100.0, 200.0, 300.0, 400.0], 1.0, 2, [1, 1, 0, 0], None),
    ([5.0, 50.0, 500.0], 1.0, 3, [1, 1, 1], 500.0),
    ([5.0, 50.0, 500.0], 1.0, 10, [1, 1, 1], 500.0),
    ([1.0, 2.0, 50.0], 10.0, None, [1, 1, 0], None),
    ([1.0, 2.0, 50.0], 10.0, 0, [1, 1, 0], None),
    ([20.0, 30.0, 40.0], 10.0, None, [0, 0, 0], 10.0),
    ([20.0, 30.0, 40.0], 10.0, 2, [1, 1, 0], 30.0),
]


@pytest.mark.parametrize("durations,deadline,k,mask,seconds", MASK_CASES)
def test_mask_and_round_time(durations, deadline, k, mask, seconds):
    d = np.array(durations)
    got = stragglers.straggler_mask(d, deadline, min_finishers=k)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), mask)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jstrag.straggler_mask(d, deadline, min_finishers=k)))
    t = stragglers.effective_round_time(d, deadline, min_finishers=k)
    assert t == jstrag.effective_round_time(d, deadline, min_finishers=k)
    if seconds is not None:
        assert t == seconds


def test_dropping_cuts_round_time():
    durations = stragglers.StragglerSimulator(sigma=0.8).durations(0, 64)
    deadline = float(np.percentile(durations, 90))
    t = stragglers.effective_round_time(durations, deadline, min_finishers=32)
    assert t < durations.max()


def test_train_masks_match_the_reference_draw():
    """``launch.train.round_mask`` is the reference's ``launch.train``
    mask: cohort durations, the percentile deadline, half the cohort
    kept."""
    args = train.parse_args(["--cohort", "4", "--stragglers",
                             "--straggler-deadline-pct", "90"])
    sim, jsim = stragglers.StragglerSimulator(), jstrag.StragglerSimulator()
    dropped = 0
    for r in range(8):
        d = jsim.durations(r, 4)
        want = jstrag.straggler_mask(d, float(np.percentile(d, 90)),
                                     min_finishers=2)
        got = train.round_mask(sim, r, args, "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dropped += int(4 - got.sum())
    assert dropped > 0


# --- weighted and masked reductions --------------------------------------

def _programs(mod, placement):
    """(flat, nested) programs of a weighted mean and their stacks."""

    @mod.program(partition_size=4)
    def flat(x, w, c):
        return (mod.reduce_weighted_mean(x, w) * c).sum()

    @mod.program(placements={"pods": 2, "clients": 3})
    def nested(x, w, c):
        return (mod.reduce_weighted_mean({"a": x}, w,
                                         placement=placement)["a"] * c).sum()

    return flat, nested


CASES = [  # (program, x shape, w shape, c shape, placement)
    ("flat", (4, 5), (4,), (5,), None),
    ("nested", (2, 3, 5), (2, 3), (5,), None),
    ("nested", (2, 3, 5), (2, 3), (2, 5), "clients"),
]


@pytest.mark.parametrize("weights", ["random", "mask", "zeros"])
@pytest.mark.parametrize("prog,xs,ws,cs,placement", CASES)
def test_weighted_mean_values_and_grads(prog, xs, ws, cs, placement, weights):
    rng = np.random.default_rng(len(xs) + len(cs))
    x = rng.standard_normal(xs).astype(np.float32)
    c = rng.standard_normal(cs).astype(np.float32)
    w = {"random": rng.uniform(0.1, 2.0, ws),
         "mask": (rng.uniform(size=ws) > 0.4),
         "zeros": np.zeros(ws)}[weights].astype(np.float32)
    if weights == "mask":
        w.reshape(-1)[0] = 1.0
    jfn = dict(zip(("flat", "nested"), _programs(jdrjax, placement)))[prog]
    tfn = dict(zip(("flat", "nested"), _programs(drjax, placement)))[prog]
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(c))
    want = float(jfn(*jargs))
    jgx, jgw = jax.grad(jfn, argnums=(0, 1))(*jargs)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    out = tfn(tx, tw, torch.from_numpy(c))
    gx, gw = torch.autograd.grad(out, (tx, tw))
    np.testing.assert_allclose(float(out.detach()), want, **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **TOL)
    assert torch.isfinite(gx).all() and torch.isfinite(gw).all()
    if weights == "zeros":
        assert float(out.detach()) == 0.0


def test_masked_mean_is_the_mean_of_finishers():
    @drjax.program(partition_size=6)
    def f(xs, mask):
        return drjax.masked_reduce_mean(xs, mask)

    xs = torch.arange(6, dtype=torch.float32)
    mask = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.float32)
    assert float(f(xs, mask)) == (0 + 1 + 3 + 5) / 4.0
    assert float(f(xs, torch.zeros(6))) == 0.0


def test_weighted_mean_refuses_mismatched_shapes():
    @drjax.program(placements={"pods": 2, "clients": 3})
    def f(x, w, placement=None):
        return drjax.reduce_weighted_mean(x, w, placement=placement)

    with pytest.raises(ValueError, match=r"expected shape \(2, 3\)"):
        f(torch.ones((2, 3, 4)), torch.ones(6))
    with pytest.raises(ValueError, match=r"expected shape \(2,\)"):
        f(torch.ones((2, 4)), torch.ones((2, 3)), placement="pods")
    with pytest.raises(ValueError, match="do not match a leaf"):
        f(torch.ones((3, 2, 4)), torch.ones((2, 3)))


# --- masked rounds of reduced lm_350m -----------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


def _masked_round(setup, mask, compression=None, pods=0):
    """One masked round of the reference (un-jitted) and of the port from
    the same params and data: (old, reference new, reference loss, port
    new, port loss), as numpy trees in the reference's layout."""
    jcfg, tcfg, jparams = setup
    cohort = mask.size
    jb, tb = _data(cohort, pods)
    per = cohort // pods if pods else cohort
    made = []
    for mod, ropt, make_cfg in ((jrounds, jopt, jrounds.LocalSGDConfig),
                                (rounds, optim, rounds.LocalSGDConfig)):
        cfg = make_cfg(partition_size=per, num_local_steps=STEPS,
                       grad_clip=1.0, compression=compression, num_pods=pods,
                       straggler_mask=True)
        make = (mod.make_hierarchical_local_sgd_round if pods
                else mod.make_local_sgd_round)
        reg = jreg if mod is jrounds else registry
        model_cfg = jcfg if mod is jrounds else tcfg
        server = ropt.fedavg_momentum(1.0)
        made.append((make(functools.partial(reg.loss_fn, model_cfg),
                          ropt.sgd(0.05), server, cfg), server))
    (jround, jserver), (tround, tserver) = made
    jnew, _, jm = jround(jparams, jserver.init(jparams), jb, jnp.asarray(mask))
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    tnew, _, tm = tround(params, tserver.init(params), tb, torch.from_numpy(mask))
    return (jax.device_get(jparams), jax.device_get(jnew), float(jm["loss"]),
            convert.params_to_numpy(tcfg, tnew), float(tm["loss"]))


def test_masked_flat_round_matches_reference(setup):
    mask = np.array([1, 0, 1, 1], np.float32)
    old, jnew, jloss, tnew, tloss = _masked_round(setup, mask)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    got = dict(_leaves(tnew))
    for name, want in _leaves(jnew):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert any(float(np.abs(w - o).max()) > 0 for (_, w), (_, o)
               in zip(_leaves(jnew), _leaves(old)))


def _client_deltas(setup, cohort):
    """Each client's uncompressed delta, computed by the port."""
    _, tcfg, jparams = setup
    _, tb = _data(cohort)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
        rounds.LocalSGDConfig(partition_size=cohort, num_local_steps=STEPS,
                              grad_clip=1.0))
    with torch.no_grad():
        return [client(params, {k: v[c] for k, v in tb.items()})[0]
                for c in range(cohort)]


@pytest.mark.parametrize("pods,mask", [
    (0, [1, 1, 0, 1]),
    (2, [[1, 1], [0, 0]]),   # a whole pod dropped
    (2, [[0, 1], [1, 1]]),
], ids=["flat", "hier_pod_dropped", "hier_one_dropped"])
def test_masked_int8_round_within_one_step(setup, pods, mask):
    mask = np.array(mask, np.float32)
    old, jnew, jloss, tnew, tloss = _masked_round(setup, mask, "int8", pods)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    w = mask.reshape(-1)
    steps = [_steps(setup[1], d) for d in _client_deltas(setup, w.size)]
    got = dict(_leaves(tnew))
    equal = total = 0
    for (name, want), (_, base) in zip(_leaves(jnew), _leaves(old)):
        tol = sum(wi * s[name] for wi, s in zip(w, steps)) / w.sum() + 1e-6
        assert (np.abs((got[name] - base) - (want - base)) <= tol).all(), name
        equal += int((got[name] == want).sum())
        total += want.size
    assert equal / total >= 0.95, equal / total


@pytest.mark.parametrize("pods", [0, 2], ids=["flat", "hier"])
def test_all_dropped_round_leaves_params_unchanged(setup, pods):
    mask = np.zeros((2, 2) if pods else (4,), np.float32)
    old, jnew, _, tnew, tloss = _masked_round(setup, mask, "int8", pods)
    for (name, o), (_, t), (_, j) in zip(_leaves(old), _leaves(tnew),
                                         _leaves(jnew)):
        np.testing.assert_array_equal(t, o, err_msg=name)
        np.testing.assert_array_equal(j, o, err_msg=name)
    assert tloss == 0.0


def test_masked_hierarchical_round_compresses_per_client(setup):
    """The masked hierarchical int8 round quantizes each client's delta (4
    quantize launches' worth of calls on the CPU path) and never runs the
    fused pod-partial reduce."""
    from unittest import mock

    from repro_torch.kernels import ops

    with mock.patch.object(ops, "quantize", wraps=ops.quantize) as q, \
            mock.patch.object(ops, "reduce_compress_roundtrip",
                              wraps=ops.reduce_compress_roundtrip) as fused:
        _masked_round(setup, np.ones((2, 2), np.float32), "int8", pods=2)
    assert q.call_count == 4 and fused.call_count == 0


def test_all_ones_mask_is_the_unmasked_round_bitwise(setup):
    """Weights of 1 make ``sum(x w) / sum(w)`` the same sums as ``sum(x) /
    4``: the masked round equals the unmasked one bitwise (4 is a power of
    two, so the division by the tensor sum and by the scalar agree)."""
    _, tcfg, jparams = setup
    _, tb = _data(4)
    cfg = rounds.LocalSGDConfig(partition_size=4, num_local_steps=STEPS,
                                grad_clip=1.0, compression="int8",
                                straggler_mask=True)
    server = optim.fedavg_momentum(1.0)
    round_fn = rounds.make_local_sgd_round(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05), server, cfg)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    a, _, ma = round_fn(params, server.init(params), tb)
    b, _, mb = round_fn(params, server.init(params), tb, torch.ones(4))
    assert float(ma["loss"]) == float(mb["loss"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_runs_stragglers_on_cpu(capsys, tmp_path):
    train.main(["--reduced", "--rounds", "2", "--cohort", "4",
                "--local-steps", "2", "--compression", "int8", "--stragglers",
                "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"arch", "algorithm", "rounds", "restarts",
                            "first_loss", "final_loss"}
    assert summary["rounds"] == 2 and np.isfinite(summary["final_loss"])


@pytest.mark.parametrize("flag", [["--chaos", "--physical"]])
def test_train_still_rejects_unported_flags(flag):
    """``--chaos`` is ported (``tests/test_torch_chaos.py``); the physical
    soak (the reference's ``benchmarks/chaos.py --physical``) is not, and
    `launch.train` has no flag for it."""
    with pytest.raises(SystemExit):
        train.parse_args(flag)


@pytest.mark.parametrize("flag", [["--fail-at", "1"], ["--ckpt-every", "1"],
                                  ["--compression", "topk"]],
                         ids=["fail_at", "ckpt_every", "topk"])
def test_train_takes_the_ported_flags(flag, tmp_path, capsys):
    """The flags the earlier slices rejected now parse, with the reference's
    defaults, and run: a failure at round 1 is recovered."""
    defaults = train.parse_args([])
    assert (defaults.ckpt_dir, defaults.ckpt_every, defaults.fail_at) == (
        "/tmp/repro_ckpt", 20, [])
    train.main(["--reduced", "--rounds", "2", "--cohort", "2",
                "--local-steps", "1", "--ckpt-dir", str(tmp_path),
                "--device", "cpu", *flag])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["restarts"] == (1 if flag[0] == "--fail-at" else 0)
    assert np.isfinite(summary["final_loss"])
