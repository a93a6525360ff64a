"""Top-k sparsification, error feedback and top-k rounds of the port against
the reference.

``topk_sparsify`` is bitwise the reference's (``lax.top_k`` keeps exactly
k entries, ties to the lower index), f32 and bf16, on the reference's
three tie cases, on a bf16-quantized delta with many ties at the cutoff,
and where fewer than k entries are nonzero; ``ErrorFeedback`` is bitwise
over 20 iterations.

Top-k rounds of reduced lm_350m, flat and hierarchical 2 x 2, from the
reference's parameters and data: losses within 1e-6 relative and params
within 1e-5, except where the two packages select different entries. Their
deltas agree to f32 rounding, not bitwise, so an entry whose magnitude
sits at a leaf's cutoff may be kept by one and not the other; such an
entry may differ by more, but only where the selections differ and
|delta| lies within 1e-5 relative of that leaf's k-th magnitude. The
count of such entries is reported.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.compression import ErrorFeedback as JEF  # noqa: E402
from repro.compression import topk_sparsify as jtopk  # noqa: E402
from repro.data import grouped as jgrouped  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.compression import ErrorFeedback, topk_sparsify  # noqa: E402
from repro_torch.compression import topk_sparsify_layers  # noqa: E402
from repro_torch.data import grouped  # noqa: E402
from repro_torch.models import registry  # noqa: E402

FRACTION = 0.01
STEPS, BATCH, SEQ = 2, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits (so -0.0 and +0.0 differ), via an int view."""
    t = t.detach().cpu().contiguous()
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype]).numpy()


def _jbits(a, dtype) -> np.ndarray:
    return _bits(torch.from_numpy(np.array(a, np.float32)).to(dtype))


def _check_topk(x: np.ndarray, fraction: float, dtype=torch.float32):
    """Port and reference on the same values; exactly k entries kept."""
    t = torch.from_numpy(x).to(dtype)
    got = topk_sparsify({"w": t}, fraction)["w"]
    want = jtopk({"w": jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)}, fraction)["w"]
    assert got.dtype == dtype and got.shape == t.shape
    np.testing.assert_array_equal(_bits(got), _jbits(want, dtype))
    k = max(int(t.numel() * fraction), 1)
    nnz = int(torch.count_nonzero(t))
    assert int(torch.count_nonzero(got)) == min(k, nnz)
    return got


@pytest.mark.parametrize("x,fraction,want", [
    ([0.1, -5.0, 0.2, 3.0, -0.05], 0.4, [0, -5.0, 0, 3.0, 0]),
    # k = 2, the cutoff |2| ties three ways: the lowest index wins
    ([1.0, -2.0, 2.0, -2.0, 3.0], 0.4, [0, -2.0, 0, 0, 3.0]),
    ([1.0] * 8, 0.5, [1.0] * 4 + [0.0] * 4),
], ids=["largest", "ties_at_cutoff", "all_tied"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_tie_cases_match_reference(x, fraction, want, dtype):
    got = _check_topk(np.array(x, np.float32), fraction, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.array(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000,), (64, 33), (3, 5, 7)])
def test_topk_random_matches_reference(dtype, shape):
    rng = np.random.default_rng(np.random.SeedSequence([11, len(shape)]))
    x = rng.standard_normal(shape).astype(np.float32)
    for fraction in (0.01, 0.1, 0.5, 1.0):
        _check_topk(x, fraction, dtype)


def test_topk_bf16_quantized_delta_with_many_ties():
    """A bf16 delta takes few distinct values: dozens of entries tie at the
    cutoff, and exactly k are kept, the lowest indices first."""
    rng = np.random.default_rng(np.random.SeedSequence([12]))
    x = (rng.standard_normal(100_000) * 1e-3).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    mag = x.float().abs()
    fraction = 0.05
    k = int(x.numel() * fraction)
    cutoff = torch.topk(mag, k).values[-1]
    assert int((mag == cutoff).sum()) > 50  # many ties at the cutoff
    assert int((mag > cutoff).sum()) < k
    for dtype in (torch.bfloat16, torch.float32):
        _check_topk(x.float().numpy(), fraction, dtype)


def test_topk_fewer_nonzeros_than_k_and_signed_zeros():
    x = np.zeros(300, np.float32)
    x[[5, 17, 200]] = [1.0, -3.0, 2.0]
    x[[1, 2, 3]] = -0.0
    got = _check_topk(x, 0.05, torch.float32)  # k = 15 > 3 nonzeros
    assert torch.count_nonzero(got) == 3


def test_topk_layers_counts_over_a_uniform_stack():
    """``topk_sparsify_layers`` of a port dict equals the reference's
    ``topk_sparsify`` of the same values with the layers stacked (axis 0,
    or axis 1 after a leading pods axis); a mixed stack goes per leaf."""
    rng = np.random.default_rng(np.random.SeedSequence([13]))
    layers = rng.standard_normal((3, 2, 40)).astype(np.float32)
    embed = rng.standard_normal((10, 4)).astype(np.float32)
    tree = {"embed": torch.from_numpy(embed)}
    tree.update({f"layers.{i}.w": torch.from_numpy(layers[i]) for i in range(3)})
    got = topk_sparsify_layers(tree, 0.1)
    want = jtopk({"embed": jnp.asarray(embed), "w": jnp.asarray(layers)}, 0.1)
    np.testing.assert_array_equal(got["embed"].numpy(), np.asarray(want["embed"]))
    np.testing.assert_array_equal(
        np.stack([got[f"layers.{i}.w"].numpy() for i in range(3)]),
        np.asarray(want["w"]))
    pods = {k: torch.stack([v, -2 * v]) for k, v in tree.items()}
    got = topk_sparsify_layers(pods, 0.1, layer_axis=1)
    want = jtopk({"w": jnp.stack([jnp.asarray(layers), -2 * jnp.asarray(layers)],
                                 axis=0)}, 0.1)
    np.testing.assert_array_equal(
        np.stack([got[f"layers.{i}.w"].numpy() for i in range(3)], axis=1),
        np.asarray(want["w"]))
    mixed = dict(tree, **{"layers.1.v": torch.ones(4)})
    assert all(torch.equal(a, b) for a, b in zip(
        topk_sparsify_layers(mixed, 0.1).values(),
        topk_sparsify(mixed, 0.1).values()))


def test_error_feedback_matches_reference_over_20_iterations():
    rng = np.random.default_rng(np.random.SeedSequence([14]))
    w = rng.standard_normal(256).astype(np.float32)
    tree, jtree = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    res, jres = ErrorFeedback.init(tree), JEF.init(jtree)
    sent = torch.zeros(256)
    for _ in range(20):
        comp, res = ErrorFeedback.compress(tree, res, topk_sparsify, 0.1)
        jcomp, jres = JEF.compress(jtree, jres, jtopk, 0.1)
        np.testing.assert_array_equal(_bits(comp["w"]), _jbits(jcomp["w"], torch.float32))
        np.testing.assert_array_equal(_bits(res["w"]), _jbits(jres["w"], torch.float32))
        sent += comp["w"]
    avg = (sent / 20).numpy()
    assert (w * avg).sum() / (np.linalg.norm(w) * np.linalg.norm(avg)) > 0.95


# ---------------------------------------------------------------------------
# top-k rounds against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_config("lm_350m").reduced()
    tcfg = registry.get_config("lm_350m").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams


def _data(cohort, pods):
    jd = jgrouped.CohortSampler(jgrouped.GroupedCorpus(vocab_size=256),
                                cohort_size=cohort).round_batch(0, STEPS, BATCH, SEQ)
    td = grouped.CohortSampler(grouped.GroupedCorpus(vocab_size=256),
                               cohort_size=cohort).round_batch(
        0, STEPS, BATCH, SEQ, device="cpu")
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


def _reference_leaves(tcfg, tree, pods):
    """name -> the reference's leaf of a port dict: layers stacked, after
    the pods axis when the leaves lead with one."""
    if not pods:
        return dict(_leaves(convert.params_to_numpy(tcfg, tree)))
    per_pod = [dict(_leaves(convert.params_to_numpy(
        tcfg, {k: x[p] for k, x in tree.items()}))) for p in range(pods)]
    return {n: np.stack([pp[n] for pp in per_pod]) for n in per_pod[0]}


def _sparsified_values(setup, tb, cohort, pods):
    """What the round sparsifies, computed uncompressed by the port: each
    client's delta (flat) or the pods' partial means (hierarchical), as
    the reference's leaves."""
    _, tcfg, jparams = setup
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
        rounds.LocalSGDConfig(partition_size=cohort, num_local_steps=STEPS,
                              grad_clip=1.0))
    flat = ({k: v.reshape((cohort,) + tuple(v.shape[2:])) for k, v in tb.items()}
            if pods else tb)
    with torch.no_grad():
        deltas = [client(params, {k: v[c] for k, v in flat.items()})[0]
                  for c in range(cohort)]
    if not pods:
        return [_reference_leaves(tcfg, d, 0) for d in deltas]
    per = cohort // pods
    partials = {k: torch.stack([sum(d[k] for d in deltas[p * per:(p + 1) * per])
                                / per for p in range(pods)])
                for k in deltas[0]}
    return [_reference_leaves(tcfg, partials, pods)]


def _round(setup, pods):
    jcfg, tcfg, jparams = setup
    cohort = 4 if pods else 2
    jb, tb = _data(cohort, pods)
    per = cohort // pods if pods else cohort
    kw = dict(partition_size=per, num_local_steps=STEPS, grad_clip=1.0,
              compression="topk", topk_fraction=FRACTION, num_pods=pods)
    jmake = (jrounds.make_hierarchical_local_sgd_round if pods
             else jrounds.make_local_sgd_round)
    tmake = (rounds.make_hierarchical_local_sgd_round if pods
             else rounds.make_local_sgd_round)
    jround = jax.jit(jmake(functools.partial(jreg.loss_fn, jcfg),
                           jopt.sgd(0.05), jopt.fedavg_momentum(1.0),
                           jrounds.LocalSGDConfig(**kw)))
    tround = tmake(functools.partial(registry.loss_fn, tcfg), optim.sgd(0.05),
                   optim.fedavg_momentum(1.0), rounds.LocalSGDConfig(**kw))
    server = jopt.fedavg_momentum(1.0)
    jnew, _, jm = jround(jparams, server.init(jparams), jb)
    params = convert.params_from_jax(tcfg, jax.device_get(jparams), device="cpu")
    tnew, _, tm = tround(params, optim.fedavg_momentum(1.0).init(params), tb)
    return (jax.device_get(jnew), float(jm["loss"]),
            convert.params_to_numpy(tcfg, tnew), float(tm["loss"]), tb, cohort)


@pytest.mark.parametrize("pods", [0, 2], ids=["flat", "hier_2x2"])
def test_topk_round_matches_reference(setup, pods):
    jnew, jloss, tnew, tloss, tb, cohort = _round(setup, pods)
    assert abs(tloss - jloss) <= 1e-6 * abs(jloss)
    # per sparsified value and reference leaf: the entries whose magnitude
    # lies within 1e-5 relative of that leaf's k-th magnitude, as a mask
    # over the parameter (any pod's entry, for a pod partial)
    near = []
    for value in _sparsified_values(setup, tb, cohort, pods):
        marks = {}
        for name, x in value.items():
            mag = np.abs(x.reshape(-1))
            cutoff = np.sort(mag)[-max(int(mag.size * FRACTION), 1)]
            m = (np.abs(mag - cutoff) <= 1e-5 * cutoff).reshape(x.shape)
            marks[name] = m.any(axis=0) if pods else m
        near.append(marks)
    got = dict(_leaves(tnew))
    base = dict(_leaves(jax.device_get(setup[2])))
    beyond = moved = 0
    for name, want in _leaves(jnew):
        bad = np.abs(got[name] - want) > 1e-5
        allowed = np.logical_or.reduce([m[name] for m in near])
        assert not (bad & ~allowed).any(), name
        beyond += int(bad.sum())
        moved += int((want != base[name]).sum())
    print(f"top-k round ({'hier' if pods else 'flat'}): {beyond} entries "
          f"beyond 1e-5, all at a cutoff; {moved} entries moved")
    assert moved > 0
