"""The port's sharding of DrJAX values on a mesh (``core/sharding.py``,
the primitives' collectives, ``compile_plan(mesh=)``, rounds on a mesh)
against ``tests/test_sharding.py``'s seven checks and the reference's
mesh-free programs, on gloo worlds of 2, 4 and 8 CPU ranks
(``_torch_dist.run_world``: one world per size for the whole module, each
check run in every rank; ``_torch_dist_checks`` holds the rank side).

Tolerances, against the port's own mesh-free run on the same inputs:
``broadcast``, ``map_fn``, ``stage_map``, ``stage_transfer`` and the exact
gather (the int8-fused reduce's payload) are bitwise; ``reduce_sum`` /
``reduce_mean`` are within 1e-6 of the largest magnitude (another sum
order); rounds within atol 1e-5. Against the reference (un-jitted, as the
parity tests run it, R1): the same programs without a mesh, at those
tolerances, and the fused int8 reduce within one quantization step of its
256-wide row plus 1e-6.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_checks as checks  # noqa: E402
from repro import compression as jcomp  # noqa: E402
from repro import core as jdrjax  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402

WORLDS = (2, 4, 8)
CHECKS = ("sharded_over_data", "ns_ablation", "decoupled",
          "post_reduce_replicated", "nested", "flat_hier", "map_local",
          "grads", "stage_transfer", "pipeline_on_stages", "fused_int8",
          "compile_plan", "round_runs")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _torch_dist.run_worlds({
        w: (w, CHECKS, str(tmp_path_factory.mktemp(f"world{w}")))
        for w in WORLDS})


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    tol = rel * max(float(np.max(np.abs(b))) if b.size else 0.0, 1e-30)
    assert float(np.max(np.abs(a - b))) <= tol if a.size else True


def _same_on_every_rank(results):
    first = results[0]
    for other in results[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(first),
                        jax.tree_util.tree_leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ref_program(body, **kw):
    return jdrjax.program(**kw)(body)


@pytest.mark.parametrize("world", WORLDS)
def test_partitioned_value_is_sharded_over_data(worlds, world):
    res = worlds[world]["sharded_over_data"]
    r = res[0]
    assert r["y"] == "(Shard(dim=0),)" and r["z"] == "(Shard(dim=0),)"
    assert r["shape"] == (8, 1024) and r["y_local"] == (8 // world, 1024)
    assert r["out_type"] == "Tensor"
    _same_on_every_rank([x["out"] for x in res])
    ref = _ref_program(lambda x: jdrjax.reduce_sum(jdrjax.map_fn(
        lambda a: a * 2.0, jdrjax.broadcast(x))), partition_size=8)(
        jnp.ones((1024,), jnp.float32))
    _close(r["out"], r["plain"])
    _close(r["out"], np.asarray(ref))
    np.testing.assert_array_equal(r["out"], np.full(1024, 16.0, np.float32))


@pytest.mark.parametrize("world", WORLDS)
def test_ns_ablation_holds_m_times_the_client_copies(worlds, world):
    """Fig. 6: DrJAX-NS holds every group on every rank, m times the
    annotated program's share, with the same result."""
    r = worlds[world]["ns_ablation"][0]
    assert r["numel"]["drjax"]["copies"] == 8 // world
    assert r["numel"]["ns"]["copies"] == 8
    assert r["numel"]["ns"]["numel"] == world * r["numel"]["drjax"]["numel"]
    np.testing.assert_array_equal(r["out"]["ns"], r["plain"])
    _close(r["out"]["drjax"], r["plain"])

    def local_steps(wi):
        for _ in range(2):
            wi = jnp.tanh(wi @ wi)
        return wi

    w = (np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32)
         * 0.2)
    ref = _ref_program(lambda v: jdrjax.reduce_mean(jdrjax.map_fn(
        local_steps, jdrjax.broadcast(v))), partition_size=8)(w)
    _close(r["out"]["drjax"], np.asarray(ref), rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_logical_partition_decoupled_from_rank_count(worlds, world):
    for r in worlds[world]["decoupled"]:
        assert r["out"] == 32 * 4.0
        assert r["groups_run"] == 32 // world


@pytest.mark.parametrize("world", WORLDS)
def test_post_reduce_value_is_replicated(worlds, world):
    res = worlds[world]["post_reduce_replicated"]
    for r in res:
        assert r["replicated"] and r["plain_type"]
    _same_on_every_rank([r["out"] for r in res])
    x = np.random.default_rng(2).standard_normal(1024).astype(np.float32)
    ref = _ref_program(lambda v: jdrjax.reduce_sum(jdrjax.map_fn(
        lambda a: a * 2.0, jdrjax.broadcast(v))), partition_size=8)(x)
    _close(res[0]["out"], np.asarray(ref))


@pytest.mark.parametrize("world", WORLDS)
def test_nested_placements_shard_per_placement(worlds, world):
    r = worlds[world]["nested"][0]
    assert r["axes"] == {"pods": "pod", "clients": "data"}
    assert r["y"] == "(Shard(dim=0), Shard(dim=1))"
    assert r["part"] == "(Shard(dim=0), Replicate())"
    assert r["y_local"] == (1, 1, 64)
    _close(r["out"], r["plain"])
    np.testing.assert_array_equal(r["out"], np.full(64, 2.0, np.float32))


@pytest.mark.parametrize("world", WORLDS)
def test_flat_hierarchical_reduce_under_mesh(worlds, world):
    """P = 2 pod partials: the derived pods level keeps "data" only where
    2 shards over the ranks; the value and the gradient either way."""
    r = worlds[world]["flat_hier"][0]
    n = 2 * world

    def f(xs):
        z = jdrjax.map_fn(lambda a: a * 2.0, xs)
        return jdrjax.hierarchical_reduce_mean(z, num_supergroups=2)

    prog = _ref_program(f, partition_size=n)
    xs = np.arange(n, dtype=np.float32)
    _close(r["out"], r["plain"])
    _close(r["out"], np.asarray(prog(xs)))
    g = jax.grad(lambda v: prog(jnp.broadcast_to(v, (n,))))(jnp.float32(1.0))
    assert abs(r["grad"] - float(g)) <= 1e-6 and abs(r["grad"] - 2.0) < 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_map_fn_runs_each_ranks_own_groups(worlds, world):
    """With spmd_axis_name each rank runs its 8 / m groups and keeps them
    local; without it every rank runs all 8 and keeps its own outputs."""
    r = worlds[world]["map_local"][0]
    assert r[True]["groups"] == 8 // world and r[False]["groups"] == 8
    for spmd in (True, False):
        assert r[spmd]["shape"] == (64,)
        assert r[spmd]["local"] == (8 // world, 64)
        assert r[spmd]["placements"] == "(Shard(dim=0),)"
    np.testing.assert_array_equal(r[True]["z"], r[False]["z"])
    x = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    ref = _ref_program(lambda v: jdrjax.map_fn(
        lambda a: jnp.sin(a) * 2.0, jdrjax.broadcast(v)), partition_size=8)(x)
    _close(r[True]["z"], np.asarray(ref), rel=1e-6)


@functools.lru_cache(maxsize=None)
def _ref_grad(name):
    """The reference's loss and gradient (world-independent inputs)."""
    red = {"sum": jdrjax.reduce_sum, "mean": jdrjax.reduce_mean,
           "max": jdrjax.reduce_max}[name]
    loss = _ref_program(lambda v, e: (red(jdrjax.map_fn(
        lambda a, b: jnp.sin(a * b) * a,
        (jdrjax.broadcast(v), e))) ** 2).sum(), partition_size=8)
    return jax.value_and_grad(loss)(*checks._grad_inputs())


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_through_broadcast_and_reduce(worlds, world):
    """broadcast <-> reduce_sum on the mesh: the gradient of a sharded round
    within the reduce tolerance of the mesh-free one and the reference's."""
    res = worlds[world]["grads"]
    _same_on_every_rank([r["mesh"] for r in res])
    for name in ("sum", "mean", "max"):
        val, grad = _ref_grad(name)
        (mv, mg), (pv, pg) = res[0]["mesh"][name], res[0]["plain"][name]
        _close(mv, pv)
        _close(mg, pg)
        _close(mv, np.asarray(val), rel=1e-5)
        _close(mg, np.asarray(grad), rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_stage_transfer_on_a_stage_dim(worlds, world):
    """stage_transfer (shift 1, and -2 with wrap), stage_map (per-stage and
    one function) and the reverse transfer's gradient: bitwise the
    mesh-free run, -0.0 included."""
    r = worlds[world]["stage_transfer"][0]
    for a, b in zip(r["mesh"], r["plain"]):
        np.testing.assert_array_equal(a, b)
        assert (np.signbit(a) == np.signbit(b)).all()
    x = np.random.default_rng(5).standard_normal((8, 3)).astype(np.float32)
    x[0, 0] = -0.0

    @jdrjax.program(placements={"stages": 8},
                    placement_kinds={"stages": "stages"})
    def f(v):
        return (jdrjax.stage_transfer(v, shift=1),
                jdrjax.stage_transfer(v, shift=-2, wrap=True))

    a, b = f(x)
    np.testing.assert_array_equal(r["mesh"][0], np.asarray(a))
    np.testing.assert_array_equal(r["mesh"][1], np.asarray(b))


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_round_on_a_stage_dim(worlds, world):
    """``PipelineConfig(stage_axes="stage", mesh=)``: each rank runs its
    own stages; the outputs and the final buffer bitwise the mesh-free
    round's."""
    r = worlds[world]["pipeline_on_stages"][0]
    for a, b in zip(r["mesh"], r["plain"]):
        np.testing.assert_array_equal(a, b)


def _row_steps(partials: np.ndarray) -> np.ndarray:
    """Each element's int8 quantization step: max |row| / 127 of its
    256-wide row (a leaf's trailing values, flattened and zero-padded)."""
    p = partials.reshape(partials.shape[0], -1)
    n = p.shape[1]
    pad = np.zeros((p.shape[0], -(-n // 256) * 256), np.float32)
    pad[:, :n] = p
    rows = pad.reshape(p.shape[0], -1, 256)
    step = np.abs(rows).max(-1, keepdims=True) / 127.0
    return np.broadcast_to(step, rows.shape).reshape(p.shape[0], -1)[
        :, :n].reshape(partials.shape)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_int8_reduce_bitwise_via_the_exact_gather(worlds, world):
    """The int8-tagged reduce gathers the groups exactly and runs the fused
    kernel on the whole stack: bitwise the mesh-free payload (nested
    {pods, clients} on (pod, data), and flat over "data"); the reference's
    generic composition within one quantization step of the row."""
    res = worlds[world]["fused_int8"]
    _same_on_every_rank([r["mesh"] for r in res])
    r = res[0]
    np.testing.assert_array_equal(r["mesh"]["flat"], r["plain"]["flat"])
    tree = checks._fused_inputs(world)
    ref = _ref_program(lambda t: jdrjax.hierarchical_reduce_mean(
        t, compress_fn=jcomp.int8_roundtrip, use_fused=False),
        placements={"pods": 2, "clients": world})(tree)
    for k in tree:
        got, plain = r["mesh"]["hier"][k], r["plain"]["hier"][k]
        np.testing.assert_array_equal(got, plain)
        assert (np.signbit(got) == np.signbit(plain)).all()
        bound = _row_steps(tree[k].mean(1)).mean(0) + 1e-6
        assert (np.abs(got - np.asarray(ref[k])) <= bound).all()


@pytest.mark.parametrize("world", WORLDS)
def test_compile_plan_on_a_mesh_against_run_plan(worlds, world):
    res = worlds[world]["compile_plan"]
    r = res[0]
    got, want, traces = r["flat"]
    assert traces == 1
    for a, b in zip(got, want):
        _close(a, b)
    f = _ref_program(lambda w, data: (
        w - 0.1 * jdrjax.reduce_mean(jdrjax.map_fn(
            lambda a, d: jnp.tanh(a * d).sum(-1, keepdims=True) * a,
            (jdrjax.broadcast(w), data))),), partition_size=8)
    g = np.random.default_rng(8)
    w = g.standard_normal(5).astype(np.float32)
    data = g.standard_normal((8, 5)).astype(np.float32)
    _close(got[0], np.asarray(f(w, data)[0]), rel=1e-5)
    got, want, traces = r["nested"]
    assert traces == 1
    for a, b in zip(got, want):  # the fused int8 payload: bitwise
        np.testing.assert_array_equal(a, b)
    _same_on_every_rank([x["nested"][0] for x in res])


@functools.lru_cache(maxsize=None)
def _ref_round(n, pods=0):
    p, d = checks._round_inputs(n, pods=pods)

    def loss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    server = jopt.fedavg_momentum(1.0, momentum=0.9)
    cfg = jrounds.LocalSGDConfig(partition_size=n, num_local_steps=2,
                                 num_pods=pods)
    make = (jrounds.make_hierarchical_local_sgd_round if pods
            else jrounds.make_local_sgd_round)
    rnd = make(loss, jopt.sgd(0.05), server, cfg)
    params = {k: jnp.asarray(v) for k, v in p.items()}
    state = server.init(params)
    for _ in range(2):
        params, state, _ = rnd(params, state, d)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_rounds_on_a_mesh(worlds, world):
    """Two local-SGD rounds on the mesh within atol 1e-5 of the mesh-free
    ones (flat over "data" plain, int8 and DrJAX-NS; hierarchical on
    (pod, data) plain and fused int8) and, uncompressed, of the
    reference's rounds; the round returns plain tensors."""
    res = worlds[world]["round_runs"]
    _same_on_every_rank([{str(k): v[0] for k, v in r.items()} for r in res])
    r = res[0]
    for key, (mesh, plain) in r.items():
        assert mesh["plain_types"], key
        for k in plain["params"]:
            np.testing.assert_allclose(mesh["params"][k], plain["params"][k],
                                       rtol=0, atol=1e-5, err_msg=str(key))
        np.testing.assert_allclose(mesh["losses"], plain["losses"],
                                   rtol=1e-6, atol=0)
    ns_mesh, ns_plain = r[("flat", "ns")]
    for k in ns_plain["params"]:  # DrJAX-NS runs the mesh-free arithmetic
        np.testing.assert_array_equal(ns_mesh["params"][k],
                                      ns_plain["params"][k])
    for key, ref in ((("flat", None), _ref_round(2 * world)),
                     (("hier", None), _ref_round(world, pods=2))):
        for k, v in ref.items():
            np.testing.assert_allclose(r[key][0]["params"][k], v, rtol=0,
                                       atol=1e-5)
