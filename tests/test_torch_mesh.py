"""The port's meshes (``launch/mesh.py``, ``compat``'s mesh helpers,
``runtime/elastic.py``'s mesh helpers) against the reference's
(``repro/launch/mesh.py``, ``repro/runtime/elastic.py``).

* The pure functions equal the reference's: ``level_axes_for``,
  ``placement_axes_for`` and ``partition_axes_for`` (on a small stand-in
  that carries both packages' mesh attributes: they read only the axis
  names and the shape), ``partition_spec``'s entries, the placement
  context's per-level axes, ``available_mesh_shapes``, ``_hier_axes``,
  ``_axes_if_divisible``'s decisions, the production meshes' shapes and
  axes (as data: they need 256 or 512 ranks), ``pod_device_pool``'s layout
  and ``mesh_for_surviving_pods``' rank layout.
* A world of 4 gloo ranks builds the meshes of ``mesh_for_placements``,
  ``mesh_for_surviving_pods`` (every rank builds each, in it or not, and
  runs a collective on it if in it) and ``available_mesh_shapes``.
* The port's ``mesh-axes-literal`` lint rule catches a broken fixture.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.core import hierarchical as jhier  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.analysis.lints import run_lints  # noqa: E402
from repro_torch.core import hierarchical, placement, sharding  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

STACKS = [
    {"clients": 8},
    {"pods": 2, "clients": 4},
    {"superpods": 2, "pods": 2, "clients": 2},
    {"a": 1, "b": 2, "c": 3, "d": 4},
    (("stages", 4, "stages"), ("clients", 2)),
    (("clients", 2), ("s1", 2, "stages"), ("s2", 3, "stages")),
    (("pods", 2), ("stages", 4, "stages"), ("clients", 2)),
]


def _standin(shape, names):
    """A mesh as both packages' helpers read it: the reference's
    ``axis_names`` and ``devices.shape``, the port's ``mesh_dim_names`` and
    ``mesh`` of ranks."""
    return types.SimpleNamespace(
        axis_names=tuple(names), devices=np.empty(shape, dtype=object),
        mesh_dim_names=tuple(names),
        mesh=torch.arange(int(np.prod(shape))).reshape(shape))


MESHES = [((8,), ("data",)), ((2, 4), ("pod", "data")),
          ((2, 2, 2), ("superpod", "pod", "data")),
          ((4, 2), ("data", "model")), ((2, 4), ("stage", "data")),
          ((1, 2), ("pod", "data")), ((4,), ("model",))]


@pytest.mark.parametrize("stack", STACKS, ids=str)
def test_level_axes_for_matches_reference(stack):
    assert mesh.level_axes_for(stack) == jmesh.level_axes_for(stack)
    assert mesh._normalize_stack(stack) == jmesh._normalize_stack(stack)


@pytest.mark.parametrize("shape,names", MESHES, ids=str)
def test_axes_for_a_mesh_match_reference(shape, names):
    m = _standin(shape, names)
    assert mesh.partition_axes_for(m) == jmesh.partition_axes_for(m)
    assert mesh.placement_axes_for(m) == jmesh.placement_axes_for(m)
    for stack in STACKS:
        assert (mesh.placement_axes_for(m, stack)
                == jmesh.placement_axes_for(m, stack))
    assert mesh.partition_axes_for(None) is jmesh.partition_axes_for(None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_spec_matches_reference(monkeypatch, multi_pod):
    monkeypatch.setattr(jmesh.compat, "make_mesh",
                        lambda shape, axes, **kw: (tuple(shape), tuple(axes)))
    assert (mesh.production_mesh_spec(multi_pod=multi_pod)
            == jmesh.make_production_mesh(multi_pod=multi_pod))
    assert mesh.REPLICA_AXES == jmesh.REPLICA_AXES


CONTEXTS = [
    dict(partition_size=8, partition_axes="data"),
    dict(partition_size=8, partition_axes=("pod", "data")),
    dict(placements={"pods": 2, "clients": 4},
         partition_axes={"pods": "pod", "clients": "data"}),
    dict(placements={"pods": 2, "clients": 4},
         partition_axes={"clients": ("pod", "data")}),
    dict(placements={"pods": 2, "clients": 4}),
    dict(placements={"stages": 4, "clients": 2},
         partition_axes={"stages": "stage"},
         placement_kinds={"stages": "stages"}),
]


@pytest.mark.parametrize("kw", CONTEXTS, ids=str)
def test_context_axes_and_partition_spec_match_reference(kw):
    t, j = placement.make_context(**kw), jplacement.make_context(**kw)
    assert [p.axes_tuple() for p in t.placements] == [
        p.axes_tuple() for p in j.placements]
    assert t.partition_axes == j.partition_axes
    for depth in range(t.depth + 1):
        for ndim in (depth, depth + 2):
            spec = jsharding.partition_spec(j, ndim, depth)
            want = None if spec is None else tuple(spec)[:min(depth, ndim)]
            assert sharding.partition_spec(t, ndim, depth) == want
    for name in t.names:
        assert t.spmd_axis_name_for(name) == j.spmd_axis_name_for(name)
    off = placement.make_context(**kw, use_sharding_annotations=False)
    assert all(off.spmd_axis_name_for(n) is None for n in off.names)


def test_make_context_refuses_what_the_reference_refuses():
    for bad in (dict(placements={"pods": 2, "clients": 4},
                     partition_axes="data"),
                dict(partition_size=4, partition_axes={"nope": "data"})):
        with pytest.raises(ValueError):
            jplacement.make_context(**bad)
        with pytest.raises(ValueError):
            placement.make_context(**bad)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_available_mesh_shapes_match_reference(n):
    for mp in (1, 2, 4, 8):
        assert (elastic.available_mesh_shapes(n, mp)
                == jelastic.available_mesh_shapes(n, mp))
        for stack in STACKS[:4]:
            assert (elastic.available_mesh_shapes(n, mp, placements=stack)
                    == jelastic.available_mesh_shapes(n, mp,
                                                      placements=stack))


@pytest.mark.parametrize("axes", [None, "data", ("data",), ("pod", "data"),
                                  ("superpod", "pod", "data"),
                                  {"pods": "pod", "clients": "data"}],
                         ids=str)
def test_hier_axes_match_reference(axes):
    t = rounds.LocalSGDConfig(partition_size=4, partition_axes=axes)
    j = jrounds.LocalSGDConfig(partition_size=4, partition_axes=axes)
    assert rounds._hier_axes(t) == jrounds._hier_axes(j)


@pytest.mark.parametrize("shape,names", MESHES[:4], ids=str)
def test_axes_if_divisible_decides_as_reference(shape, names):
    m = _standin(shape, names)
    for axes in (None, (), "data", "pod", ("pod", "data"), "missing"):
        for groups in (1, 2, 3, 4, 8, 16):
            assert (hierarchical._axes_if_divisible(axes, groups, m)
                    == jhier._axes_if_divisible(axes, groups, m))
            assert (hierarchical._axes_if_divisible(axes, groups, None)
                    == jhier._axes_if_divisible(axes, groups, None))


@pytest.mark.parametrize("pods,clients", [(4, 2), (3, 2), (2, 1), (1, 4)])
def test_pod_pool_and_surviving_rows_match_reference(pods, clients):
    ranks = list(range(pods * clients))
    pool = elastic.pod_device_pool(pods, clients, devices=ranks)
    jpool = jelastic.pod_device_pool(pods, clients, devices=ranks)
    np.testing.assert_array_equal(pool, jpool.astype(np.int64))
    with pytest.raises(ValueError):
        elastic.pod_device_pool(pods + 1, clients, devices=ranks)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _torch_dist.run_world(4, ["mesh_builds"],
                                 str(tmp_path_factory.mktemp("mesh4")))


def test_meshes_built_on_four_ranks(world4):
    res = world4["mesh_builds"]
    pool = np.arange(4).reshape(2, 2)
    for rank, r in enumerate(res):
        coord = (rank // 2, rank % 2)
        assert r["placements"] == (("pod", "data"), (2, 2), (0, 1, 2, 3),
                                   coord)
        assert r["flat"] == (("data",), (4,), (rank,))
        assert r["pool"] == pool.tolist()
        assert r["host"] == (("data", "model"), (4, 1))
        for alive in ((0, 1), (1,), (0,)):
            names, shape, ranks, c, total = r[alive]
            want = pool[list(alive)].reshape(-1)
            assert names == ("pod", "data") and shape == (len(alive), 2)
            assert ranks == tuple(want)  # the pool's [alive] rows
            if rank in want:
                pos = list(want).index(rank)
                assert c == (pos // 2, pos % 2)
                assert total == float(want.sum())  # a collective on it
            else:
                assert c is None
        for n, (shape, axes, names, mshape, c) in r["available"].items():
            assert (shape, axes) == jelastic.available_mesh_shapes(
                n, placements={"pods": 2, "clients": 2})[-1]
            assert names == axes and mshape == shape
            assert (c is None) == (rank >= n)


def test_mesh_axes_literal_rule_catches_a_broken_fixture(tmp_path):
    root = str(tmp_path)
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "launch").mkdir(parents=True)
    (pkg / "bad.py").write_text(
        "AXES = ('pod', 'data')\n"
        "OK = ('pod',)\n"
        "ALSO = ['stage', 'model']  # lint: disable=mesh-axes-literal\n"
        "MIXED = ('pod', 'clients')\n")
    (pkg / "launch" / "mesh.py").write_text("HOME = ('pod', 'data')\n")
    vs = run_lints(root=root, rules=["mesh-axes-literal"])
    assert [(v.path, v.line) for v in vs] == [("src/repro_torch/bad.py", 1)]
    assert run_lints(rules=["mesh-axes-literal"]) == []


@pytest.mark.parametrize("name", ["scan", "while_body", "cond_true"])
def test_compile_plan_on_a_mesh_refuses_control_stages(name):
    """A plan with a loop or a cond runs on one rank's whole groups: on a
    mesh it is refused at compile time, before anything runs."""
    from _torch_programs import both, tplan

    from repro_torch.runtime import executor

    *_, tfn, targs, place = both(name)
    plan = tplan(tfn, place, *targs)
    with pytest.raises(ValueError, match="loop or a cond"):
        executor.compile_plan(plan, device="cpu",
                              mesh=_standin((2,), ("data",)))
    executor.compile_plan(plan, device="cpu")  # without a mesh it compiles
