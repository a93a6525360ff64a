"""Rank-side checks of the port's distributed layer, run by
``_torch_dist.run_world`` in every rank of a gloo world on the CPU.

Each check is ``check(rank, world, workdir) -> result`` and returns numpy
arrays and plain values: the port's run on a mesh beside its mesh-free
run on the same inputs (made from a seed with numpy, so the parent can
feed the reference the same ones). This module imports torch and the port
only, never JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import compat, optim
from repro_torch import compression as tcomp
from repro_torch import core as drjax
from repro_torch.algorithms import rounds
from repro_torch.core import interpreter as interp
from repro_torch.core import primitives as prims
from repro_torch.core import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import chaos, elastic, executor


def _np(x):
    if sharding.is_dtensor(x):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _tree_np(tree):
    return pytree.tree_map(_np, tree)


def _data_mesh(world):
    return mesh_lib.make_mesh((world,), ("data",), device="cpu")


def _pod_mesh(world):
    return mesh_lib.make_mesh((2, world // 2), mesh_lib.REPLICA_AXES,
                              device="cpu")


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's seven checks
# ---------------------------------------------------------------------------


def sharded_over_data(rank, world, wd):
    """A partitioned value sharded over "data"; the program's result."""
    seen = {}

    def body(x):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a: a * 2.0, y)
        out = drjax.reduce_sum(z)
        if sharding.is_dtensor(y):
            seen.update(y=str(tuple(y.placements)),
                        y_local=tuple(y.to_local().shape),
                        z=str(tuple(z.placements)), shape=tuple(y.shape))
        return out

    x = torch.ones(1024)
    out = drjax.program(partition_size=8, partition_axes="data",
                        mesh=_data_mesh(world))(body)(x)
    plain = drjax.program(partition_size=8)(body)(x)
    return dict(seen, out=_np(out), plain=_np(plain),
                out_type=type(out).__name__)


def ns_ablation(rank, world, wd):
    """DrJAX against DrJAX-NS: a rank's share of the broadcast model
    copies and of the mapped outputs, and the result of each."""
    d = 32
    w = torch.from_numpy(_rng(1).standard_normal((d, d)).astype(np.float32)
                         * 0.2)
    mesh = _data_mesh(world)
    out, numel = {}, {}

    for name, ann in (("drjax", True), ("ns", False)):
        seen = {}

        def body(wt):
            wb = drjax.broadcast(wt)

            def local_steps(wi):
                for _ in range(2):
                    wi = torch.tanh(wi @ wi)
                return wi

            z = drjax.map_fn(local_steps, wb)
            seen["copies"] = (wb.to_local() if sharding.is_dtensor(wb)
                              else wb).shape[0]
            seen["numel"] = (z.to_local() if sharding.is_dtensor(z)
                             else z).numel()
            return drjax.reduce_mean(z)

        out[name] = _np(drjax.program(partition_size=8, partition_axes="data",
                                      mesh=mesh,
                                      use_sharding_annotations=ann)(body)(w))
        numel[name] = dict(seen)
    plain = drjax.program(partition_size=8)(
        lambda wt: drjax.reduce_mean(drjax.map_fn(
            lambda wi: torch.tanh(torch.tanh(wi @ wi) @ torch.tanh(wi @ wi)),
            drjax.broadcast(wt))))(w)
    return dict(out=out, numel=numel, plain=_np(plain))


def decoupled(rank, world, wd):
    """32 logical groups over the ranks."""
    calls = []

    def body(x):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a: calls.append(1) or a ** 2, y)
        return drjax.reduce_sum(z)

    out = drjax.program(partition_size=32, partition_axes="data",
                        mesh=_data_mesh(world))(body)(torch.tensor(2.0))
    return dict(out=float(out), groups_run=len(calls))


def post_reduce_replicated(rank, world, wd):
    """A reduced (server) value is Replicate on every mesh dim inside the
    program, and the same bits on every rank after it."""
    seen = {}

    def body(x):
        z = drjax.map_fn(lambda a: a * 2.0, drjax.broadcast(x))
        out = drjax.reduce_sum(z)
        seen["placements"] = str(tuple(out.placements))
        seen["replicated"] = all(p.is_replicate() for p in out.placements)
        return out

    x = torch.from_numpy(_rng(2).standard_normal(1024).astype(np.float32))
    out = drjax.program(partition_size=8, partition_axes="data",
                        mesh=_data_mesh(world))(body)(x)
    return dict(seen, out=_np(out), plain_type=type(out) is torch.Tensor)


def nested(rank, world, wd):
    """{pods, clients} on a (pod, data) mesh: each level on its own dim."""
    mesh = _pod_mesh(world)
    axes = mesh_lib.placement_axes_for(mesh)
    m = world // 2
    seen = {}

    def body(x):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a: a * 2.0, y)
        part = drjax.reduce_mean(z, placement="clients")
        if sharding.is_dtensor(y):
            seen.update(y=str(tuple(y.placements)),
                        part=str(tuple(part.placements)),
                        y_local=tuple(y.to_local().shape))
        return drjax.reduce_mean(part, placement="pods")

    x = torch.ones(64)
    place = {"pods": 2, "clients": m}
    out = drjax.program(placements=place, partition_axes=axes,
                        mesh=mesh)(body)(x)
    plain = drjax.program(placements=place)(body)(x)
    return dict(seen, axes=axes, out=_np(out), plain=_np(plain))


def flat_hier(rank, world, wd):
    """The flat-API hierarchical_reduce_mean under a mesh (P = 2 pod
    partials), and its gradient."""
    n = 2 * world

    def f(xs):
        z = drjax.map_fn(lambda a: a * 2.0, xs)
        return drjax.hierarchical_reduce_mean(z, num_supergroups=2)

    xs = torch.arange(n, dtype=torch.float32)
    prog = drjax.program(partition_size=n, partition_axes="data",
                         mesh=_data_mesh(world))
    out = prog(f)(xs)
    plain = drjax.program(partition_size=n)(f)(xs)
    v = torch.tensor(1.0, requires_grad=True)
    prog(f)(v.expand(n)).backward()
    return dict(out=_np(out), plain=_np(plain), grad=float(v.grad))


def map_local(rank, world, wd):
    """map_fn's body runs on this rank's groups only (the reference's
    spmd_axis_name); without it every rank runs every group."""
    out = {}
    for spmd in (True, False):
        seen = []

        def body(x):
            return drjax.map_fn(
                lambda a: seen.append(tuple(a.shape)) or torch.sin(a) * 2.0,
                drjax.broadcast(x))

        x = torch.from_numpy(_rng(3).standard_normal(64).astype(np.float32))
        z = drjax.program(partition_size=8, partition_axes="data",
                          mesh=_data_mesh(world),
                          use_spmd_axis_name=spmd)(body)(x)
        out[spmd] = dict(groups=len(seen), shape=seen[0],
                         placements=str(tuple(z.placements)),
                         local=tuple(z.to_local().shape), z=_np(z))
    return out


# ---------------------------------------------------------------------------
# gradients, transfers, the fused int8 reduce, compiled plans, rounds
# ---------------------------------------------------------------------------


def _grad_inputs():
    g = _rng(4)
    return (g.standard_normal(16).astype(np.float32),
            g.standard_normal((8, 16)).astype(np.float32))


def grad_programs(mesh=None):
    """Three losses through broadcast, a map and reduce_sum / reduce_mean /
    reduce_max; returns {name: (loss, grad)}."""
    w_np, d_np = _grad_inputs()
    kw = dict(partition_axes="data", mesh=mesh) if mesh is not None else {}
    out = {}
    for name, red in (("sum", drjax.reduce_sum), ("mean", drjax.reduce_mean),
                      ("max", drjax.reduce_max)):
        @drjax.program(partition_size=8, **kw)
        def loss(w, d):
            z = drjax.map_fn(lambda a, b: torch.sin(a * b) * a,
                             (drjax.broadcast(w), d))
            return (red(z) ** 2).sum()

        w = torch.from_numpy(w_np).requires_grad_(True)
        val = loss(w, torch.from_numpy(d_np))
        val.backward()
        out[name] = (_np(val), _np(w.grad))
    return out


def grads(rank, world, wd):
    return dict(mesh=grad_programs(_data_mesh(world)), plain=grad_programs())


def _stage_program(mesh=None):
    kw = (dict(partition_axes={"stages": "stage"}, mesh=mesh)
          if mesh is not None else {})
    x_np = _rng(5).standard_normal((8, 3)).astype(np.float32)
    x_np[0, 0] = -0.0

    @drjax.program(placements={"stages": 8},
                   placement_kinds={"stages": "stages"}, **kw)
    def f(x):
        a = drjax.stage_transfer(x, shift=1)
        b = drjax.stage_transfer(x, shift=-2, wrap=True)
        c = drjax.stage_map([lambda v, s=s: v * (s + 1.0) for s in range(8)],
                            x)
        d = drjax.stage_map(lambda v: torch.cos(v), a)
        return a, b, c, d

    x = torch.from_numpy(x_np).requires_grad_(True)
    outs = f(x)
    # On a mesh each rank sums its own stages; the gradient of the whole
    # input (on every rank) is that of the sum over all of them.
    sum(o.to_local().sum() if sharding.is_dtensor(o) else o.sum()
        for o in (outs[0], outs[3])).backward()
    return [_np(o) for o in outs] + [_np(x.grad)]


def stage_transfer(rank, world, wd):
    mesh = mesh_lib.make_mesh((world,), ("stage",), device="cpu")
    return dict(mesh=_stage_program(mesh), plain=_stage_program())


def _pipeline_run(mesh=None):
    from repro_torch.algorithms import pipeline

    kw = dict(stage_axes="stage", mesh=mesh) if mesh is not None else {}
    fns = [lambda a, s=s: torch.tanh(a * (s + 1.0)) for s in range(8)]
    mb = torch.from_numpy(_rng(12).standard_normal((3, 5)).astype(np.float32))
    rnd = pipeline.make_pipelined_round(
        fns, pipeline.PipelineConfig(8, 3, **kw), device="cpu")
    outs, act = rnd(mb, torch.zeros(8, 5))
    return [_np(outs), _np(act)]


def pipeline_on_stages(rank, world, wd):
    """The pipelined round (8 stages, 3 microbatches) with its stages over
    a "stage" mesh dim, beside the mesh-free round."""
    mesh = mesh_lib.make_mesh((world,), ("stage",), device="cpu")
    return dict(mesh=_pipeline_run(mesh), plain=_pipeline_run())


def _fused_inputs(world):
    g = _rng(6)
    m = world
    tree = {"a": g.standard_normal((2, m, 3, 300)).astype(np.float32),
            "b": g.standard_normal((2, m, 700)).astype(np.float32)}
    tree["a"][0, 0, 0, :5] = -0.0
    return tree


def _fused_program(world, mesh=None):
    kw = (dict(partition_axes=mesh_lib.placement_axes_for(mesh), mesh=mesh)
          if mesh is not None else {})
    tree = {k: torch.from_numpy(v) for k, v in _fused_inputs(world).items()}

    @drjax.program(placements={"pods": 2, "clients": world}, **kw)
    def f(t):
        return drjax.hierarchical_reduce_mean(t,
                                              compress_fn=tcomp.int8_roundtrip)

    buf = torch.from_numpy(_rng(7).standard_normal(
        (2 * world, 4, 256)).astype(np.float32))
    kw1 = dict(partition_axes="data", mesh=_data_mesh(world)) if mesh else {}
    g = drjax.program(partition_size=2 * world, **kw1)(
        lambda b: prims.reduce_mean(b, compress="int8"))
    return dict(hier=_tree_np(f(tree)), flat=_np(g(buf)))


def fused_int8(rank, world, wd):
    return dict(mesh=_fused_program(world, _pod_mesh(world)),
                plain=_fused_program(world))


def _plan_program():
    @drjax.program(partition_size=8)
    def f(w, data):
        wb = drjax.broadcast(w)
        z = drjax.map_fn(
            lambda a, d: torch.tanh(a * d).sum(-1, keepdim=True) * a,
            (wb, data))
        return w - 0.1 * drjax.reduce_mean(z), drjax.reduce_sum(z)

    g = _rng(8)
    w = torch.from_numpy(g.standard_normal(5).astype(np.float32))
    data = torch.from_numpy(g.standard_normal((8, 5)).astype(np.float32))
    return f, (w, data)


def _nested_plan_program(world):
    @drjax.program(placements={"pods": 2, "clients": world})
    def f(x, t):
        z = drjax.map_fn(lambda a, b: {"a": b["a"] * a, "b": b["b"] + a},
                         (drjax.broadcast(x), t))
        return drjax.hierarchical_reduce_mean(z,
                                              compress_fn=tcomp.int8_roundtrip)

    tree = {k: torch.from_numpy(v) for k, v in _fused_inputs(world).items()}
    return f, (torch.tensor(1.5), tree)


def compile_plan(rank, world, wd):
    """``compile_plan(mesh=)`` against ``run_plan`` of the same plan: a
    flat round-like program over "data", and a nested fused-int8 one on
    the (pod, data) mesh."""
    out = {}
    f, args = _plan_program()
    plan = interp.build_plan(interp.trace(f, *args), 8,
                             partitioned_invars=[0, 1])
    compiled = executor.compile_plan(plan, device="cpu", mesh=_data_mesh(world),
                                     placement_axes={"clients": "data"})
    out["flat"] = ([_np(o) for o in compiled(*args)],
                   [_np(o) for o in interp.run_plan(plan, *args)],
                   compiled.trace_count)
    f, args = _nested_plan_program(world)
    flat_args = pytree.tree_leaves(args)
    plan = interp.build_plan(interp.trace(f, *args),
                             {"pods": 2, "clients": world},
                             partitioned_invars=[0, 2, 2])
    mesh = _pod_mesh(world)
    compiled = executor.compile_plan(
        plan, device="cpu", mesh=mesh,
        placement_axes=mesh_lib.placement_axes_for(mesh))
    out["nested"] = ([_np(o) for o in compiled(*flat_args)],
                     [_np(o) for o in interp.run_plan(plan, *flat_args)],
                     compiled.trace_count)
    return out


def _round_inputs(n, steps=2, dim=3, pods=0):
    g = _rng(9)
    lead = (pods, n) if pods else (n,)
    params = {"w": g.standard_normal(dim).astype(np.float32),
              "b": np.float32(0.0)}
    data = {"x": g.standard_normal(lead + (steps, 8, dim)).astype(np.float32),
            "y": g.standard_normal(lead + (steps, 8)).astype(np.float32)}
    return params, data


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _run_round(n, mesh=None, axes=None, pods=0, compression=None, ann=True):
    p_np, d_np = _round_inputs(n, pods=pods)
    params = {k: torch.as_tensor(v) for k, v in p_np.items()}
    data = {k: torch.from_numpy(v) for k, v in d_np.items()}
    cfg = rounds.LocalSGDConfig(partition_size=n, num_local_steps=2,
                                num_pods=pods, compression=compression,
                                partition_axes=axes, mesh=mesh,
                                use_sharding_annotations=ann)
    server = optim.fedavg_momentum(1.0, momentum=0.9)
    make = (rounds.make_hierarchical_local_sgd_round if pods
            else rounds.make_local_sgd_round)
    rnd = make(_loss, optim.sgd(0.05), server, cfg)
    state = server.init(params)
    losses = []
    for _ in range(2):
        params, state, m = rnd(params, state, data)
        losses.append(float(m["loss"]))
    return dict(params=_tree_np(params), losses=losses,
                plain_types=all(type(v) is torch.Tensor
                                for v in pytree.tree_leaves(params)))


def round_runs(rank, world, wd):
    """Two rounds of local SGD on a mesh beside the mesh-free ones: flat
    (plain and int8, and DrJAX-NS) over "data", hierarchical (plain and
    fused int8) on the (pod, data) mesh."""
    n = 2 * world
    out = {}
    for comp in (None, "int8"):
        out[("flat", comp)] = (_run_round(n, _data_mesh(world), "data",
                                          compression=comp),
                               _run_round(n, compression=comp))
    out[("flat", "ns")] = (_run_round(n, _data_mesh(world), "data",
                                      ann=False), _run_round(n))
    mesh = _pod_mesh(world)
    for comp in (None, "int8"):
        out[("hier", comp)] = (
            _run_round(world, mesh, mesh_lib.REPLICA_AXES, pods=2,
                       compression=comp),
            _run_round(world, pods=2, compression=comp))
    return out


# ---------------------------------------------------------------------------
# meshes (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def mesh_builds(rank, world, wd):
    """The meshes of mesh_for_placements, mesh_for_surviving_pods (every
    rank builds each, inside it or not) and available_mesh_shapes."""
    out = {}
    m = mesh_lib.mesh_for_placements({"pods": 2, "clients": world // 2},
                                     device="cpu")
    out["placements"] = (compat.mesh_axis_names(m), compat.mesh_shape(m),
                         compat.mesh_ranks(m), m.get_coordinate())
    m = mesh_lib.mesh_for_placements({"clients": world}, device="cpu")
    out["flat"] = (compat.mesh_axis_names(m), compat.mesh_shape(m),
                   m.get_coordinate())
    pool = elastic.pod_device_pool(2, world // 2)
    out["pool"] = pool.tolist()
    for alive in ((0, 1), (1,), (0,)):
        m = elastic.mesh_for_surviving_pods(pool, alive, device="cpu")
        coord = m.get_coordinate()
        total = torch.tensor([float(rank)])
        if coord is not None:  # a collective over the degraded mesh
            for d in range(2):
                torch.distributed.all_reduce(total, group=m.get_group(d))
        out[alive] = (compat.mesh_axis_names(m), compat.mesh_shape(m),
                      compat.mesh_ranks(m), coord, float(total))
    shapes = {}
    for n in (world, world // 2):
        for shape, axes in elastic.available_mesh_shapes(
                n, placements={"pods": 2, "clients": world // 2}):
            m = mesh_lib.make_mesh(shape, axes, device="cpu")
            shapes[n] = (shape, axes, compat.mesh_axis_names(m),
                         compat.mesh_shape(m), m.get_coordinate())
    out["available"] = shapes
    host = mesh_lib.make_host_mesh(device="cpu")
    out["host"] = (compat.mesh_axis_names(host), compat.mesh_shape(host))
    return out


# ---------------------------------------------------------------------------
# the elastic round (tests/test_torch_elastic.py)
# ---------------------------------------------------------------------------


def _elastic_inputs(pods, clients, r):
    g = np.random.default_rng([11, r])
    x = g.standard_normal((pods, clients, 2, 8, 3)).astype(np.float32)
    y = g.standard_normal((pods, clients, 2, 8)).astype(np.float32)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _elastic_run(mesh_for, schedule, clients):
    server = optim.fedavg_momentum(1.0, momentum=0.9)
    cfg = rounds.LocalSGDConfig(partition_size=clients, num_local_steps=2)
    rnd = elastic.make_elastic_hierarchical_round(
        _loss, optim.sgd(0.05), server, cfg, device="cpu")
    params = {"w": torch.tensor([0.5, -0.25, 1.0]), "b": torch.tensor(0.0)}
    state = server.init(params)
    losses = []
    for r, alive in enumerate(schedule):
        data = _elastic_inputs(len(alive), clients, r)
        out = rnd.step(params, state, data, mesh=mesh_for(alive))
        if out is not None:
            params, state, metrics = out
            losses.append(float(metrics["loss"]))
        else:
            losses.append(None)
    return dict(params=_tree_np(params), losses=losses,
                client_traces=rnd.client_trace_count,
                cross=rnd.cross_compile_count, meshes=rnd.meshes_seen,
                reshards=rnd.reshard_count, migrate_ms=rnd.mesh_migrate_ms)


def elastic_steps(rank, world, wd):
    """step(mesh=) over 3 -> 2 -> 3 pods of 2 clients (pod 1 drops and
    comes back), twice on the same meshes, beside the logical steps."""
    clients = 2
    pool = elastic.pod_device_pool(world // clients, clients)
    schedule = [(0, 1, 2), (0, 1, 2), (0, 2), (0, 2), (0, 1, 2)]
    cache = {}

    def mesh_for(alive):
        if alive not in cache:
            cache[alive] = elastic.mesh_for_surviving_pods(pool, alive,
                                                           device="cpu")
        return cache[alive]

    first = _elastic_run(mesh_for, schedule, clients)
    again = _elastic_run(mesh_for, schedule, clients)
    logical = _elastic_run(lambda alive: None, schedule, clients)
    return dict(first=first, again=again, logical=logical)


# ---------------------------------------------------------------------------
# the chaos soak (tests/test_torch_chaos.py)
# ---------------------------------------------------------------------------

#: The reference's acceptance config (tests/test_chaos.py:194-201).
SOAK = dict(rounds=20, seed=1, num_pods=4, clients_per_pod=2,
            num_device_failures=1, num_elastic_events=2, num_ckpt_faults=1,
            checkpoint_every=4, audit_every=8, serve_traffic=False)


def physical_soak(rank, world, wd):
    rep = chaos.run_chaos_soak(chaos.ChaosConfig(
        **SOAK, physical_mesh=True, device="cpu",
        ckpt_dir=os.path.join(wd, "ckpt")))
    logical = chaos.run_chaos_soak(chaos.ChaosConfig(
        **SOAK, device="cpu", ckpt_dir=os.path.join(wd, f"logical_{rank}")))
    return dict(report=rep.to_json(), logical=logical.to_json())
