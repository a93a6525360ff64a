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


# ---------------------------------------------------------------------------
# the model-parallel layer (tests/test_torch_tpcomm.py,
# tests/test_torch_steps_mesh.py)
# ---------------------------------------------------------------------------


def _model_mesh(world, data=1):
    return mesh_lib.make_mesh((data, world // data), ("data", "model"),
                              device="cpu")


def tpcomm_inputs(world, t=12, f_per=16, d=24, seed=3):
    """x (T, m * f_per) and w (m * f_per, d) f32, with all-zero and huge
    rows in x."""
    rng = _rng(seed)
    x = rng.standard_normal((t, world * f_per)).astype(np.float32)
    x[0] = 0.0
    x[1] *= np.float32(3e30)
    w = rng.standard_normal((world * f_per, d)).astype(np.float32)
    return x, w


def tpcomm_reduce(rank, world, wd):
    """``int8_matmul_reduce`` on a (data 1, model m) mesh: each rank holds
    its f columns of x and rows of w."""
    from repro_torch.models import partitioning, tpcomm

    mesh = _model_mesh(world)
    x, w = tpcomm_inputs(world)
    f = x.shape[1] // world
    xs = torch.from_numpy(x[:, rank * f:(rank + 1) * f].copy())
    ws = torch.from_numpy(w[rank * f:(rank + 1) * f].copy())
    partitioning.reset_routes()
    with partitioning.axis_rules(mesh):
        out = tpcomm.int8_matmul_reduce(xs, ws, out_dtype=torch.float32)
        routes = dict(partitioning.ROUTES)
        # the exact all_reduce gather, the route of CUDA tensors on gloo
        route = partitioning.gather_route
        partitioning.gather_route = lambda t, d, mesh=None: "all_reduce"
        try:
            partitioning.reset_routes()
            by_reduce = tpcomm.int8_matmul_reduce(xs, ws,
                                                  out_dtype=torch.float32)
        finally:
            partitioning.gather_route = route
    return dict(out=_np(out), routes=routes, rows=x.shape[0], d=w.shape[1],
                by_reduce=_np(by_reduce),
                reduce_routes=dict(partitioning.ROUTES))


def _f32(arch, **over):
    from repro_torch.models import registry

    base = dict(d_model=64, num_heads=4, head_dim=16, vocab_size=512,
                dtype="float32", attn_impl="blocked", q_block=8, kv_block=8)
    base.update(over)
    return registry.get_config(arch).reduced(**base)


# the train-step cases: the reference's launch tests' archs at their
# reduced widths (f32), two with 16 heads so the heads split over "model"
# (kv heads split, and kv heads computed whole), and the encoder-decoder
MESH_TRAIN = {
    "stablelm_3b": dict(arch="stablelm_3b"),
    "phi35_moe": dict(arch="phi35_moe"),
    "rwkv6_3b": dict(arch="rwkv6_3b"),
    "lm_1b_heads": dict(arch="lm_1b", num_heads=16, num_kv_heads=16,
                        head_dim=8),
    "qwen2_gqa": dict(arch="qwen2_72b", num_heads=16, num_kv_heads=2,
                      head_dim=8, d_ff=128),
    # the tp rules on a model the port computes whole: its split leaves
    # are gathered for the compute
    "seamless_tp": dict(arch="seamless_m4t_medium", mesh_strategy="tp"),
}


def vocab_loss(rank, world, wd):
    """The vocabulary-parallel loss (``transformer.
    vocab_parallel_cross_entropy``) on the (data 2, model 2) mesh: each
    rank of "model" holds its columns of the same seeded logits (f32,
    V = 2 x 96, half the tokens masked); the loss and the gradient of the
    rank's columns, beside ``common.softmax_cross_entropy`` of the whole
    logits."""
    from repro_torch.models import common, partitioning, transformer

    mesh = _model_mesh(world, data=2)
    rng = _rng(11)
    whole = torch.from_numpy(
        (4.0 * rng.standard_normal((3, 5, 192))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 192, (3, 5)))
    mask = torch.from_numpy((rng.random((3, 5)) < 0.5).astype(np.float32))
    out = {}
    with partitioning.axis_rules(mesh):
        v = 192 // partitioning.model_size()
        lo = partitioning.model_index() * v
        for name, m in (("plain", None), ("masked", mask)):
            want_in = whole.clone().requires_grad_(True)
            want = common.softmax_cross_entropy(want_in, labels, m)
            want.backward()
            got_in = whole[..., lo:lo + v].clone().requires_grad_(True)
            got = transformer.vocab_parallel_cross_entropy(got_in, labels, m)
            got.backward()
            out[name] = dict(loss=float(got), want=float(want),
                             grad=_np(got_in.grad),
                             want_grad=_np(want_in.grad[..., lo:lo + v]))
    return out


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone(), tree)


def steps_train(rank, world, wd):
    """Two SGD train steps of each :data:`MESH_TRAIN` case on a (data 2,
    model 2) mesh (whole inputs, then the DTensors the first returned)
    beside the mesh-free steps; one AdamW step of ``lm_1b_heads``."""
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    mesh = _model_mesh(world, data=2)
    out = {}
    for name, spec in MESH_TRAIN.items():
        spec = dict(spec)
        cfg = _f32(spec.pop("arch"), **spec)
        params = registry.init_params(cfg, seed=0, device="cpu")
        # 8 x 128 tokens: the MoE's routing groups of 512 tokens hold
        # whole rank shards of the batch
        seq = 128 if cfg.family == "moe" else 16
        batches = [registry.make_batch(cfg, 8, seq, seed=s, device="cpu")
                   for s in (1, 2)]
        plain, _ = steps.make_sgd_train_step(cfg, None, optimizer="sgd",
                                             lr=0.1)
        meshed, shardings_for = steps.make_sgd_train_step(
            cfg, mesh, optimizer="sgd", lr=0.1)
        opt = optim.sgd(0.1)
        pp, po = _clone(params), opt.init(params)
        mp, mo = _clone(params), opt.init(params)
        res = {"loss": [], "mesh_loss": []}
        partitioning.reset_routes()
        for b in batches:
            pp, po, pl = plain(pp, po, b)
            mp, mo, ml = meshed(mp, mo, b)
            res["loss"].append(float(pl))
            res["mesh_loss"].append(float(ml))
        res["routes"] = dict(partitioning.ROUTES)
        res["dtensor"] = all(sharding.is_dtensor(v) for v in mp.values())
        res["params"] = _tree_np(pp)
        res["mesh_params"] = {k: _np(partitioning.full(v))
                              for k, v in mp.items()}
        specs = steps.train_input_specs(cfg, 8, 16, optimizer="sgd")
        (p_sh, _, b_sh), _ = shardings_for(specs)
        res["placements"] = {k: str(v) for k, v in p_sh.items()}
        res["local_shapes"] = {k: tuple(v.to_local().shape)
                               for k, v in mp.items()}
        out[name] = res
    return out


def steps_round(rank, world, wd):
    """The DrJAX round step of reduced lm_350m (dp) on the (data 2, model
    2) mesh beside the mesh-free round, with every all_reduce's group."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import registry

    mesh = _model_mesh(world, data=2)
    cfg = _f32("lm_350m")
    params = registry.init_params(cfg, seed=0, device="cpu")
    data = registry.make_batch(cfg, 2, 16, seed=5, lead=(4, 2), device="cpu")
    plain, *_ = steps.make_drjax_round_step(cfg, None, partition_size=4,
                                            num_local_steps=2)
    meshed, param_sh, server_sh, data_sh = steps.make_drjax_round_step(
        cfg, mesh, partition_size=4, num_local_steps=2)
    state = optim.fedavg_momentum(1.0).init(params)
    p_out, _, p_m = plain(_clone(params), _clone(state), data)
    groups = []
    real = dist.all_reduce

    def spy(t, *a, group=None, **k):
        groups.append(tuple(dist.get_process_group_ranks(group))
                      if group is not None else None)
        return real(t, *a, group=group, **k)

    dist.all_reduce = spy
    try:
        m_out, _, m_m = meshed(_clone(params), _clone(state), data)
    finally:
        dist.all_reduce = real
    data_groups = [tuple(int(r) for r in g) for g in
                   mesh["data"].mesh.reshape(1, -1).tolist()]
    return dict(loss=float(_np(p_m["loss"])), mesh_loss=float(_np(m_m["loss"])),
                params=_tree_np(p_out), mesh_params=_tree_np(m_out),
                groups=sorted(set(g for g in groups if g)),
                data_group=tuple(mesh["data"].mesh.tolist()),
                model_group=tuple(mesh["model"].mesh.tolist()),
                data_sharding=str(data_sh(data["tokens"])))


def int8_bound_spy(worst: list):
    """Wrap ``tpcomm.int8_sum`` to record, at every call, the largest
    ``|int8 sum - exact f32 sum| / (sum_j s_j + m ulps)`` over the output
    (the exact sum by an all_reduce of the partials): at most 1 where
    the reduction keeps its bound. Returns the unwrap function."""
    from repro_torch.models import partitioning, tpcomm

    real = tpcomm.int8_sum

    def spy(part):
        out = real(part)
        dims = partitioning.model_dims()
        exact = partitioning.all_reduce_sum(part, dims)
        _, s = tpcomm._quant_rows(part)
        scales = partitioning.all_reduce_sum(s, dims)
        m = partitioning.model_size()
        bound = scales + m * torch.nextafter(
            exact.abs(), torch.tensor(float("inf"))) - m * exact.abs()
        worst.append(float(((out - exact).abs() / bound).max()))
        return out

    tpcomm.int8_sum = spy

    def undo():
        tpcomm.int8_sum = real

    return undo


def steps_serve(rank, world, wd):
    """The int8 and bf16-wire prefill of reduced qwen2_72b (the reference's
    launch test's widths, f32) on the (data 2, model 2) mesh beside the
    mesh-free prefill, then a decode step of each's caches."""
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    mesh = _model_mesh(world, data=2)
    out = {}
    for name, over in (("qwen2", dict(num_heads=8, num_kv_heads=2,
                                      head_dim=16, d_ff=128)),
                       ("qwen2_heads", dict(num_heads=16, num_kv_heads=2,
                                            head_dim=8, d_ff=128))):
        cfg = _f32("qwen2_72b", **over)
        params = registry.init_params(cfg, seed=0, device="cpu")
        batch = {"tokens": registry.make_batch(cfg, 8, 16, seed=7,
                                               device="cpu")["tokens"]}
        token = batch["tokens"][:, -1:]
        res = {}
        plain_pre = steps.make_prefill_step(cfg, max_len=24)
        logits, caches = plain_pre(params, batch)
        res["logits"] = _np(logits)
        res["decode"] = _np(steps.make_decode_step(cfg)(params, token,
                                                        caches)[0])
        for wire in ("bf16", "int8"):
            partitioning.reset_routes()
            pre = steps.make_prefill_step(cfg, mesh, tp_comm=wire,
                                          max_len=24)
            worst = []
            undo = int8_bound_spy(worst)
            try:
                ml, mc = pre(params, batch)
            finally:
                undo()
            routes = dict(partitioning.ROUTES)
            res[f"{wire}_bound"] = worst
            dec = steps.make_decode_step(cfg, mesh)
            dl, mc = dec(params, token, mc)
            res[wire] = dict(logits=_np(ml), routes=routes,
                             decode=_np(dl),
                             cache_placements=str(mc[0]["k"].placements),
                             cache_local=tuple(mc[0]["k"].to_local().shape))
        res["coord"] = tuple(mesh.get_coordinate())
        out[name] = res
    return out



def constraint_redistributes(rank, world, wd):
    """``with_logical_constraint`` on a (data 1, model m) mesh: a
    replicated DTensor goes to the spec (heads over "model"), a plain
    tensor is returned as it is, and ``partitioning.full`` gives the whole
    value back."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import partitioning

    mesh = _model_mesh(world)
    whole = torch.arange(4 * 2 * world, dtype=torch.float32).reshape(
        4, 2 * world)
    rep = DTensor.from_local(whole, mesh, [Replicate(), Replicate()],
                             run_check=False)
    with partitioning.axis_rules(mesh):
        got = partitioning.with_logical_constraint(rep, ("batch", "heads"))
        plain = partitioning.with_logical_constraint(whole, ("batch",
                                                             "heads"))
        back = partitioning.full(got)
    return dict(placements=str(tuple(got.placements)),
                local=_np(got.to_local()), plain_same=plain is whole,
                back=_np(back), whole=_np(whole))


def fsdp_layer_gathers(rank, world, wd):
    """One FSDP train step of ``lm_1b_heads`` on the (data 2, model 2)
    mesh under remat "full" and "none": the gathers each makes, and how
    many leaves of the layers the rules shard over "data"."""
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    mesh = _model_mesh(world, data=2)
    spec = dict(MESH_TRAIN["lm_1b_heads"])
    cfg = _f32(spec.pop("arch"), **spec)
    params = registry.init_params(cfg, seed=0, device="cpu")
    batch = registry.make_batch(cfg, 8, 16, seed=1, device="cpu")
    out = {}
    for remat in ("full", "none"):
        step, _ = steps.make_sgd_train_step(cfg, mesh, optimizer="sgd",
                                            lr=0.1, remat=remat)
        partitioning.reset_routes()
        step(_clone(params), optim.sgd(0.1).init(params), batch)
        out[remat] = partitioning.ROUTES[("gather", "all_gather")]
    rules = steps.strategy_rules(cfg, True)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    with partitioning.axis_rules(mesh, rules):
        axes = registry.param_axes(cfg)
        out["layer_fsdp_leaves"] = sum(
            1 for k, ax in axes.items() if k.startswith("layers.")
            and any("data" in (e if isinstance(e, tuple) else (e,))
                    for e in partitioning.spec_for(ax, shapes[k])
                    if e is not None))
    return out


# ---------------------------------------------------------------------------
# the dry run's counts in a real world (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

# name -> (arch, kind, algorithm, mesh shape): reduced f32 widths (_f32),
# global batch 8, sequence 16; lm_350m splits its clients' rows over
# "model" (dp), lm_1b its heads, FFN and vocabulary (tp); phi35_moe's
# routing groups span the ranks' rows (train: 128 tokens, 64 a rank;
# decode: 8 tokens, 2 a rank), its experts split over "model"
DRYRUN_CASES = {
    "sgd_350m": ("lm_350m", "train", "sgd", (2, 2)),
    "round_350m": ("lm_350m", "train", "local_sgd", (2, 2)),
    "prefill_1b": ("lm_1b", "prefill", "sgd", (2, 2)),
    "sgd_1b": ("lm_1b", "train", "sgd", (2, 2, 2)),
    "round_1b": ("lm_1b", "train", "local_sgd", (2, 2, 2)),
    "decode_1b": ("lm_1b", "decode", "sgd", (2, 2, 2)),
    "sgd_moe": ("phi35_moe", "train", "sgd", (2, 2)),
    "decode_moe": ("phi35_moe", "decode", "sgd", (2, 2, 2)),
}
DRYRUN_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
DRYRUN_BATCH, DRYRUN_SEQ = 8, 16


def dryrun_counts(rank, world, wd):
    """Each :data:`DRYRUN_CASES` case of this world's size on a gloo mesh:
    ``dryrun.build_step``'s step on real tensors at its placements, with
    its collectives and FLOPs counted as the dry run counts them; and the
    bytes of a rank's storage blocks of the whole parameters and AdamW
    state that ``steps.shard_tree`` places by the step's rules (the serve
    steps': FSDP for MoE only)."""
    import math

    from repro_torch.launch import dryrun, steps
    from repro_torch.models import registry

    out = {}
    for name, (arch, kind, alg, shape) in DRYRUN_CASES.items():
        if math.prod(shape) != world:
            continue
        mesh = mesh_lib.make_mesh(shape, DRYRUN_AXES[len(shape)],
                                  device="cpu")
        cfg = _f32(arch)
        step, specs, placements = dryrun.build_step(
            cfg, kind, mesh, batch=DRYRUN_BATCH, seq=DRYRUN_SEQ,
            algorithm=alg, n_groups=math.prod(shape[:-1]))
        gen = torch.Generator().manual_seed(0)

        def make(shp, dtype):
            if dtype.is_floating_point:
                return (0.02 * torch.randn(shp, generator=gen)).to(dtype)
            return torch.zeros(shp, dtype=dtype)

        args = dryrun.materialize(specs, placements, mesh, make)
        counted = dryrun.count_step(step, args, track_memory=False)
        params = registry.init_params(cfg, seed=0, device="cpu")
        p_axes = registry.param_axes(cfg)
        rules = (steps.strategy_rules(cfg, True) if kind == "train" else
                 steps.fsdp_rules(steps._serve_fsdp(cfg, None)))
        opt = optim.adamw(3e-4).init(params)
        out[name] = dict(
            collectives=counted["collectives"], flops=counted["flops"],
            param_bytes=dryrun.local_bytes(
                steps.shard_tree(params, p_axes, mesh, rules)),
            optimizer_bytes=dryrun.local_bytes(steps.shard_tree(
                opt, steps._optimizer_axes("adamw", p_axes), mesh, rules)),
            whole_param_bytes=dryrun.local_bytes(params))
    return out


# ---------------------------------------------------------------------------
# serving on a data-parallel mesh (tests/test_torch_moe_mesh.py,
# tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------

# the MoE cases: reduced phi35_moe (4 experts, top 2) and qwen3_moe with
# 16 experts and its top 8, f32 (_f32)
MOE_MESH = {"phi35_moe": {},
            "qwen3_moe": dict(num_experts=16, experts_per_token=8)}
# (B, S): one routing group of 24 tokens over every rank; groups of 512
# of 1,536 tokens, which a rank's rows cover in part (a rank of 2 holds
# one group and half of the next; of 4, parts of two)
MOE_SHAPES = {"one_group": (4, 6), "three_groups": (4, 384)}


def moe_params_path(wd, arch):
    return os.path.join(wd, f"{arch}_params.npz")


def moe_load_params(wd, arch):
    """The parameters the parent wrote (the reference's init, converted)."""
    with np.load(moe_params_path(wd, arch)) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def moe_input(cfg, b, s, seed=5):
    return _rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _moe_meshes(world):
    """(data n) over every rank, and (data 2, model 2) in a world of 4."""
    out = {"data": _model_mesh(world, data=world)}
    if world == 4:
        out["data2_model2"] = _model_mesh(world, data=2)
    return out


class _RouteSpy:
    """Records every ``moe.route`` call's result while active."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from repro_torch.models import moe

        self.real = moe.route

        def spy(cfg, p, xg):
            r = self.real(cfg, p, xg)
            self.seen.append(r)
            return r

        moe.route = spy
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.real


def _token_routing(r, k, e):
    """One Routing's per-token arrays, in the grouped tokens' order."""
    return dict(choices=_np(r.onehot.reshape(-1, k, e)),
                kept=_np(r.kept.reshape(-1, k, e)),
                slot=_np(r.slot.reshape(-1, k, e)),
                weights=_np(r.weights.reshape(-1, k)))


def moe_mesh_apply(rank, world, wd):
    """``moe.apply`` of each :data:`MOE_MESH` layer (layer 0 of the
    parameters the parent wrote) on each :data:`MOE_SHAPES` batch: the
    mesh-free run of the whole batch, then each mesh's run of the rank's
    rows under ``batch_split`` (the rank's experts on (data 2, model 2)):
    its rows, aux loss and its tokens' routing beside the mesh-free run's,
    and the batch chain's collectives."""
    from repro_torch.models import moe, partitioning

    out = {}
    for arch, over in MOE_MESH.items():
        cfg = _f32(arch, **over)
        k, e = cfg.experts_per_token, cfg.num_experts
        params = moe_load_params(wd, arch)
        p = {n[len("layers.0.moe."):]: v for n, v in params.items()
             if n.startswith("layers.0.moe.")}
        axes = moe.param_axes(cfg)
        for shape, (b, s) in MOE_SHAPES.items():
            x = torch.from_numpy(moe_input(cfg, b, s))
            with torch.no_grad(), _RouteSpy() as seen:
                want, want_aux = moe.apply(cfg, p, x)
            plain = _token_routing(seen[0], k, e) if len(seen) == 1 else None
            for name, mesh in _moe_meshes(world).items():
                partitioning.reset_routes()
                with torch.no_grad(), partitioning.axis_rules(mesh):
                    dims = partitioning.mesh_dims(
                        partitioning.resolve_axis("batch", b))
                    rows = b // partitioning._shards(dims)
                    lo = partitioning.block_index(dims) * rows
                    lp = {n: partitioning.to_compute(v, axes[n],
                                                     tuple(v.shape),
                                                     whole=True)
                          for n, v in p.items()}
                    with partitioning.batch_split(dims), \
                            _RouteSpy() as got_seen:
                        got, aux = moe.apply(cfg, lp, x[lo:lo + rows])
                    total = rows * s
                    gs = moe._group_size(b * s)
                    start = lo * s
                    first = start - (start // gs) * gs
                    mine = _token_routing(got_seen[0], k, e)
                    own = {key: v[first:first + total]
                           for key, v in mine.items()}
                    ref = {key: v[start:start + total]
                           for key, v in plain.items()}
                out[(arch, shape, name)] = dict(
                    lo=lo, rows=_np(got), aux=float(aux),
                    want=_np(want), want_aux=float(want_aux),
                    routing=own, plain_routing=ref,
                    spans=bool(total % gs), routes=dict(partitioning.ROUTES),
                    local_experts=int(lp["wi"].shape[0]))
    return out


def moe_mesh_grads(rank, world, wd):
    """The train step's gradient (``steps.dp_loss`` of whole parameters,
    as ``make_sgd_train_step`` differentiates it) of reduced phi35_moe on
    B 4 x S 6 (one routing group of 24 over every rank) on each mesh,
    beside ``registry.loss_fn``'s mesh-free gradient."""
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    cfg = _f32("phi35_moe")
    params = moe_load_params(wd, "phi35_moe")
    batch = registry.make_batch(cfg, 4, 6, seed=3, device="cpu")
    p_axes = registry.param_axes(cfg)
    shapes = steps._shapes_of(registry.param_specs(cfg))
    b_axes = registry.batch_axes(cfg)

    def grads(loss_fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss), {k: _np(v) for k, v in zip(leaves, g)}

    want_loss, want = grads(lambda p, b: registry.loss_fn(cfg, p, b))
    out = {}
    for name, mesh in _moe_meshes(world).items():
        partitioning.reset_routes()
        with partitioning.axis_rules(mesh, steps.strategy_rules(cfg, False)):
            dims = steps.batch_dims(batch)
            with partitioning.batch_split(dims):
                loss, got = grads(steps.dp_loss(cfg, p_axes, shapes, b_axes,
                                                whole=True))
        out[name] = dict(loss=loss, grads=got,
                         routes=dict(partitioning.ROUTES))
    return dict(want_loss=want_loss, want=want, mesh=out)


MOE_STEPS = dict(batch=4, seq=6, max_len=8)


def moe_mesh_steps(rank, world, wd):
    """``make_prefill_step`` then ``make_decode_step`` of reduced
    phi35_moe on each mesh, whole inputs (B 4 x S 6: one routing group of
    24 tokens over the data ranks; the decode step's 4 tokens one group):
    the rank's rows of the logits."""
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    cfg = _f32("phi35_moe")
    params = moe_load_params(wd, "phi35_moe")
    b, s = MOE_STEPS["batch"], MOE_STEPS["seq"]
    tokens = torch.from_numpy(moe_step_tokens(cfg))
    out = {}
    for name, mesh in _moe_meshes(world).items():
        pre = steps.make_prefill_step(cfg, mesh, max_len=MOE_STEPS["max_len"])
        logits, caches = pre(params, {"tokens": tokens})
        dec = steps.make_decode_step(cfg, mesh)
        dlogits, caches = dec(params, tokens[:, -1:], caches)
        with partitioning.axis_rules(mesh):
            dims = partitioning.mesh_dims(partitioning.resolve_axis("batch",
                                                                    b))
            lo = partitioning.block_index(dims) * (b // partitioning._shards(
                dims))
        out[name] = dict(lo=lo, prefill=_np(logits), decode=_np(dlogits),
                         seq=s)
    return out


def moe_step_tokens(cfg):
    b, s = MOE_STEPS["batch"], MOE_STEPS["seq"]
    return _rng(9).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# the schedulers' cases: (arch, prompt lengths, max_new, max_len, chunk);
# the MoE prompts powers of two no longer than the chunk, as
# tests/test_torch_serve.py's
SERVE_MESH = {
    "stablelm_3b": ([6, 13, 3, 9, 11, 5], 6, 24, 8),
    "phi35_moe": ([8, 4, 16, 8, 2, 16], 5, 32, 16),
}
SERVE_SLOTS = 4


def serve_mesh_requests(cfg, arch, cls):
    """The same requests for both packages' schedulers (``cls`` their
    ``Request``), arrivals staggered after the first two."""
    lens, max_new, _, _ = SERVE_MESH[arch]
    rng = _rng(21)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(n,))
                .astype(np.int32), max_new=max_new,
                arrival=0.0 if i < 2 else 1e-4 * i)
            for i, n in enumerate(lens)]


def serve_mesh(rank, world, wd):
    """The continuous and static schedulers with ``mesh=`` over 4 slots
    (2 a rank on (data 2), (data 2, model 2) in a world of 4) for each
    :data:`SERVE_MESH` case (reduced, the parent's parameters): every
    request's tokens, the pool's local and global shapes, whether steps
    were captured; and the ValueError of a pool of 3 slots."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    mesh = _model_mesh(world, data=2)
    out = {}
    for arch, (lens, max_new, max_len, chunk) in SERVE_MESH.items():
        cfg = registry.get_config(arch).reduced()
        params = moe_load_params(wd, arch + "_serve")
        for kind, cls in (("continuous", serve.ContinuousBatchingScheduler),
                          ("static", serve.StaticWaveScheduler)):
            sched = cls(cfg, params, SERVE_SLOTS, max_len, chunk, mesh=mesh)
            got = sched.run(serve_mesh_requests(cfg, arch, serve.Request))
            leaf = pytree.tree_leaves(sched._pool)[0]
            out[(arch, kind)] = dict(
                tokens=got, captured=sched.captured,
                replayed=sched.replayed_launches(),
                dtensor=all(sharding.is_dtensor(v)
                            for v in pytree.tree_leaves(sched._pool)),
                local=tuple(leaf.to_local().shape), shape=tuple(leaf.shape),
                builds=(sched.prefill_traces, sched.decode_traces))
        try:
            serve.ContinuousBatchingScheduler(cfg, params, 3, max_len, chunk,
                                              mesh=mesh)
            out[(arch, "three_slots")] = None
        except ValueError as err:
            out[(arch, "three_slots")] = str(err)
    return out


def moe_mesh_card(rank, world, wd):
    """(b)'s routing on the card: one full-width phi35_moe MoE layer (bf16,
    seeded) on B 8 x S 64 (one routing group of 512 over the 2 ranks) and
    on a decode batch of 8 tokens, the mesh-free run of the whole batch
    and each rank's rows on a (data 2) mesh of gloo ranks sharing the
    card; the rank's tokens' routing compared bitwise, and its rows."""
    from repro_torch.models import moe, partitioning, registry

    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = mesh_lib.make_mesh((world,), ("data",), device="cuda")
    cfg = registry.get_config("phi35_moe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = moe.MoE(cfg, gen, device="cuda")
    p = {n: v.detach() for n, v in layer.named_parameters()}
    k, e = cfg.experts_per_token, cfg.num_experts
    out = {}
    for name, (b, s) in (("prefill", (8, 64)), ("decode", (8, 1))):
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.torch_dtype)
        with torch.no_grad(), _RouteSpy() as seen:
            want, _ = moe.apply(cfg, p, x)
        plain = _token_routing(seen[0], k, e)
        rows = b // world
        lo = rank * rows
        with torch.no_grad(), partitioning.axis_rules(mesh), \
                partitioning.batch_split((0,)), _RouteSpy() as got_seen:
            got, _ = moe.apply(cfg, p, x[lo:lo + rows])
        mine = _token_routing(got_seen[0], k, e)
        start, total = lo * s, rows * s
        gs = moe._group_size(b * s)
        first = start - (start // gs) * gs
        out[name] = dict(
            spans=bool(total % gs),
            routing_equal={key: bool(np.array_equal(
                mine[key][first:first + total],
                plain[key][start:start + total])) for key in mine},
            rows_equal=bool(torch.equal(got, want[lo:lo + rows])),
            max_abs=float((got.float() - want[lo:lo + rows].float())
                          .abs().max()),
            want_max=float(want.float().abs().max()))
    return out
