"""The port's compiled plan executor (``runtime/executor.py``).

On the CPU a compiled plan runs its units as FX graph modules: it must
be bitwise ``run_plan`` for every program of ``test_torch_plan.py`` (the
oracle programs and the shipped rounds at reduced lm_350m). The cache: one build across rounds, a plan built again from a new
trace is a hit, a changed constant is a new fingerprint and new shapes a
new entry. Donation updates the carried arguments in place, argument i
with output i after the last stage, and no other input; a stage that
reads a donated argument after its output is defined sees the old value,
and so do views of it. Fusion merges
adjacent local stages. What a CUDA graph cannot hold raises at compile
time (no card needed: the check is structural). The multi-round trainer
(P2) is one loop stage whose compiled plan is bitwise the direct
trainer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_programs import (  # noqa: E402
    PROGRAMS, SHIPPED, assert_bitwise, flat, load_model, shipped_plans)
from repro_torch import core as drjax  # noqa: E402
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plan(name):
    fn, args, place = PROGRAMS[name]("torch")
    return interp.build_plan(interp.trace(fn, *args), place), flat(args)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compiled_bitwise_to_run_plan(name):
    plan, args = _plan(name)
    compiled = plan.compile(device="cpu")
    assert_bitwise(compiled(*args), interp.run_plan(plan, *args))


@pytest.mark.parametrize("kind", SHIPPED)
def test_compiled_shipped_rounds_bitwise(kind):
    _, plan, _, targs = shipped_plans(kind, load_model())
    args = flat(targs)
    compiled = plan.compile(device="cpu")
    assert_bitwise(compiled(*args), interp.run_plan(plan, *args))
    if kind in ("flat", "hier_int8"):  # no control flow: one unit
        assert compiled.num_units == 1


def _build():
    @drjax.program(partition_size=3)
    def f(x, ys):
        return drjax.reduce_sum(
            drjax.map_fn(lambda a, b: a * b, (drjax.broadcast(x), ys)))

    args = (torch.tensor(2.0), torch.tensor([1.0, 2.0, 3.0]))
    return (lambda: interp.build_plan(interp.trace(f, *args), 3)), args


def test_one_build_across_rounds():
    build, args = _build()
    compiled = build().compile(device="cpu")
    for _ in range(10):
        compiled(*args)
    assert compiled.trace_count == 1


def test_replan_hits_cache():
    build, args = _build()
    c1 = build().compile(device="cpu")
    c1(*args)
    size = executor.executor_cache_size()
    c2 = build().compile(device="cpu")
    c2(*args)
    assert c2.fingerprint == c1.fingerprint
    assert executor.executor_cache_size() == size
    assert c2.trace_count == 1


def test_different_consts_different_fingerprint():
    def build(cval):
        const = torch.tensor([cval, 2.0, 3.0])

        @drjax.program(partition_size=3)
        def f(x):
            return drjax.reduce_sum(drjax.broadcast(x) * const)

        return interp.build_plan(interp.trace(f, torch.tensor(1.0)), 3)

    assert (executor.plan_fingerprint(build(1.0))
            != executor.plan_fingerprint(build(7.0)))
    assert (executor.plan_fingerprint(build(1.0))
            == executor.plan_fingerprint(build(1.0)))


def test_new_shapes_are_a_new_entry():
    @drjax.program(partition_size=3)
    def f(x, ys):
        return drjax.reduce_sum(
            drjax.map_fn(lambda a, b: a * b, (drjax.broadcast(x), ys)))

    a1 = (torch.tensor(2.0), torch.tensor([1.0, 2.0, 3.0]))
    a2 = (torch.tensor(2.0), torch.stack([a1[1]] * 2, dim=1))
    executor.clear_executor_cache()
    c1 = interp.build_plan(interp.trace(f, *a1), 3).compile(device="cpu")
    c1(*a1)
    c2 = interp.build_plan(interp.trace(f, *a2), 3).compile(device="cpu")
    c2(*a2)
    assert executor.executor_cache_size() == 2
    assert c1.trace_count == 1 and c2.trace_count == 1


def test_donation_updates_carried_args_in_place():
    """The quadratic round with its params and server state donated: they
    hold the round's new values after the call, are returned in their
    outputs' places, and the data is untouched."""
    plan, args = _plan("quadratic_round")
    ref = interp.run_plan(plan, *[a.clone() for a in args])
    n_carry = len(args) - 2  # params and server state; x and y are data
    before = [a.clone() for a in args]
    compiled = plan.compile(device="cpu", donate_argnums=range(n_carry))
    outs = compiled(*args)
    assert_bitwise(outs, ref)
    carried = {id(a) for a in args[:n_carry]}
    assert sum(id(o) in carried for o in outs) == n_carry
    for a, b in zip(args[n_carry:], before[n_carry:]):
        assert torch.equal(a, b)
    moved = [not torch.equal(a, b) for a, b in zip(args[:n_carry],
                                                   before[:n_carry])]
    assert any(moved)


def _swap_round():
    """Two carried leaves of one shape whose outputs swap places: new p is
    q plus the clients' mean, new q is p passed through unchanged (the
    caller's own tensor among the outputs)."""
    @drjax.program(partition_size=3)
    def f(p, q, xs):
        return q + drjax.reduce_mean(xs), p

    rng = np.random.default_rng(0)
    args = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((2,), (2,), (3, 2))]
    return interp.build_plan(interp.trace(f, *args), 3), args


def test_donation_takes_output_i_in_place():
    """Donated argument i takes output i, also where the outputs are the
    carried leaves permuted and one is an argument passed through: every
    value is read before the first write, so new q is old p."""
    plan, args = _swap_round()
    assert plan.out_atoms[1] is plan.invars[0]  # p passes through
    before = [a.clone() for a in args]
    want = interp.run_plan(plan, *before)
    assert torch.equal(want[1], before[0])
    outs = plan.compile(device="cpu", donate_argnums=(0, 1))(*args)
    assert outs[0] is args[0] and outs[1] is args[1]
    assert_bitwise(outs, want)
    assert torch.equal(args[2], before[2])


def test_donation_refuses_an_output_of_another_shape():
    """Output 0 is a scalar here, argument 0 a vector: donating argument 0
    raises, and leaves every argument as it was."""
    @drjax.program(partition_size=3)
    def f(p, xs):
        return drjax.reduce_sum(xs).sum(), p

    args = [torch.ones(2), torch.ones(3, 2)]
    plan = interp.build_plan(interp.trace(f, *args), 3)
    with pytest.raises(ValueError, match="donated argument 0 takes output 0"):
        plan.compile(device="cpu", donate_argnums=(0,))(*args)
    assert torch.equal(args[0], torch.ones(2))


def test_stage_units_after_fusion():
    """Interleaved server/group compute: run_plan sees alternating local
    stages, the executor one fused unit per local run. (The second map
    closes over a server value, lifted into its node as an input every
    group gets whole.)"""
    @drjax.program(partition_size=3)
    def f(x, ys):
        z = drjax.map_fn(lambda a, b: a * b, (drjax.broadcast(x), ys))
        s = x * 3.0
        z2 = drjax.map_fn(lambda a: a + s, (z,))
        return drjax.reduce_sum(z2) + s

    args = (torch.tensor(2.0), torch.tensor([1.0, 2.0, 3.0]))
    plan = interp.build_plan(interp.trace(f, *args), 3)
    assert [s.kind for s in plan.stages] == [
        "BROADCAST", "GROUP_COMPUTE", "SERVER_COMPUTE", "GROUP_COMPUTE",
        "REDUCE", "SERVER_COMPUTE"]
    fused = executor.fuse_stages(plan.stages)
    assert [s.kind for s in fused] == ["BROADCAST", "FUSED_COMPUTE",
                                       "REDUCE", "FUSED_COMPUTE"]
    compiled = plan.compile(device="cpu")
    assert compiled.num_stage_units == 4
    assert compiled.num_units == 1
    assert_bitwise(interp.run_plan(plan, *args), [f(*args)])
    assert_bitwise(compiled(*args), interp.run_plan(plan, *args))


def test_uncapturable_plan_raises_at_compile_time():
    """A node that reads a device value on the host (``.item()``) cannot
    sit in a CUDA graph: compiling for the card raises, before any round;
    the CPU has no graph to capture."""
    @drjax.program(partition_size=3)
    def f(x, ys):
        return drjax.reduce_sum(drjax.broadcast(x) * ys)

    args = (torch.tensor(2.0), torch.tensor([1.0, 2.0, 3.0]))
    gm = interp.trace(f, *args)
    g = gm.graph
    red = [n for n in g.nodes if interp._comm_name(n) == "reduce_sum"][0]
    with g.inserting_after(red):
        item = g.call_function(torch.ops.aten._local_scalar_dense.default, (red,))
    with g.inserting_after(item):
        scaled = g.call_function(torch.ops.aten.mul.Tensor, (red, item))
    [out] = [n for n in g.nodes if n.op == "output"]
    out.args = ([scaled],)
    gm.recompile()
    plan = interp.build_plan(gm, 3)
    with pytest.raises(NotImplementedError, match="cannot capture"):
        plan.compile(device="cuda")
    assert_bitwise(plan.compile(device="cpu")(*args),
                   [f(*args) * f(*args).item()])


def test_compiled_plan_checks_device():
    plan, args = _plan("nested_2x4")
    with pytest.raises(ValueError, match="unsupported device"):
        plan.compile(device="mps")
    compiled = plan.compile(device="cpu")
    np.testing.assert_array_equal(compiled(*args)[0].numpy(),
                                  interp.run_plan(plan, *args)[0].numpy())


def test_donated_write_keeps_views_of_the_old_value():
    """Output 1 is a view of argument 0 (a reshape); argument 0 is donated
    and takes output 0 in place: the view is copied first, so output 1
    keeps the old value."""
    @drjax.program(partition_size=3)
    def f(p, xs):
        return p + drjax.reduce_mean(xs), p.reshape(2, 2)

    args = [torch.arange(4.0), torch.ones((3, 4))]
    plan = interp.build_plan(interp.trace(f, *args), 3)
    before = args[0].clone()
    want = interp.run_plan(plan, *[a.clone() for a in args])
    outs = plan.compile(device="cpu", donate_argnums=(0,))(*args)
    assert outs[0] is args[0]
    assert_bitwise(outs, want)
    assert torch.equal(outs[1], before.reshape(2, 2))


def test_donated_argument_is_written_after_the_last_stage():
    """New p is defined by the first stage and p is read again by a later
    one: the donated argument is written after the last stage, so the late
    read sees p's old value, the run of stages stays one unit and the
    donated call is bitwise ``run_plan``."""
    @drjax.program(partition_size=3)
    def f(p, xs):
        q = p * 2.0
        s = drjax.reduce_sum(drjax.map_fn(lambda a, b: a * b,
                                          (drjax.broadcast(q), xs)))
        return q, s + p

    args = [torch.tensor([1.0, 2.0]), torch.ones((3, 2))]
    plan = interp.build_plan(interp.trace(f, *args), 3)
    want = interp.run_plan(plan, *[a.clone() for a in args])
    compiled = plan.compile(device="cpu", donate_argnums=(0,))
    assert compiled.num_units == 1
    assert compiled.donation_report().ok
    outs = compiled(*args)
    assert outs[0] is args[0]
    assert_bitwise(outs, want)


def test_multi_round_plan_compiled_bitwise_to_direct_trainer():
    """P2: the shipped multi-round trainer is one LOOP[scan] stage; its
    compiled plan (the body's unit run once per round), with the carry
    donated, is bitwise the direct trainer's Python loop, built once."""
    _, plan, tr, targs = shipped_plans("multi_round", load_model())
    assert [(s.kind, s.loop_kind, s.trip_count) for s in plan.stages] == [
        ("LOOP", "scan", 2)]
    direct = flat(tr(*targs))
    args = flat(targs)
    n_carry = len(flat(targs[:2]))
    compiled = plan.compile(device="cpu", donate_argnums=range(n_carry))
    assert compiled.donation_report().ok and compiled.num_units == 1
    for _ in range(2):
        carry = [a.clone() for a in args[:n_carry]]
        outs = compiled(*carry, *args[n_carry:])
        assert_bitwise(outs, direct)
        assert all(o is c for o, c in zip(outs, carry))
    assert compiled.trace_count == 1


def test_cuda_graphs_on_the_cpu_run_eagerly_and_count_builds():
    """``CudaGraphs`` on CPU tensors runs its function at every call and
    counts one build per key, as the serve steps' build counts read it."""
    counter = executor.TraceCounter()
    calls = []

    def step(x):
        calls.append(1)
        return x.add_(1)

    graphs = executor.CudaGraphs(step, device="cpu", counter=counter)
    x = torch.zeros(3)
    for key in (8, 8, 4, 8):
        graphs(key, x)
    assert counter.count == 2 and len(calls) == 4
    assert torch.equal(x, torch.full((3,), 4.0))
    assert graphs.replays == 0 and graphs.replayed == {}


def test_uncounted_leaves_the_launch_counters_and_reports_the_calls():
    """``ops.uncounted``: the wrapper calls made inside the block (a CUDA
    graph capture's, recorded and not launched) come back in its dict, and
    every counter, K4's by route too, is as it was before the block."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan

    ops.reset_launches()
    ops.quantize.launches = 2
    with ops.uncounted() as made:
        ops.quantize.launches += 3
        ops.lru_scan_fwd.launches += 1
        rglru_scan.ROUTE_LAUNCHES["tma"] += 1
    assert made == {"quantize": 3, "lru_scan_fwd": 1}
    counts = ops.launch_counts()
    assert counts["quantize"] == 2 and counts["lru_scan_fwd"] == 0
    assert rglru_scan.ROUTE_LAUNCHES == {"tma": 0, "simt": 0}
    ops.reset_launches()
