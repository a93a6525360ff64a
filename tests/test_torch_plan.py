"""The port's MapReduce plans (``core/interpreter.py``) against the
reference's (paper §5).

For every oracle program of ``tests/test_interpreter.py`` and
``tests/test_interpreter_controlflow.py`` that needs no ``jit`` (a
reference plan of a ``jax.jit``-wrapped program fails on the installed JAX,
ROADMAP R1, so the jit-transparency tests have no counterpart to hold
here): the flat quadratic round, MAML and its gradient, a scan, a ``while``
with communication in its body and one in its predicate, a ``cond`` with
communication in both branches, the nested 2 x 4 two-level reduce and the
fused int8 reduce. The port writes their control flow with torch's
higher-order ops (``while_loop``, ``scan``, ``cond``), closed-over values
passed as their additional inputs.

* The communication skeleton equals the reference's: recursive, each
  maximal run of communication stages as one block of (kind@placement[tag],
  stages, elements moved), with the loops' kinds and trip counts, the
  branches, and the inputs' and outputs' lattice depths (a sub-plan's
  inputs in sorted order and only those it reads: torch puts a loop's
  carries first and hands a while's predicate the body's inputs too, JAX
  puts its constants first and passes only what each closes over).
* ``run_plan`` is bitwise the port's direct execution, and within 1e-6 of
  the reference's ``run_plan`` (int8: within one quantization step plus
  1e-6).

The shipped rounds at reduced lm_350m (flat, flat int8, top-k,
hierarchical fused int8 2 x 2, async, multi-round and FedSGD with learned
weights): ``run_plan`` bitwise the direct port round, and the skeleton the
reference's with each block's stage counts left out (the reference stacks
a layer's parameters into one leaf, the port keeps one leaf per layer, so
a block holds more stages here; the elements each block moves are equal).
The multi-round trainer is one ``LOOP[scan]`` stage in both packages,
with the round as its body (the port records a scan node while tracing),
and ``run_plan`` of it is bitwise the direct trainer's Python loop. So is
the pipelined round (reduced lm_350m's two layers as two stages, four
microbatches): one ``LOOP[scan]`` of the ticks with the ``TRANSFER`` in its
body, its compiled plan (buffer donated) bitwise the direct round. The
MAML train step's plan is its outer gradient (the map's broadcast and
``reduce_mean``, then the cotangent's broadcast and the params' gradient's
``reduce_sum``), and Branch-Train-Merge's a broadcast, the experts' map and
the mean and max reductions, each the reference's skeleton.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._higher_order_ops.scan import scan_op  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from _torch_programs import (  # noqa: E402
    PROGRAMS, SHIPPED, BATCH, SEQ, both, flat, maml, shipped_plans, shipped,
    assert_bitwise, jplan, load_model, tplan)
from repro import core as jdrjax  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    return load_model()


# ---------------------------------------------------------------------------
# skeletons of both packages' plans
# ---------------------------------------------------------------------------


def _label(pkg, s):
    if pkg == "jax":
        compress = s.eqn.params.get("compress") if s.kind == "REDUCE" else None
        elems = int(np.prod(s.eqn.invars[0].aval.shape))
    else:
        compress = getattr(s, "compress", None)
        elems = s.node.args[0].meta["val"].numel()
    if s.kind == "TRANSFER":
        wrap = " wrap" if s.wrap else ""
        return f"TRANSFER{s.shift:+d}{wrap}@{s.placement}", elems
    kind = "BROADCAST" if s.kind == "BROADCAST" else s.op.upper()
    return f"{kind}@{s.placement}" + (f"[{compress}]" if compress else ""), elems


def _numel(v, pkg):
    if pkg == "jax":
        return int(np.prod(v.aval.shape)) if hasattr(v, "aval") else 1
    val = v.meta.get("val") if hasattr(v, "meta") else None
    return val.numel() if isinstance(val, torch.Tensor) else 1


def _depths(plan, top, by_elements, pkg, consts=frozenset()):
    """Lattice depths of a plan's inputs and outputs; ``consts`` are the
    inputs that carry constants (left out)."""
    invars = plan.jaxpr.jaxpr.invars if pkg == "jax" else plan.invars
    keep = [not any(v is c for c in consts) for v in invars]
    if by_elements:
        outvars = plan.out_atoms
        per = []
        for vs, ds, ks in ((invars, plan.partitioned_invars, keep),
                           (outvars, plan.partitioned_outvars,
                            [True] * len(outvars))):
            out = {}
            for v, d, k in zip(vs, ds, ks):
                if k:
                    out[int(d)] = out.get(int(d), 0) + _numel(v, pkg)
            per.append(tuple(sorted(out.items())))
        return tuple(per)
    ins = tuple(int(d) for d in plan.partitioned_invars)
    outs = tuple(int(d) for d in plan.partitioned_outvars)
    if top:
        return ins, outs
    used = _used_invars(plan, pkg)
    return tuple(sorted(d for d, u, k in zip(ins, used, keep) if u and k)), outs


def _const_binders(plan, stage, pkg):
    """The inputs of a loop body that carry constants: JAX passes the
    constants a loop body reads as the loop's leading operands, torch
    keeps them inside the body's graph."""
    if pkg != "jax":
        return frozenset()
    consts = list(plan.jaxpr.jaxpr.constvars) + list(plan.extra_consts)
    eqn = stage.eqn
    operands = (eqn.invars if stage.loop_kind == "scan"
                else eqn.invars[eqn.params["cond_nconsts"]:])
    return frozenset(
        b for b, a in zip(stage.body_plan.jaxpr.jaxpr.invars, operands)
        if any(a is c for c in consts))


def _used_invars(plan, pkg):
    """Which inputs a sub-plan reads: torch hands a while's predicate the
    body's additional inputs too, JAX only what it closes over."""
    if pkg == "torch":
        return [bool(v.users) for v in plan.invars]
    jaxpr = plan.jaxpr.jaxpr
    read = {id(a) for e in jaxpr.eqns for a in e.invars}
    read |= {id(a) for a in jaxpr.outvars}
    return [id(v) in read for v in jaxpr.invars]


def skeleton(plan, pkg, counts=True, top=True, by_elements=False,
             consts=frozenset()):
    """The communication skeleton of a plan of either package: each
    maximal run of communication stages (local stages between runs left
    out) as one block {label: (stages, elements)}, consecutive blocks of
    the same labels merged (a per-leaf reduction with local compute
    between its leaves is one block), loops and conds recursively.
    ``counts=False`` leaves out the stage counts, except in a block with an
    int8-tagged reduction, which keeps its counts and not its elements: it
    moves one packed buffer per dtype in both packages, padded per leaf."""
    blocks, run = [], None
    for s in plan.stages:
        if s.kind in ("BROADCAST", "REDUCE", "TRANSFER"):
            if run is None:
                run = {}
                blocks.append(run)
            label, elems = _label(pkg, s)
            c, e = run.get(label, (0, 0))
            run[label] = (c + 1, e + elems)
            continue
        sub = functools.partial(skeleton, pkg=pkg, counts=counts, top=False,
                                by_elements=by_elements)
        if s.kind == "LOOP":
            run = None
            blocks.append(("LOOP", s.loop_kind, s.trip_count,
                           sub(s.cond_plan) if s.cond_plan is not None
                           and s.cond_plan.stages else None,
                           sub(s.body_plan,
                               consts=_const_binders(plan, s, pkg))))
        elif s.kind == "COND":
            run = None
            blocks.append(("COND", tuple(sub(b) for b in s.branch_plans)))
        elif run is not None:
            run = None
    merged = []
    for b in blocks:
        if (merged and isinstance(b, dict) and isinstance(merged[-1], dict)
                and set(b) == set(merged[-1])):
            for k, (c, e) in b.items():
                c0, e0 = merged[-1][k]
                merged[-1][k] = (c0 + c, e0 + e)
        else:
            merged.append(dict(b) if isinstance(b, dict) else b)

    def entry(b):
        if not isinstance(b, dict):
            return b
        packed = any("[int8]" in k for k in b)
        return tuple(sorted(
            (k, c, e) if counts else (k, c) if packed else (k, e)
            for k, (c, e) in b.items()))

    return (tuple(entry(b) for b in merged),
            _depths(plan, top, by_elements, pkg, consts))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_skeleton_matches_reference(name):
    jfn, jargs, tfn, targs, place = both(name)
    jp, tp = jplan(jfn, place, *jargs), tplan(tfn, place, *targs)
    assert skeleton(tp, "torch") == skeleton(jp, "jax")
    assert tp.communication_stages(recursive=True)
    tp.check_locality()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_run_plan_bitwise_to_direct_and_close_to_reference(name):
    jfn, jargs, tfn, targs, place = both(name)
    gm = interp.trace(tfn, *targs)
    tp = interp.build_plan(gm, place)
    outs = interp.run_plan(tp, *flat(targs))
    assert_bitwise(outs, flat(tfn(*targs)))
    jp = jplan(jfn, place, *jargs)
    want = jdrjax.run_plan(jp, *jax.tree_util.tree_leaves(jargs))
    if name == "quadratic_round":
        got = pytree.tree_unflatten(outs, gm.out_spec)
        want = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jfn(*jargs)), want)
        pairs = [(got[0][k], want[0][k]) for k in ("w", "b")]
        pairs.append((got[2]["loss"], want[2]["loss"]))
    else:
        pairs = list(zip(outs, want))
    assert len(pairs) >= 1
    for g, w in pairs:
        g, w = g.detach().numpy(), np.asarray(w)
        if name == "fused_int8":
            step = np.abs(w).max() / 127.0
            assert np.all(np.abs(g - w) <= step + 1e-6)
        else:
            np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# the shipped rounds at reduced lm_350m
@pytest.mark.parametrize("kind", SHIPPED)
def test_shipped_round_plans(kind, model):
    jp, tp, tr, targs = shipped_plans(kind, model)
    assert_bitwise(interp.run_plan(tp, *flat(targs)), flat(tr(*targs)))
    want = skeleton(jp, "jax", counts=False, by_elements=True)
    got = skeleton(tp, "torch", counts=False, by_elements=True)
    assert got == want


def test_pipelined_round_plan_compiled_bitwise_to_direct(model):
    """The pipelined round of reduced lm_350m's two layers (the shipped
    ``pipeline`` program): its plan is one ``LOOP[scan]`` of M + S - 1
    ticks holding the ``TRANSFER``; ``run_plan`` bitwise the direct round,
    and the compiled plan with the buffer donated bitwise ``run_plan``,
    built once, the buffer updated in place."""
    _, tp, tr, targs = shipped_plans("pipeline", model)
    (loop,) = [s for s in tp.stages if s.kind == "LOOP"]
    assert loop.trip_count == 5
    assert [s.kind for s in loop.body_plan.stages].count("TRANSFER") == 1
    direct = flat(tr(*targs))
    assert_bitwise(interp.run_plan(tp, *flat(targs)), direct)
    compiled = tp.compile(device="cpu", donate_argnums=(1,))
    for _ in range(2):
        mb, act = (t.clone() for t in targs)
        outs = compiled(mb, act)
        assert outs[1] is act
        assert_bitwise(outs, direct)
    assert compiled.trace_count == 1
    assert not compiled.donation_report().errors


def test_hier_round_skeleton_is_the_card_phase_pin(model):
    """chip_smoke's [plan] phase requires its full-size plan to have the
    skeleton pinned in ``chip_smoke.PLAN_SKELETON``: the reduced round's,
    which equals the reference's (``test_shipped_round_plans``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_plan", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, tp, _, _ = shipped_plans("hier_int8", model)
    assert smoke.plan_skeleton(tp) == smoke.PLAN_SKELETON


def test_fedsgd_weight_gradient_program(model):
    """The gradient of FedSGD's loss in its learned weights, traced: the
    weighted means' backward is ``drjax.broadcast``, and ``run_plan`` is
    bitwise the direct gradient."""
    _, _, tr, targs, place = shipped("fedsgd_learned", model)

    def grad_w(params, state, batches, w):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = tr(params, state, batches, w)[2]["loss"]
            return torch.autograd.grad(loss, w)[0]

    tp = tplan(grad_w, place, *targs)
    ops_ = [s.kind for s in tp.communication_stages()]
    assert "BROADCAST" in ops_ and "REDUCE" in ops_
    assert_bitwise(interp.run_plan(tp, *flat(targs)), [grad_w(*targs)])


def test_reduced_round_trace_holds_no_activation_constant(model):
    _, _, tr, targs, place = shipped("hier_int8", model)
    gm = interp.trace(tr, *targs)
    sizes = [getattr(m, n.target).numel()
             for _, m in gm.named_modules() if hasattr(m, "graph")
             for n in m.graph.nodes if n.op == "get_attr"
             and isinstance(getattr(m, n.target), torch.Tensor)]
    assert max(sizes, default=0) < BATCH * SEQ


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------


_GENERATED_NAME = re.compile(
    r"\b(?:t|o|r|bc|g|s|c|lit|x|undef|i|in_)\d+\b"
    r"|\b(?:carry|ys)[\d_]+\b|\bnum_iters_[\w]+\b"
)


def assert_no_undefined_names(beam_text):
    """Every generated identifier in to_beam() is assigned before use (the
    reference test's helper, ``tests/test_interpreter_controlflow.py:53``)."""
    compile(beam_text, "<to_beam>", "exec")
    assert "undef" not in beam_text and "(bug?)" not in beam_text
    defined = set()
    for lineno, line in enumerate(beam_text.splitlines()):
        code = line.split("#")[0]
        m = re.match(r"\s*(?:for\s+(\w+)\s+in\b|([A-Za-z_]\w*)\s*=[^=])", code)
        lhs = (m.group(1) or m.group(2)) if m else None
        for tok_m in _GENERATED_NAME.finditer(code):
            tok = tok_m.group(0)
            if tok == lhs or tok in defined:
                continue
            raise AssertionError(
                f"undefined name {tok!r} used on line {lineno}: {line!r}")
        if lhs:
            defined.add(lhs)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_beam_pipelines_define_every_name(name):
    tfn, targs, place = PROGRAMS[name]("torch")
    plan = tplan(tfn, place, *targs)
    text = plan.to_beam()
    assert_no_undefined_names(text)
    fns = plan.stage_fns()
    for ref in re.findall(r"fns\['([^']+)'\]", text):
        assert ref in fns, f"beam references unknown stage fn {ref!r}"
    refs = {int(i) for i in re.findall(r"consts\[(\d+)\]", text)}
    assert all(r < len(plan.beam_consts()) for r in refs)


def test_beam_text_of_the_shipped_round(model):
    _, plan, _, _ = shipped_plans("hier_int8", model)
    text = plan.to_beam()
    assert_no_undefined_names(text)
    assert "beam.CombinePerKey(_reduce_mean)" in text
    assert "REDUCE_MEAN [int8] clients->pods" in text


def test_text_and_beam_of_maml():
    """``tests/test_interpreter.py::TestEmitters``, and the stage functions
    run: the group stage's callable on the stacked inputs gives the
    program's per-group losses."""
    tfn, targs, place = maml("torch")
    plan = tplan(tfn, place, *targs)
    txt = plan.to_text()
    assert "BROADCAST server->groups" in txt
    assert "REDUCE_MEAN groups->server" in txt
    beam = plan.to_beam()
    assert "range(3)" in beam and "beam.CombineGlobally(_reduce_mean)" in beam
    assert "fns['stage_2']" in beam and "beam.pvalue.AsSingleton" in beam
    fn = plan.stage_fns()["stage_2"]
    ins = {"model": targs[0].expand(3), "lr": targs[1].expand(3),
           "tasks": targs[2]}
    order = [n.name for n in fn.input_vars]
    assert len(order) == 3
    stacked = fn(*[ins[k] for k in ("model", "lr", "tasks")])
    want = tfn(*targs)
    assert torch.equal(stacked[0].sum() * drjax.primitives.reciprocal(3), want)


def test_beam_consts_dedup_and_contract():
    """A constant closed over by a helper used at two call sites (one in a
    loop body) is listed once, and the emitter's indices agree."""
    const = torch.tensor([1.0, 2.0, 3.0])

    def helper(xs):
        return drjax.reduce_sum(xs * const)

    @drjax.program(partition_size=3)
    def g(a, all_b):
        top = helper(drjax.broadcast(a))

        def body(m, b):
            return [m + helper(drjax.broadcast(b)), m]

        return scan_op(body, [top], [all_b], ())[0]

    args = (torch.tensor(1.0), torch.arange(2, dtype=torch.float32))
    plan = tplan(g, 3, *args)
    text = plan.to_beam()
    assert_no_undefined_names(text)
    refs = {int(i) for i in re.findall(r"consts\[(\d+)\]", text)}
    consts = plan.beam_consts()
    assert all(r < len(consts) for r in refs)
    assert len(consts) == 1 and torch.equal(consts[0], const)
    assert_bitwise(interp.run_plan(plan, *args), [g(*args)])


def test_unstageable_comm_fails_loudly():
    """Communication inside a map body (a nested placement's reduction in
    a map over pods) cannot be staged: ``build_plan`` raises instead of
    calling it local compute (the reference's ``:637``)."""
    @drjax.program(placements={"pods": 2, "clients": 3})
    def f(xs):
        return drjax.map_fn(lambda x: x * drjax.reduce_sum(drjax.broadcast(
            x.sum(), placement="pods"), placement="pods"), xs,
            placement="pods")

    gm = interp.trace(f, torch.ones((2, 3)))
    with pytest.raises(AssertionError, match="not representable"):
        interp.build_plan(gm, {"pods": 2, "clients": 3})


def test_literal_src():
    assert eval(interp._literal_src(2.5), {"np": np}) == np.float32(2.5)
    assert eval(interp._literal_src(7), {"np": np}) == 7
    assert eval(interp._literal_src(True), {"np": np}) is True
    src = interp._literal_src(torch.tensor([1.5], dtype=torch.bfloat16))
    assert float(eval(src, {"np": np})[0]) == 1.5


# ---------------------------------------------------------------------------
# kernel ops in traces
# ---------------------------------------------------------------------------


def _kernel_calls():
    x = torch.randn((3, 256))
    q, s = ops.quantize(x)
    a = torch.full((1, 4, 3), 0.5)
    w = torch.full((1, 4, 1, 16), -0.5)
    qkv = torch.randn((1, 8, 2, 16))
    out, out32, lse = ops.flash_attention_fwd(qkv, qkv, qkv)
    dq, delta = ops.flash_attention_bwd_dq(qkv, qkv, qkv, out32, lse, qkv)
    h = ops.lru_scan_fwd(a, a)
    wo, states, _ = ops.wkv6_fwd(w, w, w, w, w[0, 0])
    return {
        "quantize": (ops.quantize, (x,)),
        "dequantize": (ops.dequantize, (q, s)),
        "reduce_compress_roundtrip": (ops.reduce_compress_roundtrip,
                                      (torch.randn((2, 3, 256)),)),
        "reduce_compress": (ops.reduce_compress, (torch.randn((2, 2, 3, 256)),)),
        "dequant_accumulate": (ops.dequant_accumulate,
                               ops.reduce_compress(torch.randn((2, 2, 3, 256)))),
        "flash_attention_fwd": (ops.flash_attention_fwd, (qkv, qkv, qkv)),
        "flash_attention_bwd_dq": (ops.flash_attention_bwd_dq,
                                   (qkv, qkv, qkv, out32, lse, qkv)),
        "flash_attention_bwd_dkdv": (ops.flash_attention_bwd_dkdv,
                                     (qkv, qkv, qkv, lse, delta, qkv)),
        "lru_scan_fwd": (ops.lru_scan_fwd, (a, a)),
        "lru_scan_bwd": (ops.lru_scan_bwd, (a, h, a)),
        "wkv6_fwd": (ops.wkv6_fwd, (w, w, w, w, w[0, 0])),
        "wkv6_bwd": (lambda *t: ops.wkv6_bwd(*t[:5], None, t[5]),
                     (w, w, w, w, w[0, 0], wo)),
    }


@pytest.mark.parametrize("name", [f.__name__ for f in ops.KERNEL_WRAPPERS])
def test_each_kernel_traces_to_one_repro_node(name):
    fn, args = _kernel_calls()[name]
    gm = interp.trace(lambda *a: fn(*a), *args)
    repro = [n for n in gm.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("repro.")]
    assert [str(n.target) for n in repro] == [f"repro.{name}.default"]
    eager = pytree.tree_leaves(fn(*args))
    traced = gm(*[a for a in pytree.tree_leaves(args)
                  if isinstance(a, torch.Tensor)])
    assert_bitwise([t for t in pytree.tree_leaves(traced)
                    if isinstance(t, torch.Tensor)],
                   [t for t in eager if isinstance(t, torch.Tensor)])


def test_gradient_through_a_map_with_an_integer_output():
    """An outer gradient through a recorded map whose body also returns an
    integer leaf (no cotangent): the backward node gets zeros for it, and
    ``run_plan`` is bitwise the direct gradient."""
    @drjax.program(partition_size=3)
    def f(x, ys):
        z, n = drjax.map_fn(
            lambda a, b: ((a - b) ** 2, (b > 0).to(torch.int32)),
            (drjax.broadcast(x), ys))
        return drjax.reduce_sum(z), n

    def g(x, ys):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out, n = f(x, ys)
            return torch.autograd.grad(out, x)[0], n

    args = (torch.tensor(0.5), torch.tensor([1.0, -2.0, 3.0]))
    plan = tplan(g, 3, *args)
    assert [s.kind for s in plan.communication_stages()].count("REDUCE") == 2
    assert_bitwise(interp.run_plan(plan, *args), list(g(*args)))


def test_multi_round_is_one_loop_stage(model):
    """P2: the trainer records one scan node (carry: params and server
    state; xs: the round data; ys: the stacked metrics), planned as one
    LOOP[scan] of trip count 2 whose body is the round's plan."""
    _, tp, _, targs = shipped_plans("multi_round", model)
    (loop,) = tp.stages
    assert (loop.kind, loop.loop_kind, loop.trip_count) == ("LOOP", "scan", 2)
    n_carry = len(flat(targs[:2]))
    assert len(loop.carry) == n_carry and len(loop.xs) == 2
    assert not loop.additional
    assert [s.kind for s in loop.body_plan.communication_stages()][:1] == [
        "BROADCAST"]
    assert tp.outvar_placements[:n_carry] == ((),) * n_carry


def test_multi_round_refuses_a_carry_that_changes():
    """A round whose carried state leaves with another dtype than it came
    in with cannot be one scan node: tracing the trainer raises."""
    def round_fn(p, s, d):
        return p + d.sum(), s.to(torch.float64), {"loss": d.sum()}

    from repro_torch.algorithms import rounds

    trainer = rounds.make_multi_round(round_fn, 2)
    args = (torch.zeros(2), torch.tensor(0, dtype=torch.int32),
            torch.ones(2, 3))
    with pytest.raises(TypeError, match="carry 1 enters as torch.int32"):
        interp.trace(trainer, *args)
