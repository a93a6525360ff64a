"""The port's static plan analyses and lint registry
(``repro_torch/analysis``) against the reference's (``repro/analysis``).

* Parity: every program of ``_torch_programs.PROGRAMS`` and every shipped
  round of ``SHIPPED`` analyzes ``ok`` in both packages, with the same
  multiset of ``(code, severity)`` (the reference's codes the port's
  docstrings declare cannot arise left out of its side; none shows on
  these programs). The communication cost is compared block by block, as
  ``test_torch_plan.py`` compares skeletons: each maximal run of comm
  stages as one block of (kind, op, placement, link, endpoints,
  wire_format, multiplier, counted), with its summed per-endpoint payload.
  Native payloads are equal exactly. In a block with an int8-tagged
  reduction both payloads come from the packed rows: the port's equal
  ``int8_wire_payload`` of its packed rows (and 1024 bytes a row on the
  f32 leg) exactly, and exceed the reference's by at most one row per
  port leaf, the per-leaf padding of the port's one-leaf-per-layer layout
  (``test_torch_plan.py``'s docstring).
* Broken fixtures: ``tests/test_analysis.py``'s ``TestPlacementSafety``,
  ``TestDonation``, ``TestRetrace``, ``TestCommCost``,
  ``TestCrossPodBytesModel`` (but ``tpcomm``, which the port does not
  have), ``TestReportSurface`` and ``TestLints`` on the port's plans: each
  fixture is caught with the reference's code. The donation tests also
  hold the pass's verdict to whether ``compile_plan(..., device="cpu",
  donate_argnums=...)`` raises: the port's executor refuses what the pass
  calls an error, so a donation the reference's XLA would drop with a
  warning (``donation/dropped``) is an error here.
* Stage kinds: ``placement/wrong-kind-comm``, ``placement/transfer-operand``
  and ``placement/local-kind-mismatch`` are ported (no longer in the
  "cannot arise" list). The same ``(code, severity)`` multiset as the
  reference's on pipelined rounds (heterogeneous and uniform stages, 2 and
  3 stages) and on broken fixtures built the same way in both packages: a
  reduce and a transfer whose node addresses the wrong kind of level, a
  transfer whose operand sits at the server, a local stage whose kind was
  flipped; the transfers' comm-cost blocks equal, a ring's included.
"""

import functools
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._higher_order_ops.cond import cond_op  # noqa: E402
from torch._higher_order_ops.scan import scan_op  # noqa: E402
from torch._higher_order_ops.while_loop import while_loop_op  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from _torch_programs import (  # noqa: E402
    PROGRAMS, SHIPPED, both, jdrjax, jnp, jplan, load_model, shipped_plans,
    tplan)
import jax  # noqa: E402
from repro.algorithms import pipeline as jpipeline  # noqa: E402
from repro.analysis import placement_safety as jplacement_safety  # noqa: E402
from repro.core import interpreter as jinterp  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch import compression as tcomp  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    commcost, donation, placement_safety, retrace)
from repro_torch.algorithms import pipeline  # noqa: E402
from repro_torch.analysis.lints import run_lints  # noqa: E402
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = (set(placement_safety.NOT_PORTED) | set(retrace.NOT_PORTED)
              | set(donation.NOT_PORTED))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# parity with the reference's analyses
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _plans(name):
    """(reference plan, port plan, port leaves packed by its int8 reduce)."""
    if name in PROGRAMS:
        jfn, jargs, tfn, targs, place = both(name)
        leaves = len(targs[0]) if name == "fused_int8" else 0
        return jplan(jfn, place, *jargs), tplan(tfn, place, *targs), leaves
    jp, tp, _, targs = _shipped(name)
    return jp, tp, len(targs[0])


@functools.lru_cache(maxsize=None)
def _shipped(name):
    return shipped_plans(name, load_model())


NAMES = sorted(PROGRAMS) + SHIPPED


def _codes(report, drop=()):
    return sorted((f.code, f.severity) for f in report.findings
                  if f.code not in drop)


@pytest.mark.parametrize("name", NAMES)
def test_findings_match_reference(name):
    jp, tp, _ = _plans(name)
    jr, tr = jp.analyze(), tp.analyze()
    assert jr.ok and tr.ok, (str(jr), str(tr))
    assert _codes(tr) == _codes(jr, drop=NOT_PORTED)


_FIELDS = ("kind", "op", "placement", "link", "endpoints", "wire_format",
           "multiplier", "counted")


def cost_blocks(report):
    """Each maximal run of comm stages of one (sub-)plan as a block
    {fields: summed per-endpoint payload}, consecutive blocks of the same
    keys merged (a per-leaf reduction with local compute between its
    leaves is one block)."""
    blocks, prev = [], None
    for c in report.per_stage:
        prefix, idx = c.stage.rsplit("_", 1)
        if prev is None or prev != (prefix, int(idx) - 1):
            blocks.append({})
        prev = (prefix, int(idx))
        key = tuple(getattr(c, f) for f in _FIELDS)
        blocks[-1][key] = blocks[-1].get(key, 0.0) + c.payload_bytes
    merged = []
    for b in blocks:
        if merged and set(b) == set(merged[-1]):
            for k, v in b.items():
                merged[-1][k] += v
        else:
            merged.append(dict(b))
    return merged


def _packed_rows(plan):
    """Rows of 256 the port's int8-tagged reduce packs (from its operand)."""
    stages = {n: s for n, s, _ in plan.named_stages()}
    rows = {s.node.args[0].meta["val"].shape[-2]
            for s in stages.values() if getattr(s, "compress", None)}
    assert len(rows) <= 1
    return rows.pop() if rows else None


@pytest.mark.parametrize("name", NAMES)
def test_comm_cost_matches_reference(name):
    jp, tp, leaves = _plans(name)
    jc, tc = jp.comm_cost(), tp.comm_cost()
    jb, tb = cost_blocks(jc), cost_blocks(tc)
    assert [sorted(b) for b in tb] == [sorted(b) for b in jb]
    rows = _packed_rows(tp)
    for bt, bj in zip(tb, jb):
        if not any(k[5] == "int8+scales" for k in bt):
            assert bt == bj
            continue
        for key, got in bt.items():
            # one packed buffer of `rows` rows: f32 before the int8 reduce,
            # int8 values and one f32 scale a row after it
            per_row = 256 + 4.0 if key[5] == "int8+scales" else 256 * 4.0
            assert got == rows * per_row, (key, got, rows)
            if key[5] == "int8+scales":
                assert got == commcost.int8_wire_payload(rows * 256)
            assert 0 <= got - bj[key] <= leaves * per_row, (key, got, bj[key])
    assert tc.unknown_trips == jc.unknown_trips


# ---------------------------------------------------------------------------
# stage kinds: pipelined rounds and broken fixtures, in both packages
# ---------------------------------------------------------------------------


def test_stage_kind_codes_are_ported():
    for code in ("placement/wrong-kind-comm", "placement/transfer-operand",
                 "placement/local-kind-mismatch"):
        assert code not in NOT_PORTED


def _pipeline_plans(s, m, d, hetero):
    """Both packages' plans of ``tests/test_pipeline.py``'s pipelined round
    (``pipelined_setup``)."""
    def build(mod, to, lib):
        fns = ([(lambda k: (lambda a: a + float(k)))(k) for k in range(s)]
               if hetero else lib.tanh)
        rf = mod.make_pipelined_round(fns, mod.PipelineConfig(s, m))
        mb = np.arange(m * d, dtype=np.float32).reshape(m, d) / (m * d)
        return rf, (to(mb), to(np.zeros((s, d), np.float32)))

    jrf, jargs = build(jpipeline, jnp.asarray, jnp)
    trf, targs = build(pipeline, lambda a: torch.from_numpy(a.copy()), torch)
    jp = jdrjax.build_plan(jax.make_jaxpr(jrf)(*jargs), jrf.drjax_context,
                           partitioned_invars=(0, 1))
    tp = interp.build_plan(interp.trace(trf, *targs), trf.drjax_context,
                           partitioned_invars=(0, 1))
    return jp, tp


PIPELINES = {"hetero_3x5": (3, 5, 4, True), "hetero_2x4": (2, 4, 8, True),
             "tanh_3x5": (3, 5, 4, False)}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_findings_and_cost_match_reference(name):
    jp, tp = _pipeline_plans(*PIPELINES[name])
    jr, tr = jp.analyze(), tp.analyze()
    assert jr.ok and tr.ok, (str(jr), str(tr))
    assert _codes(tr) == _codes(jr, drop=NOT_PORTED)
    jb, tb = cost_blocks(jp.comm_cost()), cost_blocks(tp.comm_cost())
    assert tb == jb and any(k[0] == "TRANSFER" for b in tb for k in b)
    assert tp.comm_cost().ici_bytes == jp.comm_cost().ici_bytes


def _kind_fixture(mutation):
    """One broken plan per package, built and edited the same way."""
    if mutation == "reduce_at_stage_level":
        def prog(mod, lib_x):
            @mod.program(partition_size=4)
            def f(x):
                return mod.reduce_sum(x)
            return f, (lib_x(np.ones((4, 2), np.float32)),)
    elif mutation in ("transfer_at_replica_level", "transfer_operand_at_server",
                      "ring_transfer"):
        def prog(mod, lib_x):
            @mod.program(placements={"stages": 4},
                         placement_kinds={"stages": "stages"})
            def f(x):
                return mod.stage_transfer(x, wrap=mutation == "ring_transfer")
            return f, (lib_x(np.ones((4, 1, 8), np.float32)),)
    else:  # flipped_local_stage
        def prog(mod, lib_x):
            @mod.program(partition_size=4)
            def f(x, xs):
                return mod.reduce_mean(mod.map_fn(
                    lambda a, b: a * b, (mod.broadcast(x), xs)))
            return f, (lib_x(np.float32(2.0)),
                       lib_x(np.arange(4, dtype=np.float32)))

    depths = (0,) if mutation == "transfer_operand_at_server" else None
    jf, jargs = prog(jdrjax, jnp.asarray)
    tf, targs = prog(drjax, lambda a: torch.tensor(np.asarray(a)))
    jp = jdrjax.build_plan(jax.make_jaxpr(jf)(*jargs), jf.drjax_context,
                           partitioned_invars=depths)
    tp = interp.build_plan(interp.trace(tf, *targs), tf.drjax_context,
                           partitioned_invars=depths)
    if mutation == "reduce_at_stage_level":
        (js,) = [s for s in jp.stages if s.kind == "REDUCE"]
        js.eqn.params["pctx"] = jplacement.make_context(
            None, placements={"clients": 4},
            placement_kinds={"clients": "stages"})
        (ts,) = [s for s in tp.stages if s.kind == "REDUCE"]
        ts.node.args = (ts.node.args[0], "clients:4:stages") + ts.node.args[2:]
    elif mutation == "transfer_at_replica_level":
        (js,) = [s for s in jp.stages if s.kind == "TRANSFER"]
        js.eqn.params["pctx"] = jplacement.make_context(
            None, placements={"stages": 4})
        (ts,) = [s for s in tp.stages if s.kind == "TRANSFER"]
        ts.node.args = (ts.node.args[0], "stages:4") + ts.node.args[2:]
    elif mutation == "flipped_local_stage":
        for plan in (jp, tp):
            (st,) = [s for s in plan.stages if s.kind == "GROUP_COMPUTE"]
            st.at_groups = False
    return jp, tp


KIND_FIXTURES = {
    "reduce_at_stage_level": "placement/wrong-kind-comm",
    "transfer_at_replica_level": "placement/wrong-kind-comm",
    "transfer_operand_at_server": "placement/transfer-operand",
    "flipped_local_stage": "placement/local-kind-mismatch",
    "ring_transfer": None,
}


@pytest.mark.parametrize("mutation", sorted(KIND_FIXTURES))
def test_kind_fixtures_match_reference(mutation):
    jp, tp = _kind_fixture(mutation)
    want = sorted((f.code, f.severity)
                  for f in jplacement_safety.check_placement_safety(jp))
    got = sorted((f.code, f.severity)
                 for f in placement_safety.check_placement_safety(tp))
    assert got == want
    code = KIND_FIXTURES[mutation]
    assert (code is None) == (not got)
    if code is not None:
        assert code in {c for c, _ in got}
    if mutation in ("ring_transfer", "transfer_operand_at_server"):
        jb = cost_blocks(jp.comm_cost())
        assert cost_blocks(tp.comm_cost()) == jb
    if mutation == "ring_transfer":
        (c,) = tp.comm_cost().per_stage
        assert c.endpoints == 4  # a ring: no idle boundary stage


def test_transfer_cross_validated():
    """The transfers of a pipelined plan carry what the model prices: one
    sender of 32 bytes (2 stages, shift 1) a tick, five ticks; a ring's
    four senders."""
    _, tp = _pipeline_plans(2, 4, 8, True)
    args = [torch.arange(32.0).reshape(4, 8), torch.zeros(2, 8)]
    assert analysis.cross_validate_comm_cost(tp, args, device="cpu") == []
    assert analysis.cross_validate_comm_cost(tp, args, device="cpu",
                                             model_scale=1.5)
    _, ring = _kind_fixture("ring_transfer")
    assert analysis.cross_validate_comm_cost(ring, device="cpu") == []


# ---------------------------------------------------------------------------
# fixture programs (``tests/test_analysis.py``'s zoo, in torch)
# ---------------------------------------------------------------------------


def flat_plan(n=8, d=None):
    @drjax.program(partition_size=n)
    def f(x, xs):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a, b: a * b, (y, xs))
        return drjax.reduce_mean(z)

    args = (torch.tensor(1.0), torch.zeros((n,) if d is None else (n, d)))
    return tplan(f, n, *args), args


def nested_plan(P=2, m=4):
    @drjax.program(placements={"pods": P, "clients": m})
    def f(x, data):
        y = drjax.broadcast(x)
        z = drjax.map_fn(lambda a, b: a * b, (y, data))
        partial = drjax.reduce_mean(z, placement="clients")
        return drjax.reduce_mean(partial, placement="pods")

    args = (torch.tensor(2.0), torch.zeros((P, m)))
    return tplan(f, {"pods": P, "clients": m}, *args), args


def _scan_body(m, t, ys):
    g = drjax.reduce_mean(drjax.map_fn(
        lambda a, b: a - b, (drjax.broadcast(m), ys)))
    return [m - 0.5 * g, g]


def scan_round_plan(n=4, length=3):
    @drjax.program(partition_size=n)
    def f(m, ys):
        return scan_op(_scan_body, [m], [torch.zeros(length)], (ys,))

    args = (torch.tensor(0.3), torch.arange(float(n)))
    return tplan(f, n, *args), args


def while_pred_comm_plan(n=4):
    """A data-dependent while whose PREDICATE reduces."""
    @drjax.program(partition_size=n)
    def f(x, xs):
        def cond_fn(c, xs):
            s = drjax.reduce_mean(drjax.map_fn(
                lambda a, b: a + b, (drjax.broadcast(c), xs)))
            return s < 10.0

        return while_loop_op(cond_fn, lambda c, xs: (c + 1.0,), (x,),
                             (xs,))[0]

    args = (torch.tensor(0.0), torch.arange(float(n)))
    return tplan(f, n, *args), args


def _talk(x, xs):
    return (drjax.reduce_mean(drjax.map_fn(
        lambda a, b: a * b, (drjax.broadcast(x), xs))),)


def cond_comm_plan(n=4):
    @drjax.program(partition_size=n)
    def f(p, x, xs):
        return cond_op(p, _talk, lambda x, xs: (x * 2.0,), (x, xs))[0]

    args = (torch.tensor(True), torch.tensor(1.0), torch.arange(float(n)))
    return tplan(f, n, *args), args


def scan_of_cond_plan(n=4, length=5):
    """Communication inside a cond branch inside a loop."""
    @drjax.program(partition_size=n)
    def f(m, ys):
        def body(m, i, ys):
            return [cond_op(i % 2 == 0, _talk, lambda m, ys: (m.clone(),),
                            (m, ys))[0]]

        return scan_op(body, [m], [torch.arange(length)], (ys,))[0]

    args = (torch.tensor(0.0), torch.arange(float(n)))
    return tplan(f, n, *args), args


def fused_hier_plan(n=8, P=2, d=512):
    @drjax.program(partition_size=n)
    def f(xs):
        return drjax.hierarchical_reduce_mean(
            xs, num_supergroups=P, compress_fn=tcomp.int8_roundtrip)

    args = (torch.zeros((n, d)),)
    return tplan(f, n, *args), args


FIXTURES = {
    "flat": flat_plan,
    "nested": nested_plan,
    "scan_round": scan_round_plan,
    "while_pred_comm": while_pred_comm_plan,
    "cond_comm": cond_comm_plan,
    "scan_of_cond": scan_of_cond_plan,
    "fused_hier": fused_hier_plan,
}


class TestFixturesClean:
    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_analyze_ok(self, name):
        plan, _ = FIXTURES[name]()
        report = plan.analyze()
        assert report.ok, f"{name}: {report}"
        report.raise_if_errors()  # a no-op when ok

    def test_fused_hier_regroup_is_info_not_error(self):
        plan, _ = fused_hier_plan()
        infos = plan.analyze().by_code("placement/regroup-boundary")
        assert len(infos) == 1 and infos[0].severity == "info"

    def test_subplans_iterates_nested(self):
        plan, _ = scan_of_cond_plan()
        plans = plan.subplans()
        assert plans[0] is plan and len(plans) >= 3


# ---------------------------------------------------------------------------
# placement safety: broken fixtures
# ---------------------------------------------------------------------------


class TestPlacementSafety:
    def _comm_in_local_mutant(self):
        plan, _ = cond_comm_plan()
        cond = next(s for s in plan.stages
                    if isinstance(s, interp.CondStage))
        bp = next(b for b in cond.branch_plans
                  if any(isinstance(s, interp.Reduce) for s in b.stages))
        ri = next(i for i, s in enumerate(bp.stages)
                  if isinstance(s, interp.Reduce))
        bp.stages[ri] = interp.LocalCompute(at_groups=True,
                                            nodes=[bp.stages[ri].node])
        return plan

    def test_comm_inside_local_via_cond_branch(self):
        plan = self._comm_in_local_mutant()
        errs = [f for f in analysis.check_placement_safety(plan)
                if f.code == "placement/comm-in-local"]
        assert len(errs) == 1 and "_b" in errs[0].stage
        with pytest.raises(AssertionError):
            plan.check_locality()  # the structural checker agrees

    def test_comm_in_local_fails_analyze_and_raises(self):
        report = self._comm_in_local_mutant().analyze(comm_cost=False)
        assert not report.ok
        with pytest.raises(AssertionError, match="comm-in-local"):
            report.raise_if_errors()

    def test_broken_pairing_detected(self):
        plan, _ = nested_plan()
        stage = next(s for s in plan.stages
                     if isinstance(s, interp.Broadcast))
        stage.source = "clients"  # the outermost broadcast sources "server"
        assert any(f.code == "placement/pairing"
                   for f in analysis.check_placement_safety(plan))

    def test_unstable_loop_carry_detected(self):
        plan, _ = scan_round_plan()
        body = plan.stages[-1].body_plan
        body.outvar_placements = (("clients",),) + body.outvar_placements[1:]
        errs = [f for f in analysis.check_placement_safety(plan)
                if f.code == "placement/loop-carry-unstable"]
        assert len(errs) == 1 and errs[0].severity == "error"

    def test_clean_plans_have_no_placement_findings(self):
        for maker in (flat_plan, nested_plan, scan_round_plan):
            plan, _ = maker()
            assert analysis.check_placement_safety(plan) == []


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def _compile_raises(plan, args, donate) -> bool:
    try:
        plan.compile(device="cpu", donate_argnums=donate)(
            *[a.clone() for a in args])
    except ValueError:
        return True
    return False


def _agrees(plan, args, donate):
    """The pass's verdict is what the executor does."""
    report = analysis.AnalysisReport(
        findings=analysis.analyze_donation(plan, donate))
    assert _compile_raises(plan, args, donate) == (not report.ok)
    return report


class TestDonation:
    def test_round_style_donation_clean(self):
        @drjax.program(partition_size=4)
        def f(params, xs):
            z = drjax.map_fn(lambda a, b: a + b,
                             (drjax.broadcast(params), xs))
            return params + drjax.reduce_mean(z)

        args = (torch.arange(3.0), torch.zeros((4, 3)))
        plan = tplan(f, 4, *args)
        assert plan.analyze(donate_argnums=(0,)).ok
        assert _agrees(plan, args, (0,)).ok

    def test_use_after_donate_fixture(self):
        """Donating x, whose output is defined before x's last read: the
        reference reports ``donation/use-after-donate`` (stage_2 reads x
        after stage_0 defined its alias); the port's executor writes x
        only after the last stage, so the pass declares the code cannot
        arise, finds nothing, and the donated call is bitwise
        ``run_plan``: the late read sees x's old value."""
        def program(lib):
            @lib.program(partition_size=4)
            def f(x, ys):
                a = x + 1.0
                s = lib.reduce_mean(ys)
                return a, x * s
            return f

        jr = jplan(program(jdrjax), 4, jnp.arange(3.0),
                   jnp.arange(4.0)).analyze(donate_argnums=(0,))
        assert [f.code for f in jr.errors] == ["donation/use-after-donate"]
        assert "donation/use-after-donate" in donation.NOT_PORTED
        args = (torch.arange(3.0), torch.arange(4.0))
        plan = tplan(program(drjax), 4, *args)
        report = plan.analyze(donate_argnums=(0,))
        assert report.ok and not report.findings
        _agrees(plan, args, (0,))
        want = interp.run_plan(plan, *args)
        x = args[0].clone()
        outs = plan.compile(device="cpu", donate_argnums=(0,))(x, args[1])
        assert outs[0] is x
        assert all(torch.equal(o, w) for o, w in zip(outs, want))

    def test_dropped_donation_explains_why(self):
        """Output 0 is a scalar, argument 0 a vector: the reference's XLA
        drops the donation with a warning, the port's executor refuses it
        (an error, with the outputs listed)."""
        @drjax.program(partition_size=4)
        def f(big, xs):
            return drjax.reduce_mean(xs) + big.sum()

        args = (torch.arange(3.0), torch.arange(4.0))
        plan = tplan(f, 4, *args)
        (found,) = plan.analyze(donate_argnums=(0,)).by_code(
            "donation/dropped")
        assert found.severity == "error" and "f32[3]" in found.message
        _agrees(plan, args, (0,))

    def test_unused_donation_is_a_warning(self):
        @drjax.program(partition_size=4)
        def f(spare, xs):
            return torch.zeros(3), drjax.reduce_mean(xs)

        args = (torch.arange(3.0), torch.arange(4.0))
        plan = tplan(f, 4, *args)
        report = plan.analyze(donate_argnums=(0,))
        assert report.ok and report.by_code("donation/unused")
        _agrees(plan, args, (0,))

    def test_carry_not_eligible_when_init_escapes(self):
        """A loop carry whose init is also a plan output cannot be updated
        in place."""
        @drjax.program(partition_size=4)
        def f(m, ys):
            out = scan_op(_scan_body, [m], [torch.zeros(2)], (ys,))[0]
            return out, m

        args = (torch.tensor(0.3), torch.arange(4.0))
        plan = tplan(f, 4, *args)
        assert any(f.code == "donation/carry-not-eligible"
                   for f in analysis.analyze_donation(plan))

    def test_compiled_plan_donation_report(self):
        plan, args = scan_round_plan()
        compiled = plan.compile(device="cpu", donate_argnums=(0,))
        assert compiled.donation_report().ok
        _agrees(plan, args, (0,))

    def test_bad_argnum_is_error(self):
        plan, args = flat_plan()
        assert plan.analyze(donate_argnums=(17,)).by_code(
            "donation/bad-argnum")
        _agrees(plan, args, (17,))

    def test_multi_round_carry_donation_clean(self):
        """The shipped trainer's plan (one LOOP stage) with its carry
        donated: no finding, and the compiled plan runs."""
        _, tp, _ = _plans("multi_round")
        n_carry = len(tp.invars) - 2  # params, server state; then the data
        assert not analysis.analyze_donation(tp, range(n_carry))


# ---------------------------------------------------------------------------
# retrace hazards and fingerprint explanation
# ---------------------------------------------------------------------------


def _captured_scalar_plan(value):
    c = torch.tensor([value])  # closed over: a captured constant

    @drjax.program(partition_size=4)
    def f(xs):
        z = drjax.map_fn(lambda a: a * 2.0, xs)
        return drjax.reduce_mean(z) * c[0]

    return tplan(f, 4, torch.arange(4.0))


def _literal_plan(value):
    @drjax.program(partition_size=4)
    def f(xs):
        return drjax.reduce_mean(xs) * value  # a number in the code

    return tplan(f, 4, torch.arange(4.0))


class TestRetrace:
    def test_unstable_const_flagged(self):
        warns = [f for f in analysis.analyze_retrace(_captured_scalar_plan(0.1))
                 if f.code == "retrace/unstable-const"]
        assert len(warns) == 1 and "plan input" in warns[0].message

    def test_literals_are_not_flagged(self):
        assert analysis.analyze_retrace(_literal_plan(0.5)) == []

    def test_large_const_is_info(self):
        big = torch.ones((1 << 18) + 1)

        @drjax.program(partition_size=4)
        def f(xs):
            return drjax.reduce_sum(xs) + big.sum()

        (found,) = analysis.analyze_retrace(tplan(f, 4, torch.arange(4.0)))
        assert found.code == "retrace/large-const"
        assert found.severity == "info"

    def test_explain_fingerprint_mismatch_pinpoints_const(self):
        pa, pb = _captured_scalar_plan(0.1), _captured_scalar_plan(0.2)
        assert executor.plan_fingerprint(pa) != executor.plan_fingerprint(pb)
        diffs = analysis.explain_fingerprint_mismatch(pa, pb)
        assert len(diffs) == 1
        assert "const[0]" in diffs[0] and "VALUE differs" in diffs[0]
        assert analysis.explain_fingerprint_mismatch(
            pa, _captured_scalar_plan(0.1)) == []

    def test_explain_names_a_changed_number_in_the_code(self):
        pa, pb = _literal_plan(0.25), _literal_plan(0.5)
        (diff,) = analysis.explain_fingerprint_mismatch(pa, pb)
        assert diff.startswith("component 'graph' differs")
        assert "0.25" in diff and "0.5" in diff

    def test_no_mesh_keyed_leg_without_a_mesh(self):
        """A donated plan over two replica levels is keyed by a mesh that
        an elastic event resizes: the reference's warning, with its
        severity; without a donation, or over one level, none."""
        plan, _ = nested_plan()
        (found,) = plan.analyze(donate_argnums=(0,)).by_code(
            "retrace/mesh-keyed-leg")
        assert found.severity == "warning" and "2 replica" in found.message
        assert not plan.analyze().by_code("retrace/mesh-keyed-leg")
        for name in ("nested_2x4", "quadratic_round"):
            jp, tp, _ = _plans(name)
            want = [(f.code, f.severity) for f in jp.analyze(
                donate_argnums=(0,)).findings
                if f.code == "retrace/mesh-keyed-leg"]
            got = [(f.code, f.severity) for f in tp.analyze(
                donate_argnums=(0,)).by_code("retrace/mesh-keyed-leg")]
            assert got == want and bool(got) == (name == "nested_2x4")

    def test_fingerprint_parts_define_the_fingerprint(self):
        plan, _ = scan_round_plan()
        h = hashlib.sha1()
        for _name, data in executor.fingerprint_parts(plan):
            h.update(data)
        assert h.hexdigest() == executor.plan_fingerprint(plan)
        names = [n for n, _ in executor.fingerprint_parts(plan)]
        assert names[:5] == ["placements", "partitioned_invars",
                             "partitioned_outvars", "graph",
                             "stage_skeleton"]


# ---------------------------------------------------------------------------
# communication cost
# ---------------------------------------------------------------------------


class TestCommCost:
    def test_flat_reduce_is_all_dcn(self):
        n, d = 8, 16
        cost = flat_plan(n, d)[0].comm_cost()
        assert cost.dcn_bytes == n * 4 + n * d * 4
        assert cost.ici_bytes == 0.0

    def test_nested_splits_dcn_ici(self):
        P, m = 2, 4
        cost = nested_plan(P, m)[0].comm_cost()
        assert cost.dcn_bytes == P * 4 + P * 4
        assert cost.ici_bytes == P * m * 4 + P * m * 4

    def test_loop_multiplies_trip_count(self):
        cost = scan_round_plan(n=4, length=3)[0].comm_cost()
        assert cost.dcn_bytes == 3 * (4 * 4 + 4 * 4)
        assert all(c.multiplier == 3.0 for c in cost.per_stage)

    def test_while_flags_unknown_trips(self):
        cost = while_pred_comm_plan()[0].comm_cost()
        assert cost.unknown_trips
        assert any(f.code == "commcost/unknown-trip" for f in cost.findings)
        assert any("_c_" in c.stage for c in cost.per_stage)

    def test_cond_counts_max_branch(self):
        cost = cond_comm_plan()[0].comm_cost()
        assert cost.total_bytes > 0
        assert all(c.counted for c in cost.per_stage)

    def test_fused_int8_wire_format(self):
        n, P, d = 8, 2, 512
        cost = fused_hier_plan(n, P, d)[0].comm_cost()
        (c,) = [c for c in cost.per_stage if c.link == "dcn"]
        assert c.wire_format == "int8+scales"
        assert c.wire_bytes == P * (d * 1.0 + (d // tcomp.PACK_COLS) * 4.0)

    def test_int8_wire_payload_is_the_packed_format(self):
        """The model's bytes are those of the rows the int8 kernels ship:
        int8 values and one f32 scale per ``PACK_COLS`` values."""
        from repro_torch.kernels import ops

        rows = 3
        q, s = ops.quantize(torch.randn(rows, tcomp.PACK_COLS))
        payload = q.numel() * q.element_size() + s.numel() * s.element_size()
        assert commcost.INT8_BLOCK == tcomp.PACK_COLS
        assert commcost.int8_wire_payload(rows * tcomp.PACK_COLS) == payload

    def test_cross_validate_clean_on_cpu(self):
        plan, _ = flat_plan(8, 32)
        findings = analysis.cross_validate_comm_cost(plan, device="cpu")
        assert findings == [], [str(f) for f in findings]

    def test_cross_validate_catches_skewed_model(self):
        """Every comm stage (the broadcast and the reduce) is measured."""
        plan, _ = flat_plan(8, 32)
        findings = analysis.cross_validate_comm_cost(plan, device="cpu",
                                                     model_scale=1.1)
        errs = [f for f in findings if f.code == "commcost/model-mismatch"]
        assert len(errs) == 2 and all(f.severity == "error" for f in errs)
        assert {f.stage for f in errs} == {
            c.stage for c in plan.comm_cost().per_stage}

    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_cross_validate_clean_on_every_fixture(self, name):
        """Loops run their trip count, a cond's branches at most theirs, a
        while any number; the int8 stage's bytes are K1a's packed rows."""
        plan, args = FIXTURES[name]()
        findings = analysis.cross_validate_comm_cost(plan, args,
                                                     device="cpu")
        assert findings == [], [str(f) for f in findings]

    @pytest.mark.parametrize("name", SHIPPED)
    def test_cross_validate_clean_on_shipped_rounds(self, name):
        """Each shipped round at reduced lm_350m, run once on its inputs:
        every comm stage carried what the model prices (hier_int8's DCN
        stage in K1a's packed rows, multi_round's stages twice)."""
        _, tp, _, targs = _shipped(name)
        findings = analysis.cross_validate_comm_cost(
            tp, pytree.tree_leaves(targs), device="cpu")
        assert findings == [], [str(f) for f in findings]

    def test_cross_validate_catches_unpriced_scales(self, monkeypatch):
        """A model that forgets the int8 rows' f32 scales is caught on the
        DCN stage, where K1a's packed rows carry them."""
        plan, args = fused_hier_plan(8, 2, 512)
        monkeypatch.setattr(commcost, "int8_wire_payload",
                            lambda values, block=256: values * 1.0)
        (err,) = analysis.cross_validate_comm_cost(plan, args, device="cpu")
        assert err.code == "commcost/model-mismatch"
        assert "int8+scales" in err.message

    def test_cross_validate_catches_a_wrong_trip_multiplier(self,
                                                            monkeypatch):
        plan, args = scan_round_plan(n=4, length=3)
        real = commcost.estimate_comm_cost

        def skewed(p):
            cost = real(p)
            for c in cost.per_stage:
                c.multiplier += 1.0
            return cost

        monkeypatch.setattr(commcost, "estimate_comm_cost", skewed)
        errs = analysis.cross_validate_comm_cost(plan, args, device="cpu")
        assert len(errs) == len(real(plan).per_stage)
        assert all("ran 3 times, modeled 4" in f.message for f in errs)

    def test_cross_validate_needs_args_for_a_while(self):
        plan, _ = while_pred_comm_plan()
        with pytest.raises(ValueError, match="while loop needs its args"):
            analysis.cross_validate_comm_cost(plan, device="cpu")

    def test_analyze_cross_validates_on_request(self):
        plan, _ = nested_plan()
        report = plan.analyze(cross_validate=True, device="cpu")
        assert report.ok and not report.findings

    def test_scan_of_cond_multiplied_and_counted(self):
        cost = scan_of_cond_plan(n=4, length=5)[0].comm_cost()
        counted = [c for c in cost.per_stage if c.counted]
        assert counted and all(c.multiplier == 5.0 for c in counted)
        assert all("_b" in c.stage for c in counted)


class TestCrossPodBytesModel:
    def test_napkin_matches_analyzer_exactly(self):
        n, P, d = 8, 2, 512
        static_dcn = fused_hier_plan(n, P, d)[0].comm_cost().dcn_bytes
        napkin = drjax.cross_pod_bytes(4.0 * d, n=n, num_supergroups=P,
                                       compress="int8")
        assert napkin["hierarchical_bytes"] == static_dcn

    def test_int8_ratio_includes_scale_overhead(self):
        assert drjax.int8_wire_ratio() == (1.0 + 4.0 / tcomp.PACK_COLS) / 4.0
        assert drjax.int8_wire_ratio() > 0.25

    def test_compress_ratio_still_supported(self):
        a = drjax.cross_pod_bytes(1024.0, n=64, num_supergroups=4,
                                  compress_ratio=0.5)
        assert a["hierarchical_bytes"] == 4 * 1024.0 * 0.5

    def test_unknown_scheme_raises(self):
        with pytest.raises(ValueError, match="unknown compress scheme"):
            drjax.cross_pod_bytes(1.0, n=2, num_supergroups=1,
                                  compress="fp4")


class TestReportSurface:
    def test_to_json_roundtrip(self):
        report = fused_hier_plan()[0].analyze()
        blob = json.loads(report.to_json())
        assert blob["ok"] is True
        assert blob["comm_cost"]["dcn_bytes"] == report.comm_cost.dcn_bytes
        assert [f["code"] for f in blob["findings"]] == [
            "placement/regroup-boundary"]

    def test_warnings_do_not_flip_ok(self):
        report = _captured_scalar_plan(0.5).analyze()
        assert report.ok and report.warnings


# ---------------------------------------------------------------------------
# the port's lint registry
# ---------------------------------------------------------------------------


def _write(root, rel, content):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(textwrap.dedent(content))


class TestLints:
    def test_repo_is_clean(self):
        assert run_lints() == []

    def test_unknown_rule_raises(self):
        with pytest.raises(KeyError, match="no-such-rule"):
            run_lints(rules=["no-such-rule"])

    def test_no_reference_import_rule(self, tmp_path):
        root = str(tmp_path)
        _write(root, "src/repro_torch/core/bad.py", "import jax.numpy as jnp\n")
        _write(root, "src/repro_torch/core/ok.py", "from . import api\n")
        _write(root, "chip_smoke.py", "from repro.core import api\n")
        _write(root, "tests/test_x.py", "import jax\n")  # tests may
        vs = run_lints(root=root, rules=["no-reference-import"])
        assert sorted((v.path, v.line) for v in vs) == [
            ("chip_smoke.py", 1), ("src/repro_torch/core/bad.py", 1)]

    def test_no_try_in_kernels_rule(self, tmp_path):
        root = str(tmp_path)
        _write(root, "src/repro_torch/kernels/bad.py", """\
            def launch():
                try:
                    build()
                except OSError:
                    plain()
        """)
        _write(root, "src/repro_torch/launch/ok.py", """\
            try:
                import resource
            except ImportError:
                resource = None
        """)
        vs = run_lints(root=root, rules=["no-try-in-kernels"])
        assert [(v.path, v.line) for v in vs] == [
            ("src/repro_torch/kernels/bad.py", 2)]

    def test_no_torch_compile_rule(self, tmp_path):
        root = str(tmp_path)
        _write(root, "src/repro_torch/models/bad.py", """\
            import torch
            fast = torch.compile(lambda x: x)
        """)
        _write(root, "chip_smoke.py", """\
            import re
            pattern = re.compile("x")
        """)
        vs = run_lints(root=root, rules=["no-torch-compile"])
        assert [(v.path, v.line) for v in vs] == [
            ("src/repro_torch/models/bad.py", 2)]

    def test_suppression_marker(self, tmp_path):
        root = str(tmp_path)
        _write(root, "src/repro_torch/models/bad.py", """\
            import torch
            # lint: disable=no-torch-compile
            fast = torch.compile(lambda x: x)
        """)
        assert run_lints(root=root, rules=["no-torch-compile"]) == []

    def test_cli_json_output(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lints", "--json"],
            capture_output=True, text=True, check=True, env=env)
        report = json.loads(out.stdout)
        assert report["ok"] and report["violations"] == []
        assert set(report["rules"]) == {"no-reference-import",
                                        "no-try-in-kernels",
                                        "no-torch-compile",
                                        "mesh-axes-literal"}

    def test_lints_importable_without_torch(self):
        code = ("import sys; sys.path.insert(0, 'src');"
                "from repro_torch.analysis import lints;"
                "assert 'torch' not in sys.modules, 'lints loaded torch'")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)

    def test_reference_registry_stays_clean(self):
        """The reference's registry scans all of src/, this package too."""
        from repro.analysis.lints import run_lints as reference_lints

        assert reference_lints() == []
