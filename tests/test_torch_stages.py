"""Pipeline-stage placements of the port against the reference
(``tests/test_pipeline.py``): placement kinds, ``stage_transfer`` and
``stage_map``, the wrong-kind refusals, the 1F1B pipelined round with its
plan (a ``TRANSFER`` inside a ``LOOP[scan]``), compiled plan and donation,
and the analyses' pricing and findings of transfers.

Each case runs the same numpy inputs through both packages, the reference
un-jitted (a ``jax.jit``-wrapped program fails to plan on the installed
JAX, ROADMAP R1). Primitives and pipelined outputs are held bitwise where
the reference asserts ``assert_array_equal``, else within 1e-6; the
transpose of a transfer through ``torch.autograd.grad`` (direct and
recorded) and ``torch.func.vjp``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jdrjax  # noqa: E402
from repro.algorithms import pipeline as jpipeline  # noqa: E402
from repro.core import interpreter as jinterp  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.algorithms import (  # noqa: E402
    PipelineConfig, make_pipelined_round, pipeline_bubble_fraction)
from repro_torch.algorithms import pipeline as tpipeline  # noqa: E402
from repro_torch.analysis import commcost, placement_safety  # noqa: E402
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.core import placement as placement_lib  # noqa: E402
from repro_torch.core import primitives as prims  # noqa: E402
from repro_torch.runtime.executor import compile_plan  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def stage_ctx(lib, num_stages=3, clients=4):
    return lib.make_context(None, placements={"stages": num_stages,
                                              "clients": clients},
                            placement_kinds={"stages": "stages"})


def _eq(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(fn, *arrays, num_stages=3, clients=4):
    """``fn(mod, *inputs)`` under the stage context of each package."""
    with jdrjax.placement_context(stage_ctx(jplacement, num_stages, clients)):
        want = fn(jdrjax, *(jnp.asarray(a) for a in arrays))
    with drjax.placement_context(stage_ctx(placement_lib, num_stages,
                                           clients)):
        got = fn(drjax, *(torch.from_numpy(np.array(a)) for a in arrays))
    return got, want


X12 = np.arange(12, dtype=np.float32).reshape(3, 4)


# ---------------------------------------------------------------------------
# placement kinds
# ---------------------------------------------------------------------------


class TestPlacementKinds:
    def test_default_kind_is_replicas(self):
        for lib in (jplacement, placement_lib):
            ctx = lib.make_context(None, placements={"clients": 4})
            assert ctx.kinds == ("replicas",)
            assert ctx.stage_names() == ()

    def test_stage_kind_recorded(self):
        for lib in (jplacement, placement_lib):
            ctx = stage_ctx(lib)
            assert ctx.kinds == ("stages", "replicas")
            assert ctx.stage_names() == ("stages",)

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="kind"):
            placement_lib.Placement("p", 2, kind="banana")
        with pytest.raises(ValueError, match="kind"):
            jplacement.Placement("p", 2, None, kind="banana")

    def test_unknown_placement_name_in_kinds_rejected(self):
        for lib in (jplacement, placement_lib):
            with pytest.raises(ValueError, match="unknown placements"):
                lib.make_context(None, placements={"clients": 4},
                                 placement_kinds={"nope": "stages"})

    def test_program_declares_kinds(self):
        @drjax.program(placements={"stages": 2, "clients": 3},
                       placement_kinds={"stages": "stages"})
        def f(x):
            return x

        assert f.drjax_context.kinds == ("stages", "replicas")
        assert prims.stack_spec(f.drjax_context) == "stages:2:stages,clients:3"


# ---------------------------------------------------------------------------
# stage_transfer
# ---------------------------------------------------------------------------


class TestStageTransfer:
    @pytest.mark.parametrize("kw", [{}, {"shift": -1}, {"wrap": True},
                                    {"shift": 5}, {"shift": 2, "wrap": True},
                                    {"shift": -4, "wrap": True}])
    def test_matches_reference(self, kw):
        got, want = _both(lambda mod, x: mod.stage_transfer(x, **kw), X12)
        _eq(got, want)
        with drjax.placement_context(stage_ctx(placement_lib)):
            with prims.recording():
                _eq(drjax.stage_transfer(torch.from_numpy(X12), **kw), want)

    def test_forward_shift_zero_fills_entry(self):
        got, _ = _both(lambda mod, x: mod.stage_transfer(x), X12)
        _eq(got[0], np.zeros(4, np.float32))
        _eq(got[1:], X12[:2])

    def test_oversized_shift_zeroes_everything(self):
        got, _ = _both(lambda mod, x: mod.stage_transfer(x, shift=5),
                       np.ones((3, 4), np.float32))
        _eq(got, np.zeros((3, 4), np.float32))

    def test_transpose_is_reverse_transfer(self):
        """grad of sum(transfer(x)^2) is transfer(2 transfer(x), -1), as
        the reference's; through autograd of the direct ops, of the
        recorded op, and through ``torch.func.vjp``."""
        def jgrad(mod, v):
            return jax.grad(lambda u: jnp.sum(mod.stage_transfer(u) ** 2))(v)

        with jdrjax.placement_context(stage_ctx(jplacement)):
            want = jgrad(jdrjax, jnp.asarray(X12))
        x = torch.from_numpy(X12.copy())
        with drjax.placement_context(stage_ctx(placement_lib)):
            for recorded in (False, True):
                prev = prims._RECORDING
                prims._RECORDING = recorded
                try:
                    v = x.clone().requires_grad_(True)
                    g = torch.autograd.grad(
                        (drjax.stage_transfer(v) ** 2).sum(), v)[0]
                    _, pull = torch.func.vjp(drjax.stage_transfer, x)
                    fwd = drjax.stage_transfer(x)
                    (gv,) = pull(2.0 * fwd)
                finally:
                    prims._RECORDING = prev
                _eq(g, want)
                _eq(gv, want)
                _eq(drjax.stage_transfer(2.0 * fwd, shift=-1), want)

    def test_tree_polymorphic(self):
        tree = {"a": np.ones((3, 4), np.float32),
                "b": np.zeros((3, 4, 2), np.float32)}

        def fn(mod, a, b):
            return mod.stage_transfer({"a": a, "b": b})

        got, want = _both(fn, tree["a"], tree["b"])
        assert set(got) == {"a", "b"}
        for k in got:
            _eq(got[k], want[k])

    def test_batching_rule(self):
        xs = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        with jdrjax.placement_context(stage_ctx(jplacement)):
            want = jax.vmap(lambda v: jdrjax.stage_transfer(v))(
                jnp.asarray(xs))
        with drjax.placement_context(stage_ctx(placement_lib)):
            for recorded in (False, True):
                prev = prims._RECORDING
                prims._RECORDING = recorded
                try:
                    got = torch.func.vmap(drjax.stage_transfer)(
                        torch.from_numpy(xs))
                finally:
                    prims._RECORDING = prev
                _eq(got, want)

    def test_requires_stage_kind_placement(self):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            ctx = lib.make_context(None, placements={"clients": 4})
            with mod.placement_context(ctx):
                with pytest.raises(ValueError, match="stage"):
                    mod.stage_transfer(conv(np.ones((4, 2), np.float32)))

    def test_explicit_replica_placement_rejected(self):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            with mod.placement_context(stage_ctx(lib)):
                with pytest.raises(ValueError, match="kind"):
                    mod.stage_transfer(conv(np.ones((3, 4), np.float32)),
                                       placement="clients")

    def test_op_rejects_replica_kind_when_called_and_traced(self):
        """The op itself, and its fake implementation under a trace, refuse
        a replica level (the reference's abstract eval)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        x = torch.ones((4, 2))
        with pytest.raises(ValueError, match="kind 'replicas'"):
            torch.ops.drjax.stage_transfer(x, "clients:4", 0, 1, False)
        with FakeTensorMode() as mode:
            fx_ = mode.from_tensor(x)
            with pytest.raises(ValueError, match="kind 'replicas'"):
                torch.ops.drjax.stage_transfer(fx_, "clients:4", 0, 1, False)
            with pytest.raises(ValueError, match="kind 'stages'"):
                torch.ops.drjax.reduce_sum(fx_, "stages:4:stages", 0)
            with pytest.raises(ValueError, match="kind 'stages'"):
                torch.ops.drjax.broadcast(fx_, "stages:4:stages,c:2", 0)
            out = torch.ops.drjax.stage_transfer(fx_, "stages:4:stages", 0,
                                                 1, False)
            assert out.shape == (4, 2)


class TestWrongKindCollectives:
    def test_broadcast_at_stage_level_rejected(self):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            with mod.placement_context(stage_ctx(lib)):
                with pytest.raises(ValueError, match="replicas"):
                    mod.broadcast(conv(np.float32(1.0)), placement="stages")

    @pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean",
                                    "reduce_max"])
    def test_reduce_at_stage_level_rejected(self, op):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            with mod.placement_context(stage_ctx(lib)):
                with pytest.raises(ValueError, match="replicas"):
                    getattr(mod, op)(conv(np.ones((3, 4), np.float32)),
                                     placement="stages")

    def test_default_span_collectives_guarded(self):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            ones = conv(np.ones((3, 4), np.float32))
            with mod.placement_context(stage_ctx(lib)):
                with pytest.raises(ValueError, match="stage_transfer"):
                    mod.broadcast(conv(np.float32(1.0)))
                with pytest.raises(ValueError, match="stage_transfer"):
                    mod.reduce_mean(ones)
                with pytest.raises(ValueError, match="stage_transfer"):
                    mod.reduce_weighted_mean(ones, ones)

    def test_replica_level_still_works(self):
        got, want = _both(lambda mod, x: mod.reduce_sum(x, placement="clients"),
                          np.ones((3, 4), np.float32))
        _eq(got, want)
        _eq(got, np.full(3, 4.0, np.float32))


# ---------------------------------------------------------------------------
# stage_map
# ---------------------------------------------------------------------------


class TestStageMap:
    def test_single_callable_is_map_fn(self):
        got, want = _both(lambda mod, x: mod.stage_map(lambda v: v * 2.0, x),
                          X12)
        _eq(got, want)
        with drjax.placement_context(stage_ctx(placement_lib)):
            b = drjax.map_fn(lambda v: v * 2.0, torch.from_numpy(X12),
                             placement="stages")
        _eq(b, want)

    def test_heterogeneous_stage_functions(self):
        fns = [lambda v: v + 1.0, lambda v: v * 3.0, lambda v: v - 2.0]
        got, want = _both(lambda mod, x: mod.stage_map(fns, x),
                          np.ones((3, 4), np.float32))
        _eq(got, want)
        _eq(got, np.stack([np.full(4, 2.0), np.full(4, 3.0),
                           np.full(4, -1.0)]).astype(np.float32))

    def test_wrong_function_count_rejected(self):
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            with mod.placement_context(stage_ctx(lib)):
                with pytest.raises(ValueError, match="3 stages"):
                    mod.stage_map([lambda v: v, lambda v: v],
                                  conv(np.ones((3, 4), np.float32)))

    def test_tuple_tree_positional_args(self):
        fns = [lambda u, v: u + v, lambda u, v: u * v]
        got, want = _both(lambda mod, a, b: mod.stage_map(fns, (a, b)),
                          np.ones((2, 4), np.float32),
                          2.0 * np.ones((2, 4), np.float32), num_stages=2)
        _eq(got, want)

    def test_outer_levels_stay_mapped(self):
        """A stage level inside a replica level: each stage function sees
        one group's slice."""
        fns = [lambda v: v + 1.0, lambda v: v * 2.0, lambda v: v - 1.0]
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        outs = []
        for mod, lib, conv in ((jdrjax, jplacement, jnp.asarray),
                               (drjax, placement_lib, torch.tensor)):
            ctx = lib.make_context(None, placements={"pods": 2, "stages": 3},
                                   placement_kinds={"stages": "stages"})
            with mod.placement_context(ctx):
                outs.append(mod.stage_map(fns, conv(x)))
        _eq(outs[1], outs[0])
        _eq(outs[1], np.stack([x[:, 0] + 1.0, x[:, 1] * 2.0, x[:, 2] - 1.0],
                              axis=1))


# ---------------------------------------------------------------------------
# the 1F1B pipelined round
# ---------------------------------------------------------------------------


def pipelined_setup(mod, s=3, m=5, d=4, hetero=True, donate=False):
    cfg = mod.PipelineConfig(num_stages=s, num_microbatches=m)
    lib = jnp if mod is jpipeline else torch
    fns = ([(lambda k: (lambda a: a + float(k)))(k) for k in range(s)]
           if hetero else lib.tanh)
    kw = {"donate": True, "device": "cpu"} if donate else {}
    round_fn = mod.make_pipelined_round(fns, cfg, **kw)
    mb = np.arange(m * d, dtype=np.float32).reshape(m, d) / (m * d)
    act0 = np.zeros((s, d), np.float32)
    conv = jnp.asarray if mod is jpipeline else (
        lambda a: torch.from_numpy(a.copy()))
    return round_fn, conv(mb), conv(act0)


def _plans(s=3, m=5, d=4, hetero=True):
    jr, jmb, jact = pipelined_setup(jpipeline, s, m, d, hetero)
    tr, tmb, tact = pipelined_setup(tpipeline, s, m, d, hetero)
    jp = jinterp.build_plan(jinterp.trace(jr, jmb, jact), jr.drjax_context,
                            partitioned_invars=(0, 1))
    tp = interp.build_plan(interp.trace(tr, tmb, tact), tr.drjax_context,
                           partitioned_invars=(0, 1))
    return jp, tp, tr, (tmb, tact)


class TestPipelinedRound:
    @pytest.mark.parametrize("s,m,hetero", [(3, 5, True), (2, 4, True),
                                            (3, 5, False), (4, 2, False)])
    def test_outputs_match_reference(self, s, m, hetero):
        jr, jmb, jact = pipelined_setup(jpipeline, s, m, 4, hetero)
        tr, tmb, tact = pipelined_setup(tpipeline, s, m, 4, hetero)
        (jo, jf), (to, tf) = jr(jmb, jact), tr(tmb, tact)
        if hetero:
            _eq(to, jo)
            _eq(tf, jf)
        else:
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                                       atol=1e-6)

    def test_outputs_match_sequential_composition(self):
        round_fn, mb, act0 = pipelined_setup(tpipeline, s=3, m=5)
        outs, act_final = round_fn(mb, act0)
        _eq(outs, mb.numpy() + 0.0 + 1.0 + 2.0)
        assert act_final.shape == act0.shape

    def test_bubble_fraction(self):
        assert pipeline_bubble_fraction(3, 5) == pytest.approx(2 / 7)
        assert pipeline_bubble_fraction(4, 8) == 3 / 11
        assert pipeline_bubble_fraction(1, 8) == 0.0
        with pytest.raises(ValueError):
            pipeline_bubble_fraction(0, 4)

    def test_plan_has_transfer_inside_loop(self):
        jp, tp, _, _ = _plans()
        kinds = [type(st).__name__ for _n, st, _o in tp.named_stages()]
        assert "LoopStage" in kinds and "Transfer" in kinds
        (loop,) = [st for st in tp.stages if st.kind == "LOOP"]
        assert loop.loop_kind == "scan" and loop.trip_count == 7
        assert [st.kind for st in loop.body_plan.stages
                if st.kind == "TRANSFER"] == ["TRANSFER"]
        text = tp.to_text()
        assert "TRANSFER shift=+1 @stages" in text
        assert "[stages]" in text
        assert "TRANSFER shift=+1 @stages" in jp.to_text()
        assert tp.placement_kinds == jp.placement_kinds == ("stages",)
        assert interp.count_primitives(tp.gm) == {"drjax_stage_transfer": 1}

    def test_run_plan_and_compiled_bitwise_and_zero_retrace(self):
        """S >= 2, M >= 4: ``run_plan`` and the compiled plan bitwise the
        direct round, built once across repeated calls."""
        _, tp, tr, args = _plans(s=3, m=5)
        direct = list(tr(*args))
        ref = interp.run_plan(tp, *args)
        compiled = compile_plan(tp, device="cpu")
        for _ in range(3):
            outs = compiled(*args)
            for a, b, c in zip(outs, ref, direct):
                assert torch.equal(a, b) and torch.equal(b, c)
        assert compiled.trace_count == 1
        assert compiled.num_units == 3  # arange, the loop, the drain slice

    def test_plan_analyzes_clean(self):
        _, tp, _, _ = _plans(s=3, m=5)
        report = tp.analyze()
        assert not report.errors, report

    def test_kinds_split_the_fingerprint(self):
        """A stage stack and a replica stack of the same sizes never share
        an executable."""
        from repro_torch.runtime import executor

        _, tp, _, _ = _plans(s=2, m=4)
        assert ("placement_kinds", b"('stages',)") in \
            executor.fingerprint_parts(tp)
        as_replicas = interp.MapReducePlan(**{
            **{f: getattr(tp, f) for f in tp.__dataclass_fields__},
            "placement_kinds": ("replicas",)})
        assert executor.plan_fingerprint(as_replicas) != \
            executor.plan_fingerprint(tp)

    def test_donated_round_updates_the_buffer_in_place(self):
        round_fn, mb, act0 = pipelined_setup(tpipeline, s=2, m=4, d=3,
                                             hetero=False, donate=True)
        want_outs, want_final = pipelined_setup(tpipeline, s=2, m=4, d=3,
                                                hetero=False)[0](mb, act0)
        outs, act_final = round_fn(mb, act0)
        assert act_final is act0  # written in place, returned as the buffer
        _eq(outs, want_outs.numpy())
        _eq(act0, want_final.numpy())
        outs2, _ = round_fn(mb, act_final)
        _eq(outs2, want_outs.numpy())

    def test_donated_round_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_pipelined_round(lambda a: a, PipelineConfig(2, 4),
                                 donate=True)

    def test_grad_through_pipeline(self):
        """Autograd through the ticks, the stage map and the transfers:
        each microbatch passes both stages, d(sum)/d(mb) = 9, as the
        reference's ``jax.grad``."""
        round_fn = make_pipelined_round(lambda a: 3.0 * a, PipelineConfig(2, 4))
        mb = torch.ones((4, 3), requires_grad=True)
        (g,) = torch.autograd.grad(round_fn(mb, torch.zeros((2, 3)))[0].sum(),
                                   mb)
        jround = jpipeline.make_pipelined_round(
            lambda a: 3.0 * a, jpipeline.PipelineConfig(2, 4))
        want = jax.grad(lambda x: jnp.sum(jround(x, jnp.zeros((2, 3)))[0]))(
            jnp.ones((4, 3)))
        _eq(g, want)
        _eq(g, np.full((4, 3), 9.0, np.float32))

    def test_single_stage_degenerate(self):
        round_fn = make_pipelined_round(lambda a: a + 1.0, PipelineConfig(1, 4))
        mb = torch.arange(12.0).reshape(4, 3)
        outs, _ = round_fn(mb, torch.zeros((1, 3)))
        _eq(outs, mb.numpy() + 1.0)

    def test_wrong_stage_count_rejected(self):
        with pytest.raises(ValueError, match="2 stage functions for 3"):
            make_pipelined_round([lambda a: a] * 2, PipelineConfig(3, 4))


# ---------------------------------------------------------------------------
# analysis passes
# ---------------------------------------------------------------------------


class TestPipelineAnalysis:
    def test_commcost_prices_transfer_as_ici(self):
        _, tp, _, _ = _plans(s=2, m=4, d=8)
        rep = commcost.estimate_comm_cost(tp)
        (c,) = [c for c in rep.per_stage if c.kind == "TRANSFER"]
        assert c.link == "ici" and c.op == "stage_transfer"
        # 2 stages, shift 1, no wrap: one sender of 8 f32 = 32 B, times the
        # scan's trip count M + S - 1 = 5
        assert c.endpoints == 1
        assert c.payload_bytes == 32.0
        assert c.multiplier == 5.0
        assert rep.ici_bytes == 160.0 and rep.dcn_bytes == 0.0

    def test_commcost_wrap_counts_every_stage(self):
        ctx = placement_lib.make_context(
            None, placements={"stages": 4, "clients": 1},
            placement_kinds={"stages": "stages"})

        def f(x):
            return drjax.stage_transfer(x, wrap=True)

        f.drjax_context = ctx
        with drjax.placement_context(ctx):
            plan = interp.build_plan(interp.trace(f, torch.ones((4, 1, 8))),
                                     ctx)
        (c,) = [c for c in commcost.estimate_comm_cost(plan).per_stage
                if c.kind == "TRANSFER"]
        assert c.endpoints == 4

    def test_wrong_kind_transfer_finding(self):
        """A transfer whose node's stack says the level is replica-kind (an
        edited plan: the op refuses to trace one) is an error."""
        _, tp, _, _ = _plans(s=2, m=4)
        transfers = [st for _n, st, _o in tp.named_stages()
                     if isinstance(st, interp.Transfer)]
        node = transfers[0].node
        node.args = (node.args[0], "stages:2") + node.args[2:]
        found = placement_safety.check_placement_safety(tp)
        assert any(f.code == "placement/wrong-kind-comm"
                   and f.severity == "error" for f in found), found

    def test_wrong_kind_reduce_finding(self):
        @drjax.program(partition_size=4)
        def f(x):
            return drjax.reduce_sum(x)

        plan = interp.build_plan(interp.trace(f, torch.ones((4, 2))), 4)
        (red,) = [st for st in plan.stages if isinstance(st, interp.Reduce)]
        red.node.args = (red.node.args[0], "clients:4:stages") + \
            red.node.args[2:]
        found = placement_safety.check_placement_safety(plan)
        assert any(f.code == "placement/wrong-kind-comm" for f in found)

    @pytest.mark.parametrize("s", [2, 3])
    def test_transfer_stages_in_beam_text(self, s):
        """The Beam emitter stages a Transfer (re-key, zero fill of the
        vacated stages); the text compiles like every other plan's."""
        _, tp, _, _ = _plans(s=s, m=4)
        text = tp.to_beam()
        compile(text, "<to_beam>", "exec")
        assert "TRANSFER shift=+1 @stages" in text
        assert "_stage_shift" in text or "zero-fill" in text
