"""Pipelined rounds over a stage-kind placement, 1F1B-style microbatching
(``repro/algorithms/pipeline.py``).

A pipeline is a placement stack whose level is *stage*-kind: the S groups
are not replicas of one computation but S phases of it, and they
communicate by neighbour transfer (:func:`repro_torch.core.stage_transfer`)
rather than broadcast/reduce. :func:`make_pipelined_round` builds the round
as ``T = M + S - 1`` schedule ticks:

* tick ``t`` injects microbatch ``min(t, M - 1)`` into stage 0's slot of
  the carried activation buffer (leaves of shape ``(S,) + activation``),
* every stage computes its phase on its slot (:func:`stage_map`: one
  function at every stage, or S heterogeneous ones),
* stage ``S - 1``'s slot is drained as that tick's output,
* the buffer shifts by one stage (``stage_transfer(shift=1)``) for the
  next tick, stage 0 zero-filled until the next injection overwrites it.

Ticks before ``S - 1`` drain the fill, so microbatch m emerges at tick
``m + S - 1``, and the idle share of stage-ticks is the bubble
``(S - 1) / (M + S - 1)`` (:func:`pipeline_bubble_fraction`).

Called directly, the round is a Python loop over the ticks. While a
program is traced (``core.interpreter.trace``) it is one recorded
``scan`` node over the tick index (``core.api.recorded_scan``), the
microbatches closed over, as the reference's is one ``lax.scan``: its plan
is one ``LOOP[scan]`` whose body holds the stage map and a ``TRANSFER``,
and ``run_plan`` of it runs the same calls as the direct loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from .. import compat
from .. import core as drjax
from ..core import api as core_api
from ..core import primitives as prims

__all__ = [
    "PipelineConfig",
    "make_pipelined_round",
    "pipeline_bubble_fraction",
]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """``num_stages`` is the stage-kind placement's size S,
    ``num_microbatches`` the M microbatches fed through per round.
    ``stage_axes`` names the mesh dim the stage level shards over
    (conventionally "stage", ``launch.mesh.level_axes_for``) on ``mesh``,
    a ``DeviceMesh``: each rank then runs its own stages, and the
    transfer exchanges them over that dim."""

    num_stages: int
    num_microbatches: int
    stage_axes: Any = None
    mesh: Any = None
    use_sharding_annotations: bool = True


def pipeline_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle share of stage-ticks in the fill/drain schedule:
    ``(S - 1) / (M + S - 1)``."""
    s, m = num_stages, num_microbatches
    if s < 1 or m < 1:
        raise ValueError("need num_stages >= 1 and num_microbatches >= 1")
    return (s - 1) / (m + s - 1)


def _pick(x: torch.Tensor, t, m: int) -> torch.Tensor:
    """Microbatch ``min(t, m - 1)`` of ``x``: ``t`` a Python int in the
    direct loop, a 0-d tensor in the traced scan's body."""
    if isinstance(t, int):
        return x[min(t, m - 1)]
    idx = torch.clamp(t, max=m - 1).reshape(1)
    return x.index_select(0, idx).squeeze(0)


def make_pipelined_round(stage_fns: Union[Callable, Sequence[Callable]],
                         cfg: PipelineConfig, *, donate: bool = False,
                         device: str = "cuda"):
    """Build ``round_fn(microbatches, act0) -> (outs, act_final)``.

    ``stage_fns`` is one callable (the same phase at every stage) or a
    sequence of ``num_stages`` callables. Every phase maps an activation to
    an activation of the same shape and dtype: the carried buffer has one
    slot per stage. ``microbatches`` leaves lead with the (M,) microbatch
    axis; ``act0`` leaves are ``(S,) + activation`` (zeros for a cold
    start). ``outs`` leaves are ``(M,) + activation``: microbatch m after
    all S phases. ``round_fn.drjax_context`` is the stage stack, for
    ``build_plan`` (pass ``partitioned_invars``: the microbatches' leaves
    at depth 0, the buffer's at 1, since M may equal S).

    ``donate=True`` returns the round compiled for ``device`` (the card
    unless the caller asks for the CPU) with ``act0`` donated, the port's
    form of the reference's ``jax.jit(round_fn, donate_argnums=(1,))``:
    on its first call for a set of argument shapes it is traced, planned
    and compiled (``compile_plan`` with every leaf of ``act0`` donated; its
    flat outputs are the ticks' outputs, then the buffer, so buffer leaf j
    is output ``len(leaves(microbatches)) + j``, the index of its argument),
    and each call updates ``act0`` in place with ``act_final`` and returns
    it as ``act_final``.
    """
    s, m = cfg.num_stages, cfg.num_microbatches
    if s < 1 or m < 1:
        raise ValueError("need num_stages >= 1 and num_microbatches >= 1")
    if not callable(stage_fns):
        stage_fns = tuple(stage_fns)
        if len(stage_fns) != s:
            raise ValueError(f"got {len(stage_fns)} stage functions for {s} "
                             "stages (or pass a single callable).")
    ticks = m + s - 1

    def tick(microbatches, act, t):
        mb = pytree.tree_map(lambda x: _pick(x, t, m), microbatches)
        # The reference's act.at[0].set(mb), as a new tensor: no output of
        # a scan body may be its input.
        act = pytree.tree_map(
            lambda a, v: torch.cat([v.to(a.dtype).unsqueeze(0), a[1:]]),
            act, mb)
        y = drjax.stage_map(stage_fns, act)
        out = pytree.tree_map(lambda x: x[s - 1], y)
        return drjax.stage_transfer(y, shift=1), out

    @drjax.program(placements={"stages": s},
                   placement_kinds={"stages": "stages"},
                   partition_axes=({"stages": cfg.stage_axes}
                                   if cfg.stage_axes is not None else None),
                   mesh=cfg.mesh,
                   use_sharding_annotations=cfg.use_sharding_annotations)
    def round_fn(microbatches, act0):
        if prims.is_recording() and core_api._under_trace():
            return _scanned_ticks(tick, microbatches, act0, ticks, s)
        act, outs = act0, []
        for t in range(ticks):
            act, out = tick(microbatches, act, t)
            if t >= s - 1:  # ticks before S - 1 drain the fill
                outs.append(out)
        return pytree.tree_map(lambda *xs: torch.stack(xs), *outs), act

    if donate:
        return _donated(round_fn, compat.resolve_device(device).type)
    return round_fn


def _scanned_ticks(tick, microbatches, act0, ticks: int, s: int):
    """The round as one recorded scan node over the tick index."""
    carry, carry_spec = pytree.tree_flatten(act0)
    out_spec = []

    def body(*leaves):
        act = pytree.tree_unflatten(list(leaves[:-1]), carry_spec)
        nxt, out = tick(microbatches, act, leaves[-1])
        ys, spec = pytree.tree_flatten(out)
        out_spec[:] = [spec]
        return pytree.tree_leaves(nxt) + ys

    t = torch.arange(ticks, device=carry[0].device)
    outs = core_api.recorded_scan(body, carry, [t])
    act_final = pytree.tree_unflatten(list(outs[:len(carry)]), carry_spec)
    ys = pytree.tree_unflatten([y[s - 1:] for y in outs[len(carry):]],
                               out_spec[0])
    return ys, act_final


def _donated(round_fn, device: str):
    """``round_fn`` compiled with its buffer donated, one compiled plan
    per set of argument shapes and dtypes."""
    from ..core import interpreter as interp
    from ..runtime import executor

    compiled = {}

    def donated_round(microbatches, act0):
        mb_leaves = pytree.tree_leaves(microbatches)
        act_leaves = pytree.tree_leaves(act0)
        leaves = mb_leaves + act_leaves
        key = executor._arg_key(leaves)
        if key not in compiled:
            gm = interp.trace(round_fn, microbatches, act0)
            plan = interp.build_plan(
                gm, round_fn.drjax_context,
                partitioned_invars=[0] * len(mb_leaves) + [1] * len(act_leaves))
            n = len(mb_leaves)
            compiled[key] = (executor.compile_plan(
                plan, device=device,
                donate_argnums=tuple(range(n, n + len(act_leaves)))),
                gm.out_spec)
        plan_fn, spec = compiled[key]
        return pytree.tree_unflatten(list(plan_fn(*leaves)), spec)

    donated_round.drjax_context = round_fn.drjax_context
    return donated_round
