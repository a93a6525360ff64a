"""DrJAX MapReduce primitives on single tensors (``repro/core/primitives.py``).

Every primitive is placement-addressed: for a placement at stack index
``i``, ``broadcast`` takes a value partitioned at the ``i`` outer placements
and inserts that placement's group axis at position ``i``; ``reduce_*``
removes it. ``stage_transfer`` addresses a stage-kind level and keeps the
value's depth: ``out[j] = x[j - shift]`` along that level's axis, vacated
stages zero-filled (or rolled, ``wrap=True``). Broadcast and the
reductions refuse a stage-kind level and ``stage_transfer`` a replica
level, when called and when traced (the ops' fake implementations).

Two forms, one arithmetic:

* **Direct** (the default): broadcast and the plain reductions are
  ordinary differentiable tensor ops along the leading group axes, so
  autograd yields the MapReduce AD transposes directly: the backward of
  ``broadcast@p`` (an ``expand``) is ``reduce_sum@p``, and that of
  ``reduce_mean@p`` is ``broadcast@p(ct * r)``. ``broadcast`` stays an
  ``expand`` view, so broadcasting a whole model's parameters to every
  group costs no memory.
* **Recorded** (inside :func:`recording`, which ``interpreter.trace``
  enters): each primitive calls its registered op in the ``drjax``
  namespace (``torch.ops.drjax.broadcast``, ``reduce_sum``,
  ``reduce_mean``, ``reduce_max``), so a traced program holds it as one
  node whose arguments carry the placement stack, the addressed level and
  the ``compress``/``qaxis`` tags, as the reference's eqn params do. The
  ops' autograd (``autograd.Function`` classes with ``setup_context``, so
  ``torch.func`` transforms take them; the op's own
  ``register_autograd`` does not compose with them) is written in the
  same op set, so a traced
  gradient program holds only ``drjax`` communication nodes: the backward
  of ``drjax.broadcast@p`` is ``drjax.reduce_sum@p``, of
  ``drjax.reduce_sum@p`` ``drjax.broadcast@p``, of ``drjax.reduce_mean@p``
  ``drjax.broadcast@p(ct * r)``, of ``drjax.reduce_max@p`` the
  reference's subgradient (the tangent split evenly over tied arg-max
  groups) carried by ``drjax.broadcast``, and of
  ``drjax.stage_transfer@p`` (shift s) the reverse transfer (shift -s,
  the same ``wrap``): the backward pipeline. Their batching rules move the
  vmapped axis to the end, as the reference's do, so ``torch.func.vmap``
  keeps the primitive.

Why the two forms: a registered op may not return a view of its input, so
``drjax.broadcast`` materializes its result. Recording only while a trace
is taken keeps the direct rounds' memory what it was (a view), and a
recorded plan's ``broadcast`` node pays for the copy only where a plan is
run.

``compress="int8"`` on ``reduce_mean`` runs the fused reduce + int8
roundtrip (the ``repro.reduce_compress_roundtrip`` kernel op on the card);
its gradient is the plain ``reduce_mean``'s (the roundtrip is
straight-through), bitwise.

``r`` is ``1 / size`` rounded to f32 once (:func:`reciprocal`): the
reference's driver always jits, and XLA compiles its ``sum / size`` (and
the transpose's ``ct / size``) as a product with that reciprocal. A
division would differ from it in the last bit for sizes that are not
powers of two.

``stage_transfer`` has no kernel: the reference lowers it with
``mlir.lower_fun`` of its jnp implementation, a roll and a zero fill,
which are plain tensor ops here too.

**On a mesh** (a context with a ``DeviceMesh`` and sharding annotations,
outside a trace) each primitive runs its ``core/sharding.py`` form on the
rank's own groups: broadcast expands onto them, the reductions add the
local partial and ``all_reduce`` it over the level's mesh dims, the
int8-tagged mean and the transfer gather the level exactly first. A
traced program records the mesh-free ops: a plan takes its mesh when it
is compiled (``runtime.executor.compile_plan(mesh=)``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..kernels import ops as kernel_ops
from . import placement as placement_lib
from . import sharding

COMM_OPS = ("broadcast", "reduce_sum", "reduce_mean", "reduce_max",
            "stage_transfer")

# A module global, not a thread-local: the autograd engine runs a traced
# backward on its device threads, which must record as well.
_RECORDING = False


@contextlib.contextmanager
def recording():
    """Inside this context the primitives call their ``drjax`` ops (one
    graph node each under a tracer) instead of the direct tensor ops."""
    global _RECORDING
    prev, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = prev


def is_recording() -> bool:
    return _RECORDING


def stack_spec(ctx: placement_lib.PlacementContext) -> str:
    """The placement stack as an op argument: ``"pods:2,clients:4"``, a
    stage-kind level marked ``"stages:4:stages"``."""
    return ",".join(f"{p.name}:{p.size}"
                    + (f":{p.kind}" if p.kind != "replicas" else "")
                    for p in ctx.placements)


def parse_placements(spec: str) -> Tuple[placement_lib.Placement, ...]:
    out = []
    for entry in spec.split(","):
        name, size, *kind = entry.split(":")
        out.append(placement_lib.Placement(
            name, int(size), kind=kind[0] if kind else "replicas"))
    return tuple(out)


def parse_stack(spec: str) -> Tuple[Tuple[str, int], ...]:
    """(name, size) of each level of a stack argument."""
    return tuple((p.name, p.size) for p in parse_placements(spec))


def _resolve(placement: Optional[str]) -> Tuple[placement_lib.Placement, int]:
    ctx = placement_lib.current_context()
    i = ctx.index_of(placement)
    return ctx.placements[i], i


def _mesh_ctx() -> Optional[placement_lib.PlacementContext]:
    """The ambient context when the primitives run on its mesh."""
    if _RECORDING:
        return None
    ctx = placement_lib.current_context()
    return ctx if ctx.sharded() else None


def _check_kind(pl: placement_lib.Placement, prim: str, expect: str) -> None:
    """Replica collectives address only replica-kind levels, a transfer
    only stage-kind ones (the reference's wrong-kind refusal)."""
    if pl.kind != expect:
        other = ("stage_transfer/stage_map" if expect == "replicas"
                 else "broadcast/reduce")
        raise ValueError(
            f"drjax.{prim} cannot address placement '{pl.name}' of kind "
            f"'{pl.kind}' (expects a '{expect}'-kind placement; "
            f"'{pl.kind}' levels communicate via {other})."
        )


def _check_spec_kind(stack: str, index: int, prim: str) -> None:
    """:func:`_check_kind` of an op's addressed level, from its stack
    argument: what the ops and their fake implementations check."""
    _check_kind(parse_placements(stack)[index], prim,
                "stages" if prim == "stage_transfer" else "replicas")


def _check_operand_depth(x: torch.Tensor, depth: int, prim: str) -> None:
    """Operand must carry the ``depth`` outermost placements' group axes."""
    ctx = placement_lib.current_context()
    if x.ndim < depth:
        raise ValueError(
            f"drjax.{prim} at placement '{ctx.placements[depth - 1].name}' "
            f"expects a value partitioned at the {depth} outer placement(s) "
            f"{list(ctx.names[:depth])}; got a rank-{x.ndim} tensor."
        )
    for j in range(depth):
        pl = ctx.placements[j]
        if x.shape[j] != pl.size:
            raise ValueError(
                f"drjax.{prim}: axis {j} ({x.shape[j]}) does not match the "
                f"partition size ({pl.size}) of placement '{pl.name}'."
            )


def reciprocal(n: int) -> torch.Tensor:
    """``1 / n`` rounded to f32 once, as a 0-d CPU tensor. A product with
    it runs as a scalar product in f32 (bf16 operands too) on either
    device, as the jitted reference's ``x / n`` does."""
    return torch.tensor(1.0 / n, dtype=torch.float32)


def _size(stack: str, index: int) -> int:
    return parse_stack(stack)[index][1]


def _expand(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    return x.unsqueeze(i).expand(x.shape[:i] + (n,) + x.shape[i:])


# ---------------------------------------------------------------------------
# the registered ops (recorded form)
# ---------------------------------------------------------------------------


def _transfer(x: torch.Tensor, i: int, shift: int, wrap: bool) -> torch.Tensor:
    """``out[..., j, ...] = x[..., j - shift, ...]`` along axis ``i``: a
    roll, the slots the shift vacated zero-filled unless ``wrap`` (the
    reference's ``_stage_transfer_impl``). A new tensor, never a view."""
    n = x.shape[i]
    if wrap and shift % n == 0:
        return x.clone()
    out = torch.roll(x, shift, dims=i)
    if not wrap:
        src = torch.arange(n, device=x.device) - shift
        valid = ((src >= 0) & (src < n)).reshape(
            (1,) * i + (n,) + (1,) * (x.ndim - i - 1))
        out = torch.where(valid, out, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return out


@torch.library.custom_op("drjax::broadcast", mutates_args=())
def _broadcast_op(x: torch.Tensor, stack: str, index: int) -> torch.Tensor:
    _check_spec_kind(stack, index, "broadcast")
    return _expand(x, index, _size(stack, index)).clone()


@torch.library.custom_op("drjax::reduce_sum", mutates_args=())
def _reduce_sum_op(x: torch.Tensor, stack: str, index: int) -> torch.Tensor:
    _check_spec_kind(stack, index, "reduce_sum")
    return x.sum(dim=index)


@torch.library.custom_op("drjax::reduce_mean", mutates_args=())
def _reduce_mean_op(x: torch.Tensor, stack: str, index: int,
                    compress: Optional[str] = None,
                    qaxis: int = -1) -> torch.Tensor:
    _check_spec_kind(stack, index, "reduce_mean")
    if compress is None:
        return x.sum(dim=index) * reciprocal(_size(stack, index))
    return kernel_ops.reduce_compress_roundtrip(x, axis=index, qaxis=qaxis)


@torch.library.custom_op("drjax::reduce_max", mutates_args=())
def _reduce_max_op(x: torch.Tensor, stack: str, index: int) -> torch.Tensor:
    _check_spec_kind(stack, index, "reduce_max")
    return x.amax(dim=index)


@torch.library.custom_op("drjax::stage_transfer", mutates_args=())
def _stage_transfer_op(x: torch.Tensor, stack: str, index: int, shift: int,
                       wrap: bool) -> torch.Tensor:
    _check_spec_kind(stack, index, "stage_transfer")
    return _transfer(x, index, shift, wrap)


@_broadcast_op.register_fake
def _(x, stack, index):
    _check_spec_kind(stack, index, "broadcast")
    n = _size(stack, index)
    return x.new_empty(x.shape[:index] + (n,) + x.shape[index:])


def _reduced_fake(name):
    def fake(x, stack, index, *rest):
        _check_spec_kind(stack, index, name)
        return x.new_empty(x.shape[:index] + x.shape[index + 1:])

    return fake


for _name, _op in (("reduce_sum", _reduce_sum_op),
                   ("reduce_mean", _reduce_mean_op),
                   ("reduce_max", _reduce_max_op)):
    _op.register_fake(_reduced_fake(_name))


@_stage_transfer_op.register_fake
def _(x, stack, index, shift, wrap):
    _check_spec_kind(stack, index, "stage_transfer")
    levels = parse_placements(stack)
    if x.ndim < index + 1 or any(x.shape[j] != levels[j].size
                                 for j in range(index + 1)):
        raise ValueError(
            f"drjax.stage_transfer at placement '{levels[index].name}' "
            f"expects a value partitioned at the {index + 1} outer "
            f"placement(s); got shape {tuple(x.shape)}.")
    return x.new_empty(x.shape)


class _Comm(torch.autograd.Function):
    """Base of the ops' autograd: ``forward`` runs the op (one graph node
    under a tracer), ``backward`` the transposed primitive through its own
    Function, so second order stays in the set. ``setup_context`` and the
    generated vmap rule (from the ops' batching rules) make them
    ``torch.func`` transforms' as well."""

    generate_vmap_rule = True

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.stack, ctx.index = inputs[1], inputs[2]


class _Broadcast(_Comm):
    @staticmethod
    def forward(x, stack, index):
        return torch.ops.drjax.broadcast(x, stack, index)

    @staticmethod
    def backward(ctx, ct):
        return _ReduceSum.apply(ct, ctx.stack, ctx.index), None, None


class _ReduceSum(_Comm):
    @staticmethod
    def forward(x, stack, index):
        return torch.ops.drjax.reduce_sum(x, stack, index)

    @staticmethod
    def backward(ctx, ct):
        return _Broadcast.apply(ct, ctx.stack, ctx.index), None, None


class _ReduceMean(_Comm):
    @staticmethod
    def forward(x, stack, index, compress, qaxis):
        return torch.ops.drjax.reduce_mean(x, stack, index, compress, qaxis)

    @staticmethod
    def backward(ctx, ct):
        r = reciprocal(_size(ctx.stack, ctx.index))
        return (_Broadcast.apply(ct * r, ctx.stack, ctx.index),
                None, None, None, None)


class _ReduceMax(_Comm):
    @staticmethod
    def forward(x, stack, index):
        return torch.ops.drjax.reduce_max(x, stack, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _Comm.setup_context(ctx, inputs, output)
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, ct):
        """The reference's subgradient (``primitives.py:310-330``): the
        tangent goes to the arg-max groups, split evenly over ties; reverse
        mode stays in the primitive set through ``broadcast``."""
        x, out = ctx.saved_tensors
        i = ctx.index
        hit = (x == out.unsqueeze(i)).to(x.dtype)
        hit = hit / torch.clamp_min(hit.sum(dim=i, keepdim=True), 1)
        return hit * _Broadcast.apply(ct, ctx.stack, i), None, None


class _StageTransfer(_Comm):
    @staticmethod
    def forward(x, stack, index, shift, wrap):
        return torch.ops.drjax.stage_transfer(x, stack, index, shift, wrap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _Comm.setup_context(ctx, inputs, output)
        ctx.shift, ctx.wrap = inputs[3], inputs[4]

    @staticmethod
    def backward(ctx, ct):
        """The transpose of a linear shift: the reverse transfer (the
        reference's ``_stage_transfer_transpose``)."""
        return (_StageTransfer.apply(ct, ctx.stack, ctx.index, -ctx.shift,
                                     ctx.wrap), None, None, None, None)


def _last(x, d):
    return x.movedim(d, -1), x.ndim - 1


@torch.library.register_vmap("drjax::broadcast")
def _broadcast_vmap(info, in_dims, x, stack, index):
    (d, _, _) = in_dims
    if d is None:
        return torch.ops.drjax.broadcast(x, stack, index), None
    x, _ = _last(x, d)
    out = torch.ops.drjax.broadcast(x, stack, index)
    return out, out.ndim - 1


def _reduction_vmap(op):
    def rule(info, in_dims, x, stack, index, *rest):
        d = in_dims[0]
        if d is None:
            return op(x, stack, index, *rest), None
        # The batch axis lands at the end, so a from-the-end quant axis
        # moves one step deeper (the reference's rule, ``:207-265``).
        if rest and rest[0] is not None and rest[1] < 0:
            rest = (rest[0], rest[1] - 1)
        x, _ = _last(x, d)
        out = op(x, stack, index, *rest)
        return out, out.ndim - 1

    return rule


for _name in ("reduce_sum", "reduce_mean", "reduce_max"):
    torch.library.register_vmap(
        f"drjax::{_name}", _reduction_vmap(getattr(torch.ops.drjax, _name)))


@torch.library.register_vmap("drjax::stage_transfer")
def _stage_transfer_vmap(info, in_dims, x, stack, index, shift, wrap):
    d = in_dims[0]
    if d is None:
        return torch.ops.drjax.stage_transfer(x, stack, index, shift,
                                              wrap), None
    # The batch axis goes last, so the placement-prefix axes stay leading.
    x, _ = _last(x, d)
    out = torch.ops.drjax.stage_transfer(x, stack, index, shift, wrap)
    return out, out.ndim - 1


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


def broadcast(x: torch.Tensor, placement: Optional[str] = None) -> torch.Tensor:
    """One ``broadcast@placement``: depth-i operand -> depth-(i+1) result.

    Direct: an ``expand`` view, no copy, and autograd's backward is the sum
    over the new axis (``reduce_sum@placement``)."""
    x = torch.as_tensor(x)
    pl, i = _resolve(placement)
    _check_kind(pl, "broadcast", "replicas")
    _check_operand_depth(x, i, "broadcast")
    if _RECORDING:
        return _Broadcast.apply(
            x, stack_spec(placement_lib.current_context()), i)
    ctx = _mesh_ctx()
    if ctx is not None:
        return sharding.broadcast(x, ctx, i)
    return _expand(x, i, pl.size)


def reduce_sum(x: torch.Tensor, placement: Optional[str] = None) -> torch.Tensor:
    pl, i = _resolve(placement)
    _check_kind(pl, "reduce_sum", "replicas")
    _check_operand_depth(x, i + 1, "reduce_sum")
    if _RECORDING:
        return _ReduceSum.apply(
            x, stack_spec(placement_lib.current_context()), i)
    ctx = _mesh_ctx()
    if ctx is not None:
        return sharding.reduce_sum(x, ctx, i)
    return x.sum(dim=i)


def reduce_max(x: torch.Tensor, placement: Optional[str] = None) -> torch.Tensor:
    """Max over one placement's groups; its gradient goes to the arg-max
    groups, split evenly over ties (the reference's subgradient)."""
    pl, i = _resolve(placement)
    _check_kind(pl, "reduce_max", "replicas")
    _check_operand_depth(x, i + 1, "reduce_max")
    ctx = _mesh_ctx()
    if ctx is not None:
        return sharding.reduce_max(x, ctx, i)
    return _ReduceMax.apply(x, stack_spec(placement_lib.current_context()), i)


class _FusedReduceMean(torch.autograd.Function):
    """``reduce_mean@p`` tagged ``compress="int8"``: forward is the fused
    single-pass mean + int8 roundtrip (the ``repro.reduce_compress_roundtrip``
    op: the CUDA kernel on the card); backward is ``broadcast@p(ct * r)``,
    exactly the plain reduce_mean's, so the gradient equals the unfused
    composition's bitwise."""

    @staticmethod
    def forward(ctx, x, axis: int, size: int, qaxis: int):
        ctx.axis, ctx.size, ctx.shape = axis, size, x.shape
        return kernel_ops.reduce_compress_roundtrip(x, axis=axis, qaxis=qaxis)

    @staticmethod
    def backward(ctx, ct):
        g = (ct * reciprocal(ctx.size)).unsqueeze(ctx.axis).expand(ctx.shape)
        return g, None, None, None


def reduce_mean(x: torch.Tensor, placement: Optional[str] = None, *,
                compress: Optional[str] = None, qaxis: int = -1) -> torch.Tensor:
    """Mean over one placement's groups. ``compress="int8"`` runs the fused
    reduce + int8 roundtrip (``qaxis`` = the partial's axis that carries the
    per-row scales): the hierarchical fast path."""
    pl, i = _resolve(placement)
    _check_kind(pl, "reduce_mean", "replicas")
    _check_operand_depth(x, i + 1, "reduce_mean")
    if compress not in (None, "int8"):
        raise NotImplementedError(
            f"drjax.reduce_mean: fused compress={compress!r} is only "
            "implemented for int8 (the hierarchical fast path)."
        )
    if _RECORDING:
        return _ReduceMean.apply(
            x, stack_spec(placement_lib.current_context()), i, compress, qaxis)
    ctx = _mesh_ctx()
    if ctx is not None:
        if compress is None:
            return sharding.reduce_sum(x, ctx, i, scale=reciprocal(pl.size))
        return sharding.reduce_mean_int8(
            x, ctx, i,
            lambda full, axis: _FusedReduceMean.apply(full, axis, pl.size,
                                                      qaxis))
    if compress is None:
        return x.sum(dim=i) * reciprocal(pl.size)
    return _FusedReduceMean.apply(x, i, pl.size, qaxis)


def stage_transfer(x: torch.Tensor, placement: Optional[str] = None, *,
                   shift: int = 1, wrap: bool = False) -> torch.Tensor:
    """One ``stage_transfer@placement`` of a stage-kind level at stack
    index i: ``out[..., j, ...] = x[..., j - shift, ...]`` along axis i,
    the vacated stages zero-filled unless ``wrap`` (a ring); a shift of
    at least the stage count zeroes everything. Linear: its transpose is
    the reverse transfer (``-shift``, the same ``wrap``), which autograd
    takes through the roll and the fill directly."""
    pl, i = _resolve(placement)
    _check_kind(pl, "stage_transfer", "stages")
    _check_operand_depth(x, i + 1, "stage_transfer")
    if _RECORDING:
        return _StageTransfer.apply(
            x, stack_spec(placement_lib.current_context()), i, int(shift),
            bool(wrap))
    ctx = _mesh_ctx()
    if ctx is not None:
        return sharding.stage_transfer(
            x, ctx, i, lambda full, axis: _transfer(full, axis, int(shift),
                                                    bool(wrap)))
    return _transfer(x, i, int(shift), bool(wrap))
