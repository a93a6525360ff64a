"""Logical-axis partitioning (``repro/models/partitioning.py``) and the
collectives of the port's tensor-parallel compute.

Model code names tensor axes logically (``("batch", "seq", "heads",
"head_dim")``); a rule table maps each logical name to mesh axes. The
rules, their thread-local installation (:func:`axis_rules`) and the
resolution (:func:`resolve_axis`: the first candidate whose mesh axes all
exist and, given a dim size, divide it) are the reference's. A mesh is a
``DeviceMesh`` (``launch/mesh.py``), or any object with ``mesh_dim_names``
and a ``mesh`` array of ranks: resolution reads only the dim names and
sizes. A spec (:func:`spec_for`) is a tuple with one entry per tensor dim,
as a ``PartitionSpec``; :func:`named_sharding` turns it into DTensor
placements, one per mesh dim (``compat.named_placements``: ``Shard(i)``
on every mesh dim that tensor dim i resolves to, outer first, else
``Replicate()``).

The reference is single-controller and lets GSPMD place the collectives
its constraints imply. The port is SPMD, one process per rank, and its
model code runs on each rank's local tensors with the collectives placed
explicitly (Megatron's scheme):

* a step keeps a parameter's dim local where its logical axis is one of
  :data:`TP_AXES` and resolves to ``"model"`` (the rank's heads, FFN
  columns, experts or vocabulary rows; :func:`local_dims`), and a batch
  dim local where it resolves to any mesh axes; every other sharded dim
  is gathered exactly before use (FSDP's gather, and the layouts the
  port computes whole, e.g. a head-dim split), a layer's leaves inside
  the layer (:func:`layer_view`). :func:`to_compute` and
  :func:`to_storage` move a tensor between the two layouts;
* the model code enters a tensor-parallel region with :func:`enter`
  (identity; its gradient is summed over ``"model"``), leaves one with
  :func:`reduce_sum` (the partial sums' all-reduce; identity gradient) or
  :func:`gather` (an exact gather; its gradient is the rank's slice), so
  every value outside a region is the same on every rank of ``"model"``:
  the residual stream is replicated over ``"model"``, where the
  reference's ``"embed"`` rule lets GSPMD shard its model dim;
* :func:`with_logical_constraint` keeps the reference's call sites and
  checks each one's rank: a no-op without a mesh, as there; on a mesh it
  redistributes a DTensor to its spec, and returns a rank's local tensor
  (all the steps pass) as it is, since the explicit collectives above
  take the place of GSPMD's constraints;
* a module that splits reads where from :func:`local_block`, the same
  decision the step's layout makes (:func:`local_dims`,
  :func:`tp_leaf`), and raises where its weight disagrees.

Every gather goes by :func:`gather_route`: ``all_gather`` on NCCL and on
CPU gloo, and on gloo with CUDA tensors (ranks sharing one card) the exact
``all_reduce`` gather (``core.sharding.gather_dim``'s method: each rank
writes its block into a zero-filled stack, summed as bytes), since gloo
carries ``all_reduce`` for CUDA tensors but not ``all_gather``. The bits gathered
are the same either way; :data:`ROUTES` counts each route's calls and the
bytes of the other ranks' blocks a rank received.
"""

from __future__ import annotations

import collections
import contextlib
import math
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from .. import compat
from ..launch.mesh import REPLICA_AXES

AxisName = Union[str, Tuple[str, ...], None]

# Default logical -> mesh-axis rules (``repro/models/partitioning.py:
# 32-57``). The first candidate whose mesh axes exist on the installed mesh
# (and divide the dim, given one) wins.
DEFAULT_RULES: Dict[str, Tuple[AxisName, ...]] = {
    # activations
    "batch": (REPLICA_AXES, "data"),
    "seq": (None,),
    "embed": ("model", None),
    "heads": ("model",),
    "kv_heads": ("model", None),
    "head_dim": (None,),
    "ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    # parameters (storage)
    "p_embed": ("model", None),
    "p_vocab": ("model", None),
    "p_ff": ("model",),
    "p_heads": ("model",),
    "p_kv_heads": ("model", None),
    "p_head_dim": (None,),
    "p_experts": ("model",),
    "p_fsdp": ("data", None),
    "layers": (None,),
    # misc
    "kv_batch": (REPLICA_AXES, "data"),
    "kv_head_dim": ("model", None),
    "recurrent_width": ("model",),
}

# The logical axes a step keeps local when they resolve to "model": the
# dims the port's tensor-parallel compute splits (the decoder's heads, FFN
# columns, experts and vocabulary rows, and the KV caches' heads).
TP_AXES = frozenset({"p_heads", "p_kv_heads", "p_ff", "p_experts",
                     "p_vocab", "kv_heads"})
# The leaves of the modules that split over "model" in a decoder-only
# model: attention, FFN, experts, the embedding's rows and the head's
# columns. An encoder-decoder model is computed whole on every rank.
TP_LEAF = re.compile(r"(embed\.table|lm_head\.w|layers\.\d+\."
                     r"(attn|mlp|moe)\..*)$")
# The logical axes of data parallelism: local on whatever axes they take.
BATCH_AXES = frozenset({"batch", "kv_batch"})
MODEL = "model"


class _Ctx:
    """The installed mesh and rules, process-wide where the reference's
    are thread-local: autograd runs a CUDA backward, and the forward a
    checkpointed layer recomputes there, on a thread of its own, which must
    see the step's mesh. Each rank is one process with one step at a
    time."""

    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Tuple[AxisName, ...]] = dict(DEFAULT_RULES)
        self.batch_shards = 1
        self.view = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict] = None):
    """Install a mesh and a rule table (``DEFAULT_RULES`` updated by
    ``rules``) for model code (process-wide, :class:`_Ctx`)."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def current_mesh():
    return _CTX.mesh


@contextlib.contextmanager
def batch_split(dims: Sequence[int]):
    """Model code in this block runs on the rank's rows of a batch split
    over mesh ``dims`` (:func:`batch_shards` reads their count)."""
    old = _CTX.batch_shards
    _CTX.batch_shards = _shards(dims) if dims else 1
    try:
        yield
    finally:
        _CTX.batch_shards = old


@contextlib.contextmanager
def layer_view(view):
    """Model code in this block takes each layer's parameters through
    ``view(prefix, params)`` (:func:`current_view`): a step's gather of a
    layer's sharded leaves, run inside the layer's checkpoint so that the
    gathered weights live for one layer (FSDP's layer-by-layer gather)."""
    old = _CTX.view
    _CTX.view = view
    try:
        yield
    finally:
        _CTX.view = old


def current_view():
    """The installed layer view, or the identity."""
    return _CTX.view or (lambda prefix, params: params)


def batch_shards() -> int:
    """How many ranks the batch's rows are split over (1 outside
    :func:`batch_split`)."""
    return _CTX.batch_shards


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(compat.mesh_axis_names(mesh), compat.mesh_shape(mesh)))


def resolve_axis(logical: Optional[str],
                 dim_size: Optional[int] = None) -> AxisName:
    """One logical axis name -> mesh axis (or a tuple of them), or None
    (``repro/models/partitioning.py:93-113``)."""
    if logical is None or _CTX.mesh is None:
        return None
    sizes = _mesh_axis_sizes(_CTX.mesh)
    for cand in _CTX.rules.get(logical, (None,)):
        if cand is None:
            return None
        names = cand if isinstance(cand, tuple) else (cand,)
        if not all(n in sizes for n in names):
            continue
        if dim_size is not None and dim_size % math.prod(
                sizes[n] for n in names):
            continue
        return cand
    return None


def spec_for(logical_axes: Sequence[Optional[str]], shape=None) -> tuple:
    """The spec of a tensor whose dims carry ``logical_axes``: one entry
    per dim, a mesh axis, a tuple of them or None (a tuple of one axis is
    that axis, as a ``PartitionSpec`` normalizes it)."""
    spec = (resolve_axis(name, None if shape is None else shape[i])
            for i, name in enumerate(logical_axes))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def named_sharding(logical_axes: Sequence[Optional[str]], shape=None):
    """DTensor placements (one per mesh dim) of ``logical_axes`` on the
    installed mesh; None without one."""
    if _CTX.mesh is None:
        return None
    return compat.named_placements(_CTX.mesh, spec_for(logical_axes, shape))


def is_axes_leaf(v) -> bool:
    return isinstance(v, tuple) and all(
        isinstance(e, (str, type(None))) for e in v)


def tree_shardings(tree_logical, tree_shapes=None):
    """A tree of logical-axis tuples -> a tree of placements (None without
    a mesh); with ``tree_shapes`` (tensors, or anything with ``.shape``) the
    resolution is shape-aware."""
    if tree_shapes is None:
        return pytree.tree_map(named_sharding, tree_logical,
                               is_leaf=is_axes_leaf)
    return pytree.tree_map(
        lambda ax, t: named_sharding(ax, tuple(t.shape)), tree_logical,
        tree_shapes, is_leaf=is_axes_leaf)


# ---------------------------------------------------------------------------
# mesh geometry
# ---------------------------------------------------------------------------


def mesh_dims(entry: AxisName) -> Tuple[int, ...]:
    """Indices of the installed mesh's dims named by a spec entry."""
    if entry is None:
        return ()
    names = compat.mesh_axis_names(_CTX.mesh)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(names.index(a) for a in axes)


# The helpers below take the mesh explicitly or read the installed one;
# the backward functions pass the mesh of their forward.


def _shards(dims: Sequence[int], mesh=None) -> int:
    shape = compat.mesh_shape(_CTX.mesh if mesh is None else mesh)
    return math.prod(shape[d] for d in dims)


def block_index(dims: Sequence[int], mesh=None) -> int:
    """This rank's block along a tensor dim split over mesh ``dims``
    (row-major over their coordinates, as DTensor lays it out)."""
    mesh = _CTX.mesh if mesh is None else mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    shape = compat.mesh_shape(mesh)
    idx = 0
    for d in dims:
        idx = idx * shape[d] + coord[d]
    return idx


def model_dims() -> Tuple[int, ...]:
    """The installed mesh's ``"model"`` dim, when it has one of size > 1."""
    mesh = _CTX.mesh
    if mesh is None or MODEL not in compat.mesh_axis_names(mesh):
        return ()
    dims = mesh_dims(MODEL)
    return dims if _shards(dims) > 1 else ()


def model_size() -> int:
    dims = model_dims()
    return _shards(dims) if dims else 1


def model_index() -> int:
    dims = model_dims()
    return block_index(dims) if dims else 0


# ---------------------------------------------------------------------------
# collectives, routed by backend and device
# ---------------------------------------------------------------------------

# (collective, route) -> calls, and "<route> bytes" -> bytes of the other
# ranks' blocks that a rank received through gathers.
ROUTES: collections.Counter = collections.Counter()


def reset_routes() -> None:
    ROUTES.clear()


def _dist():
    import torch.distributed as dist

    return dist


def _group(d: int, mesh=None):
    return (_CTX.mesh if mesh is None else mesh).get_group(d)


def gather_route(t: torch.Tensor, d: int, mesh=None) -> str:
    """``"all_reduce"`` (the exact byte gather) for a CUDA tensor on a gloo
    group, else ``"all_gather"``."""
    backend = _dist().get_backend(_group(d, mesh))
    return "all_reduce" if (t.is_cuda and backend == "gloo") else "all_gather"


def _gather_one(t: torch.Tensor, dim: int, d: int, mesh) -> torch.Tensor:
    dist = _dist()
    group = _group(d, mesh)
    k = compat.mesh_shape(mesh)[d]
    route = gather_route(t, d, mesh)
    ROUTES[("gather", route)] += 1
    ROUTES[f"{route} bytes"] += (k - 1) * t.numel() * t.element_size()
    t = t.contiguous()
    if route == "all_reduce":
        idx = mesh.get_coordinate()[d]
        n = t.shape[dim]
        full = t.new_zeros(t.shape[:dim] + (n * k,) + t.shape[dim + 1:])
        full.narrow(dim, idx * n, n).copy_(t)
        if full.numel():
            # every byte has one nonzero contributor: the sum is exact
            dist.all_reduce(full.view(-1).view(torch.uint8), group=group)
        return full
    ranks = dist.get_process_group_ranks(group)
    grid = compat.mesh_grid(mesh)
    mesh_ranks = [int(r) for r in grid.swapaxes(-1, d).reshape(
        -1, k)[_row_of(d, mesh)]]
    if ranks != mesh_ranks:
        raise RuntimeError(f"mesh dim {d}'s group ranks {ranks} are not in "
                           f"its coordinate order {mesh_ranks}")
    parts = [torch.empty_like(t) for _ in range(k)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _row_of(d: int, mesh) -> int:
    """The row of this rank's ``d``-group in ``mesh.swapdims(-1, d)``."""
    coord = list(mesh.get_coordinate())
    shape = list(compat.mesh_shape(mesh))
    coord[d], coord[-1] = coord[-1], coord[d]
    shape[d], shape[-1] = shape[-1], shape[d]
    row = 0
    for c, s in zip(coord[:-1], shape[:-1]):
        row = row * s + c
    return row


def gather_exact(t: torch.Tensor, dim: int, dims: Sequence[int],
                 mesh=None) -> torch.Tensor:
    """All blocks of tensor dim ``dim`` split over mesh ``dims``, exactly
    (no autograd)."""
    mesh = _CTX.mesh if mesh is None else mesh
    for d in reversed(tuple(dims)):  # innermost first: row-major blocks
        t = _gather_one(t, dim, d, mesh)
    return t


def slice_local(t: torch.Tensor, dim: int, dims: Sequence[int],
                mesh=None) -> torch.Tensor:
    """This rank's block of tensor dim ``dim`` split over mesh ``dims``."""
    if not dims:
        return t
    k = _shards(dims, mesh)
    if t.shape[dim] % k:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {k} ranks")
    n = t.shape[dim] // k
    return t.narrow(dim, block_index(dims, mesh) * n, n)


def all_reduce_sum(t: torch.Tensor, dims: Sequence[int],
                   mesh=None) -> torch.Tensor:
    """The sum over mesh ``dims`` of a fresh copy of ``t`` (no autograd);
    a 16-bit float tensor is summed in f32 and rounded once."""
    dist = _dist()
    out = t.detach().to(torch.float32 if t.element_size() == 2
                        and t.is_floating_point() else t.dtype,
                        copy=True).contiguous()
    for d in dims:
        group = _group(d, mesh)
        ROUTES[("all_reduce", str(dist.get_backend(group)))] += 1
        dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, dims):
        ctx.dim, ctx.dims, ctx.mesh = dim, dims, _CTX.mesh
        return gather_exact(t, dim, dims)

    @staticmethod
    def backward(ctx, ct):
        return (slice_local(ct, ctx.dim, ctx.dims, ctx.mesh).contiguous(),
                None, None)


class _Slice(torch.autograd.Function):
    """A whole value's local block; its gradient is gathered, so every rank
    holds the whole value's gradient."""

    @staticmethod
    def forward(ctx, t, dim, dims):
        ctx.dim, ctx.dims, ctx.mesh = dim, dims, _CTX.mesh
        return slice_local(t, dim, dims).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return (gather_exact(ct.contiguous(), ctx.dim, ctx.dims, ctx.mesh),
                None, None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims):
        ctx.dims, ctx.mesh = dims, _CTX.mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.dims, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims):
        return all_reduce_sum(t, dims)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Mean(torch.autograd.Function):
    """The mean over mesh ``dims`` of a value each rank computed on its own
    data: the sum times ``f32(1/n)``; each rank's gradient is its share."""

    @staticmethod
    def forward(ctx, t, dims):
        ctx.inv = 1.0 / _shards(dims)
        return all_reduce_sum(t, dims) * ctx.inv

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.inv, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """Enter a tensor-parallel region over ``"model"``: the identity, whose
    gradient (each rank's partial) is summed over ``"model"``."""
    dims = model_dims()
    return _Enter.apply(x, dims) if dims else x


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Leave a region: the sum over ``"model"`` of the ranks' partial
    sums (identity gradient)."""
    dims = model_dims()
    return _Reduce.apply(x, dims) if dims else x


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Leave a region: the exact gather over ``"model"`` of tensor dim
    ``dim``; the gradient is the rank's slice."""
    dims = model_dims()
    return _Gather.apply(x, dim, dims) if dims else x


def grad_summed(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The identity, whose gradient is summed over mesh ``dims``: a
    parameter entering a data-parallel loss."""
    return _Enter.apply(x, tuple(dims)) if dims else x


def mean_over(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    return _Mean.apply(x, tuple(dims)) if dims else x


# ---------------------------------------------------------------------------
# storage and compute layouts
# ---------------------------------------------------------------------------


def local_dims(logical_axes: Sequence[Optional[str]], shape, *,
               tp: bool = True) -> Dict[int, tuple]:
    """``{tensor dim: mesh dims}`` of the dims a step keeps local: batch
    axes on whatever they resolve to and, for a tensor of a module that
    splits over ``"model"`` (``tp``), :data:`TP_AXES` where they resolve
    to ``"model"`` alone."""
    out = {}
    for i, (name, entry) in enumerate(zip(logical_axes,
                                          spec_for(logical_axes, shape))):
        if entry is None:
            continue
        if name in BATCH_AXES or (tp and _splits(name, entry)):
            out[i] = mesh_dims(entry)
    return out


def _splits(logical: Optional[str], entry: AxisName) -> bool:
    """A dim of logical axis ``logical`` resolved to ``entry`` is split
    over ``"model"`` by a module that splits (:func:`tp_leaf`)."""
    return logical in TP_AXES and entry == MODEL


def tp_model(cfg) -> bool:
    """Whether ``cfg``'s modules split over ``"model"`` at all (a
    decoder-only model; its caches' kv heads with them)."""
    return not cfg.is_encoder_decoder


def tp_leaf(cfg, name: str) -> bool:
    """Whether the parameter ``name`` belongs to a module that splits over
    ``"model"`` (:data:`TP_LEAF`): the ``tp`` of :func:`local_dims` for
    it."""
    return tp_model(cfg) and bool(TP_LEAF.match(name))


def local_block(cfg, w: torch.Tensor, dim: int, logical: Optional[str],
                size: int) -> bool:
    """Whether a split module's weight ``w`` holds the rank's block of its
    dim ``dim`` (logical axis ``logical``, ``size`` in the whole weight):
    the decision :func:`local_dims` makes for the step's layout, read
    here by the module. Raises where ``w``'s extent is not the one that
    decision gives, so no module takes the other path unnoticed."""
    split = tp_model(cfg) and _CTX.mesh is not None and _splits(
        logical, spec_for((logical,), (size,))[0])
    m = model_size() if split else 1
    if w.shape[dim] * m != size:
        raise ValueError(
            f"a weight whose dim {dim} ({logical}) holds {size} has "
            f"{w.shape[dim]} on this rank, where the layout gives {size // m}")
    return m > 1


def sharded_dims(logical_axes: Sequence[Optional[str]], shape) -> Dict[int, tuple]:
    """``{tensor dim: mesh dims}`` of every dim the spec shards."""
    return {i: mesh_dims(e) for i, e in
            enumerate(spec_for(logical_axes, shape)) if e is not None}


def storage_local(x: torch.Tensor, logical_axes, shape) -> torch.Tensor:
    """This rank's storage block of a value of global ``shape``: a
    DTensor's local shard (redistributed first if its placements are not
    the spec's), or the slices of a whole plain tensor."""
    from ..core import sharding

    if sharding.is_dtensor(x):
        want = named_sharding(logical_axes, shape)
        if list(x.placements) != want:
            x = redistribute(x, logical_axes)
        return x.to_local()
    for i, dims in sharded_dims(logical_axes, shape).items():
        x = slice_local(x, i, dims)
    return x


def to_compute(x: torch.Tensor, logical_axes, shape, *,
               whole: bool = False, tp: bool = True) -> torch.Tensor:
    """The layout the model code runs on, from the storage block (or, with
    ``whole``, from the whole value every rank holds): local dims stay
    local, the other sharded dims are gathered (storage) or kept whole.
    Differentiable: a gather's gradient is the rank's slice, and a whole
    value's slice gathers its gradient, so a whole value's gradient is
    whole on every rank."""
    keep = local_dims(logical_axes, shape, tp=tp)
    if whole:
        for i, dims in keep.items():
            x = _Slice.apply(x, i, dims)
        return x
    for i, dims in sharded_dims(logical_axes, shape).items():
        if i not in keep:
            x = _Gather.apply(x, i, dims)
    return x


def to_storage(x: torch.Tensor, logical_axes, shape, *,
               tp: bool = True) -> torch.Tensor:
    """A compute-layout value -> its storage block (a slice of the dims the
    storage shards and the compute held whole)."""
    keep = local_dims(logical_axes, shape, tp=tp)
    for i, dims in sharded_dims(logical_axes, shape).items():
        if i not in keep:
            x = slice_local(x, i, dims)
    return x.contiguous()


def wrap(local: torch.Tensor, logical_axes, shape) -> torch.Tensor:
    """The DTensor of a storage block (no communication)."""
    from torch.distributed.tensor import DTensor

    from ..core import sharding

    shape = tuple(int(s) for s in shape)
    return DTensor.from_local(
        local, _CTX.mesh, named_sharding(logical_axes, shape),
        run_check=False, shape=torch.Size(shape),
        stride=sharding.contiguous_stride(shape))


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (routed exact gathers; a partial
    placement is summed), or ``x`` itself."""
    from torch.distributed.tensor import Partial, Shard

    from ..core import sharding

    if not sharding.is_dtensor(x):
        return x
    local = x.to_local()
    by_dim: Dict[int, list] = {}
    partial = []
    for d, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            by_dim.setdefault(pl.dim, []).append(d)
        elif isinstance(pl, Partial):
            partial.append(d)
    with axis_rules(x.device_mesh, _CTX.rules):
        if partial:
            local = all_reduce_sum(local, partial)
        for dim, dims in by_dim.items():
            local = gather_exact(local, dim, dims)
    return local


def redistribute(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """A DTensor at the installed spec, through the routed collectives
    (DTensor's own redistribution would call ``all_gather``, which gloo
    lacks for CUDA tensors)."""
    whole = full(x)
    shape = tuple(whole.shape)
    local = whole
    for i, dims in sharded_dims(logical_axes, shape).items():
        local = slice_local(local, i, dims)
    return wrap(local.contiguous(), logical_axes, shape)


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]]):
    """Constrain ``x`` to the spec of ``logical_axes`` (a no-op without a
    mesh, as the reference's), after checking that the spec names each of
    its dims. On a mesh a DTensor is redistributed to the spec. The steps
    hand the model code plain local tensors, laid out by the explicit
    collectives that take the place of GSPMD's constraints (:func:`enter`,
    :func:`reduce_sum`, :func:`gather`), and such a tensor is returned as
    it is: the call sites mark where the reference constrains."""
    from ..core import sharding

    if x.ndim != len(logical_axes):
        raise ValueError(f"a constraint of {len(logical_axes)} axes "
                         f"{tuple(logical_axes)} on a tensor of shape "
                         f"{tuple(x.shape)}")
    if _CTX.mesh is None:
        return x
    if sharding.is_dtensor(x):
        if list(x.placements) != named_sharding(logical_axes, tuple(x.shape)):
            return redistribute(x, logical_axes)
    return x
