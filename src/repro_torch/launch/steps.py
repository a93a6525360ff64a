"""Serve steps over the slot pool (``repro/launch/steps.py:272-506``).

The serve half of the reference's step builders:

* :func:`make_prefill_step` / :func:`make_decode_step`: a whole prompt into
  fresh caches (attention through ``self_attention``: K2 on the card), and
  one decode step of such caches;
* the slot-pool steps of the continuous-batching runtime
  (``launch/serve.py``): :func:`make_slot_decode_step` (every slot one
  token), :func:`make_slot_chunk_step` (one prompt chunk into one slot) and
  the fused :func:`make_serve_step` (both in one step), with
  :func:`_gather_slot`, :func:`_scatter_slot` and :func:`_reset_if`.

On a mesh whose data ranks split the pool's slots (``kv_batch``), a rank
holds and decodes its block of them and the next tokens reach every rank
by an exact gather (:func:`_slot_step_on_mesh`).

The pool is the scheduler's state for the life of the server, as the
reference's donated pool is: every step writes it in place, and writes the
greedy next tokens into the token feed ``tokens`` (slots, 1) int32 in
place, so steps chain on the device. Their scalar inputs (``cslot`` (1,)
int64, ``cpos`` () int32, ``cfirst`` and ``cemit`` () bool) are device
tensors, so nothing in a step reads a value on the host.

The reference ``vmap``s a batch-1 decode over the slots, so a request's
tokens cannot depend on who else is in flight. The port decodes the slots
as one batch whose rows each carry their own position (the pool's
position leaves hold one entry per slot, and ``attention.decode_attention``
masks and writes per row), and the pool's shapes are fixed. Every
operation of the decode leg acts on each row alone but one: an MoE
layer's expert capacity couples the tokens of a routing group, so two
slots routed together that pick the same expert could drop one of them,
and a free slot's garbage could evict a live token. The decode leg
therefore routes each row as its own group of one token
(``registry.make_decode_fn(cfg, route_rows=True)``; only these steps
pass it, and a plain decode step routes its batch as one group, as the
reference's ``decode_step``), which is what the reference's batch-1
decode of each slot does; the chunk leg of the fused
step routes the chunk's tokens as their own groups, as the reference's
separate chunk call. So a row's result is the same whatever the other
rows hold.

The serve runtime runs each step through ``runtime.executor.CudaGraphs``
keyed by chunk bucket: on the card its first call for a key runs eagerly
on a side stream, then the same call is captured into a CUDA graph
(recorded, not run) over the same static buffers, and every later call
replays it: the counterpart of the reference's ``jax.jit`` with the pool
donated, one executable per chunk bucket and one decode step. On the CPU
every call runs eagerly. Either way the first call for a key counts as a
build on its ``runtime.executor.TraceCounter``.

The training steps (``repro/launch/steps.py:33-270``):
:func:`make_sgd_train_step` (the production data- and model-parallel
step, FSDP by rule) and :func:`make_drjax_round_step` (the paper's local
SGD / DiLoCo round), with the rule chains :func:`fsdp_rules` and
:func:`strategy_rules` and the input specs (``meta`` tensors).

On a mesh every step is SPMD: each rank of the ``DeviceMesh`` calls it.
An input is a DTensor at the placements of the step's ``shardings_for``,
or a whole plain tensor that every rank holds; the step takes the rank's
storage block of each, moves it to the layout the model code runs on
(``models/partitioning.py``: the rank's heads, FFN columns, experts,
vocabulary rows and batch rows stay local, every other sharded dim is
gathered exactly, a decoder layer's leaves inside the layer through
``partitioning.layer_view``, so under remat a layer's gathered weights
live for that layer alone), runs the model with its tensor-parallel
collectives,
and returns DTensors at the output placements (a train step's loss, and
a round's values, whole). Data parallelism is in the loss
(:func:`dp_loss`): each rank's parameters enter with their gradient
summed over the batch's mesh axes, and the loss is the mean over them of
the ranks' losses, so ``torch.autograd.grad`` of it is the whole batch's
gradient on every rank. The decoder-only models' attention, FFN, MoE,
embedding and head split over ``"model"``; the leaves of the modules the
port computes whole (the encoder-decoder's, the RG-LRU's and RWKV's, and
head-dim splits) keep their sharded storage and are gathered for the
compute, as FSDP's are. With ``mesh=None`` every builder returns the
mesh-free step of earlier slices, unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional

import torch
from torch.utils import _pytree as pytree

from .. import compat, optim
from ..algorithms.rounds import LocalSGDConfig, make_local_sgd_round
from ..models import partitioning, registry
from ..models.partitioning import axis_rules
from ..optim.optimizers import apply_updates
from .mesh import REPLICA_AXES, partition_axes_for

MODEL = partitioning.MODEL


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def fsdp_rules(enable: bool):
    return {"p_fsdp": (("data",), None) if enable else (None,)}


def strategy_rules(cfg, fsdp: bool):
    """Logical-axis rules for ``cfg.mesh_strategy`` (``repro/launch/
    steps.py:73-122``). ``tp``: model dims over "model" (Megatron), batch
    over (pod, data). ``dp``: the model axis is more data parallelism,
    batch over (pod, data, model), model dims replicated."""
    rules = dict(fsdp_rules(fsdp))
    if cfg.mesh_strategy == "dp":
        dp_chain = (REPLICA_AXES + (MODEL,), REPLICA_AXES[1:] + (MODEL,),
                    REPLICA_AXES, "data")
        rules.update({
            "batch": dp_chain, "kv_batch": dp_chain, "heads": (None,),
            "kv_heads": (None,), "kv_head_dim": (None,), "embed": (None,),
            "ff": (None,), "experts": (None,), "vocab": (None,),
            "recurrent_width": (None,), "p_heads": (None,),
            "p_kv_heads": (None,), "p_ff": (None,), "p_experts": (None,),
            "p_vocab": (None,),
            "p_fsdp": ((REPLICA_AXES[1:] + (MODEL,),) + (("data",), None))
            if fsdp else (None,)})
    return rules


def _optimizer_axes(opt_kind: str, param_axes):
    if opt_kind == "adamw":
        return {"step": (), "m": param_axes, "v": param_axes}
    return {"step": ()}


# ---------------------------------------------------------------------------
# layouts on a mesh
# ---------------------------------------------------------------------------

def _shape(x) -> tuple:
    return tuple(int(s) for s in x.shape)


def _localize(x, axes, *, tp: bool = True) -> torch.Tensor:
    """The compute layout of a step input: a DTensor's storage block moved
    there, or a whole tensor's local slices."""
    from ..core import sharding

    shape = _shape(x)
    if sharding.is_dtensor(x):
        local = partitioning.storage_local(x, axes, shape)
        return partitioning.to_compute(local, axes, shape, tp=tp)
    return partitioning.to_compute(x, axes, shape, whole=True, tp=tp)


def _publish(x: torch.Tensor, axes, shape, *, tp: bool = True):
    """A compute-layout output as a DTensor at its storage placements."""
    return partitioning.wrap(partitioning.to_storage(x, axes, shape, tp=tp),
                             axes, shape)


def batch_dims(batch) -> tuple:
    """The mesh dims the installed rules shard the batch's rows over (none
    without a mesh)."""
    if partitioning.current_mesh() is None:
        return ()
    lead = _shape(pytree.tree_leaves(batch)[0])[0]
    return partitioning.mesh_dims(partitioning.resolve_axis("batch", lead))


def dp_loss(cfg, param_axes: Dict[str, tuple], shapes: Dict[str, tuple],
            batch_axes: Dict[str, tuple], *, whole: bool = False):
    """``loss(params, batch)`` on the installed mesh: the parameters (the
    rank's storage blocks, or ``whole`` values every rank holds) enter the
    compute layout with their gradients summed over the batch's mesh
    dims, each rank runs ``registry.loss_fn`` on its batch rows, and the
    result is the mean of the ranks' losses (equal-size shards of an
    unmasked mean). Without a mesh, ``registry.loss_fn`` itself."""
    base = functools.partial(registry.loss_fn, cfg)

    def loss(params, batch):
        if partitioning.current_mesh() is None:
            return base(params, batch)
        dims = batch_dims(batch)

        def compute(name, v):
            # the gradient is summed in the compute layout, where every
            # rank of the batch's mesh dims holds the same block
            return partitioning.grad_summed(partitioning.to_compute(
                v, param_axes[name], shapes[name], whole=whole,
                tp=partitioning.tp_leaf(cfg, name)), dims)

        lb = {k: _localize(v, batch_axes[k]) for k, v in batch.items()}
        with partitioning.batch_split(dims), partitioning.layer_view(
                _view(cfg, compute)):
            cp = {k: v if _per_layer(cfg, k) else compute(k, v)
                  for k, v in params.items()}
            return partitioning.mean_over(base(cp, lb), dims)

    return loss


def _per_layer(cfg, name: str) -> bool:
    """Whether the model takes ``name`` through a layer view (a
    decoder-only stack's layer leaf)."""
    return not cfg.is_encoder_decoder and name.startswith("layers.")


def _view(cfg, compute):
    """The layer view of a step: each leaf of a layer through
    ``compute(name, leaf)``."""
    if cfg.is_encoder_decoder:
        return None

    def view(prefix, params):
        return {k: compute(prefix + k, v) for k, v in params.items()}

    return view


def _shapes_of(tree):
    return pytree.tree_map(_shape, tree)


def _axes_map(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over a tree whose leaves are axes tuples."""
    return pytree.tree_map(fn, axes_tree, *trees,
                           is_leaf=partitioning.is_axes_leaf)


def _shardings(axes_tree, mesh, rules, spec_tree=None):
    """Axes tree -> placements (shape-aware with ``spec_tree``)."""
    with axis_rules(mesh, rules):
        return partitioning.tree_shardings(axes_tree, spec_tree)


# ---------------------------------------------------------------------------
# the production train step
# ---------------------------------------------------------------------------


def make_sgd_train_step(cfg, mesh=None, *, optimizer: str = "adamw",
                        lr: float = 3e-4, fsdp: bool = True,
                        remat: Optional[str] = None):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    loss) and ``shardings_for((param_specs, opt_specs, batch_specs))`` ->
    (input placements, output placements) (``repro/launch/steps.py:
    130-170``). AdamW (or SGD) runs elementwise on each rank's storage
    blocks; on a mesh the new parameters and state are DTensors."""
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    kind = "adamw" if optimizer == "adamw" else "sgd"
    opt = optim.adamw(lr) if kind == "adamw" else optim.sgd(lr)
    rules = strategy_rules(cfg, fsdp)
    p_axes = registry.param_axes(cfg)
    shapes = _shapes_of(registry.param_specs(cfg))
    o_axes = _optimizer_axes(kind, p_axes)
    b_axes = registry.batch_axes(cfg)
    loss_fn = dp_loss(cfg, p_axes, shapes, b_axes)

    def train_step(params, opt_state, batch):
        # the batch split spans the backward too: a checkpointed layer's
        # forward runs again there
        with axis_rules(mesh, rules), partitioning.batch_split(
                batch_dims(batch)):
            o_shapes = _shapes_of(opt_state)
            if mesh is not None:
                params = {k: partitioning.storage_local(v, p_axes[k],
                                                        shapes[k])
                          for k, v in params.items()}
                opt_state = _axes_map(
                    lambda ax, x, shp: partitioning.storage_local(x, ax, shp),
                    o_axes, opt_state, o_shapes)
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}
                loss = loss_fn(leaves, batch)
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            with torch.no_grad():
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
            if mesh is not None:
                params = {k: partitioning.wrap(v, p_axes[k], shapes[k])
                          for k, v in params.items()}
                opt_state = _axes_map(
                    lambda ax, x, shp: partitioning.wrap(x, ax, shp), o_axes,
                    opt_state, o_shapes)
        return params, opt_state, loss.detach()

    def shardings_for(specs):
        p_spec, o_spec, b_spec = specs
        param_sh = _shardings(p_axes, mesh, rules, p_spec)
        opt_sh = _shardings(o_axes, mesh, rules, o_spec)
        batch_sh = _shardings(b_axes, mesh, rules, b_spec)
        loss_sh = (None if mesh is None
                   else compat.replicated_placements(mesh))
        return (param_sh, opt_sh, batch_sh), (param_sh, opt_sh, loss_sh)

    return train_step, shardings_for


def train_input_specs(cfg, batch: int, seq: int, *,
                      optimizer: str = "adamw"):
    """(params, opt_state, batch) of :func:`make_sgd_train_step` as
    ``meta`` tensors: global shapes, the same on any mesh (its
    ``shardings_for`` places them)."""
    params = registry.param_specs(cfg)
    opt = optim.adamw(3e-4) if optimizer == "adamw" else optim.sgd(0.1)
    return (params, opt.init(params),
            registry.train_batch_spec(cfg, batch, seq))


def shard_tree(tree, placements_axes, mesh, rules=None):
    """Whole values every rank holds -> DTensors at the placements their
    logical axes resolve to (each rank keeps its block: no
    communication). ``placements_axes`` is the tree of logical axes."""
    with axis_rules(mesh, rules):
        return _axes_map(
            lambda ax, x: partitioning.wrap(partitioning.storage_local(
                x, ax, _shape(x)).contiguous(), ax, _shape(x)),
            placements_axes, tree)


# ---------------------------------------------------------------------------
# the DrJAX round step
# ---------------------------------------------------------------------------


def _server_opt(server: str, *, specs: bool = False):
    if server == "fedavg":
        return optim.fedavg_momentum(1.0)
    if server == "diloco":
        return (optim.diloco_optimizer() if specs
                else optim.diloco_optimizer(0.7, 0.9))
    if server == "fedadam":
        return optim.fedadam() if specs else optim.fedadam(1e-2)
    raise ValueError(f"server {server!r}: fedavg, diloco or fedadam")


def make_drjax_round_step(cfg, mesh=None, *, partition_size: int,
                          num_local_steps: int = 4, client_lr: float = 0.05,
                          server: str = "fedavg",
                          use_sharding_annotations: bool = True,
                          compression: Optional[str] = None,
                          fsdp: bool = False, jit_donated: bool = False):
    """``(round_step, param_sh, server_sh, data_sharding)``
    (``repro/launch/steps.py:178-250``): ``round_step(params,
    server_state, round_data)`` -> (params, server_state, metrics), the
    clients over the mesh's partition axes (``mesh.partition_axes_for``).

    Inside a client the partition axes belong to the round, so the
    client's batch rows shard over the remaining ``"model"`` axis under
    the ``dp`` strategy and over nothing under ``tp``, whose model dims
    split over ``"model"`` (``client_batch_chain``, ``:205-209``). The
    round's parameters and server state are whole values (DrJAX's server
    values): each client takes its split inside its loss. ``jit_donated``
    traces the round once, plans it and runs the compiled plan
    (``runtime.executor.compile_plan``) with the parameters and server
    state donated (mesh-free: the collectives of a client's loss on a
    mesh have no traced form here, so it raises with a mesh)."""
    rules = strategy_rules(cfg, fsdp)
    chain = (MODEL, None) if cfg.mesh_strategy == "dp" else (None,)
    rules["batch"] = chain
    rules["kv_batch"] = chain
    p_axes = registry.param_axes(cfg)
    shapes = _shapes_of(registry.param_specs(cfg))
    if mesh is not None and jit_donated:
        raise NotImplementedError(
            "jit_donated rounds are mesh-free: a client's loss on a mesh "
            "runs collectives that the plan's trace cannot hold")
    client_loss = dp_loss(cfg, p_axes, shapes, registry.batch_axes(cfg),
                          whole=True)
    server_opt = _server_opt(server)
    part_axes = partition_axes_for(mesh)
    round_cfg = LocalSGDConfig(
        partition_size=partition_size, num_local_steps=num_local_steps,
        partition_axes=part_axes, mesh=mesh,
        use_sharding_annotations=use_sharding_annotations,
        compression=compression)
    inner = make_local_sgd_round(client_loss, optim.sgd(client_lr),
                                 server_opt, round_cfg)

    def round_step(params, server_state, round_data):
        with axis_rules(mesh, rules):
            # a client's batch rows (the leaves' third dim) as its loss
            # splits them, over its gradients' recomputed forwards too
            rows = _shape(pytree.tree_leaves(round_data)[0])[2]
            dims = () if mesh is None else partitioning.mesh_dims(
                partitioning.resolve_axis("batch", rows))
            with partitioning.batch_split(dims):
                return inner(params, server_state, round_data)

    if jit_donated:
        round_step = _compiled_round(round_step, partition_size)

    server_axes = ({"step": (), "mu": p_axes} if server == "diloco" else
                   {"step": (), "m": p_axes, "v": p_axes}
                   if server == "fedadam" else {"step": ()})
    param_sh = _shardings(p_axes, mesh, rules)
    server_sh = _shardings(server_axes, mesh, rules)
    lead = (part_axes if isinstance(part_axes, (str, type(None)))
            else tuple(part_axes))

    def data_sharding(spec):
        if mesh is None:
            return None
        return compat.named_placements(
            mesh, (lead,) + (None,) * (len(spec.shape) - 1))

    return round_step, param_sh, server_sh, data_sharding


def _compiled_round(round_step, partition_size: int):
    """The round as a compiled plan with the parameters and server state
    donated: traced, planned and compiled at the first call, then run."""
    from ..core import interpreter as interp
    from ..runtime import executor

    cache = {}

    def run(params, server_state, round_data):
        flat, spec = pytree.tree_flatten((params, server_state, round_data))
        n_carry = len(pytree.tree_leaves((params, server_state)))
        if "plan" not in cache:
            gm = interp.trace(round_step, params, server_state, round_data)
            plan = interp.build_plan(
                gm, {"clients": partition_size},
                partitioned_invars=[0] * n_carry + [1] * (len(flat) - n_carry))
            device = pytree.tree_leaves(params)[0].device.type
            cache["plan"] = executor.compile_plan(
                plan, device=device, donate_argnums=tuple(range(n_carry)))
            # the round returns (params, server_state, {"loss": ()})
            cache["out"] = pytree.tree_structure(
                (params, server_state, {"loss": flat[0]}))
        outs = cache["plan"](*flat)
        return pytree.tree_unflatten(list(outs), cache["out"])

    return run


def drjax_round_specs(cfg, *, partition_size: int, num_local_steps: int,
                      local_batch: int, seq: int, server: str = "fedavg"):
    """(params, server_state, round_data) as ``meta`` tensors."""
    params = registry.param_specs(cfg)
    state = _server_opt(server, specs=True).init(params)
    shape = (partition_size, num_local_steps, local_batch, seq)
    data = {k: torch.empty(shape, dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    return params, state, data


def _serve_fsdp(cfg, fsdp):
    return (cfg.family == "moe") if fsdp is None else fsdp


class _MeshServe:
    """A serve step on a mesh: the rank's inputs in the compute layout
    (TP rules: serving shards caches over "model" whatever the train
    strategy, ``repro/launch/steps.py:280-285``), the mesh-free step's
    function on them, its caches back as DTensors at their placements."""

    def __init__(self, cfg, mesh, fsdp):
        self.cfg, self.mesh = cfg, mesh
        self.rules = fsdp_rules(_serve_fsdp(cfg, fsdp))
        self.p_axes = registry.param_axes(cfg)
        # a whole parameter's compute layout is a view of it (the rank's
        # slices), the same at every call: name -> (the parameter, view)
        self._views: Dict[str, tuple] = {}

    def _local(self, name, v):
        from ..core import sharding

        seen = self._views.get(name)
        if seen is not None and seen[0] is v:
            return seen[1]
        local = _localize(v, self.p_axes[name],
                          tp=partitioning.tp_leaf(self.cfg, name))
        if not sharding.is_dtensor(v):
            self._views[name] = (v, local)
        return local

    @contextlib.contextmanager
    def params(self, params):
        """The parameters in the compute layout, a layer's leaves taken
        through the installed layer view (gathered one layer at a
        time)."""
        with partitioning.layer_view(_view(self.cfg, self._local)):
            yield {k: v if _per_layer(self.cfg, k) else self._local(k, v)
                   for k, v in params.items()}

    def caches_in(self, caches, axes=None):
        axes = registry.cache_axes(self.cfg) if axes is None else axes
        shapes = _shapes_of(caches)
        tp = partitioning.tp_model(self.cfg)
        local = _axes_map(lambda ax, x: _localize(x, ax, tp=tp), axes, caches)
        return local, axes, shapes

    def caches_out(self, local, axes, shapes, given=None):
        """The compute-layout caches as DTensors at their placements; a leaf
        that is still the local tensor of ``given``'s DTensor (updated in
        place) returns that DTensor."""
        from ..core import sharding

        tp = partitioning.tp_model(self.cfg)

        def one(ax, x, shp, old=None):
            if (old is not None and sharding.is_dtensor(old)
                    and old.to_local() is x):
                return old
            return _publish(x, ax, shp, tp=tp)

        if given is None:
            return _axes_map(one, axes, local, shapes)
        return _axes_map(one, axes, local, shapes, given)

    def shardings_for(self, what: str):
        def fn(specs):
            with axis_rules(self.mesh, self.rules):
                sh = partitioning.tree_shardings
                if what == "prefill":
                    params, batch = specs
                    return (sh(self.p_axes, params),
                            sh(registry.batch_axes(self.cfg), batch))
                params, token, caches, memkv = specs
                kv = ("kv_batch", "seq", "kv_heads", "head_dim")
                return (sh(self.p_axes, params),
                        partitioning.named_sharding(("batch", None),
                                                    _shape(token)),
                        sh(registry.cache_axes(self.cfg), caches),
                        None if memkv is None else
                        [tuple(partitioning.named_sharding(kv, _shape(m))
                               for m in pair) for pair in memkv])
        return fn


def make_prefill_step(cfg, mesh=None, *, fsdp: Optional[bool] = None,
                      tp_comm: Optional[str] = None,
                      max_len: Optional[int] = None):
    """``prefill_step(params, batch)`` -> (last logits (B, V), caches sized
    for ``max_len``) (``repro/launch/steps.py:276``); an encoder-decoder's
    batch holds ``frames`` beside ``tokens`` (``registry.make_prefill_fn``).
    ``tp_comm="int8"`` reduces the FFN's (and MoE combine's) tensor-parallel
    partial sums in int8 on a mesh. On a mesh the caches are DTensors and
    ``prefill_step.shardings_for((param_specs, batch_specs))`` gives the
    input placements."""
    if tp_comm:
        cfg = dataclasses.replace(cfg, tp_comm=tp_comm)
    inner = registry.make_prefill_fn(cfg, max_len=max_len)
    if mesh is None:

        def prefill_step(params, batch):
            with torch.no_grad():
                return inner(params, batch)

        return prefill_step

    ms = _MeshServe(cfg, mesh, fsdp)
    b_axes = registry.batch_axes(cfg)
    prefill_step = _prefill_on_mesh(cfg, mesh, ms, inner, b_axes)
    prefill_step.shardings_for = ms.shardings_for("prefill")
    return prefill_step


def _global_cache_shapes(cfg, caches, rows: int):
    """The global shapes of compute-layout caches: ``rows`` batch rows, the
    rank's kv heads times the ranks of "model" where the heads split."""
    axes = registry.cache_axes(cfg)
    tp = partitioning.tp_model(cfg)

    def one(ax, x):
        if not x.ndim:
            return ()
        shape = (rows,) + _shape(x)[1:]
        for i, dims in partitioning.local_dims(ax, shape, tp=tp).items():
            if i:
                shape = shape[:i] + (shape[i] * partitioning._shards(dims),) \
                    + shape[i + 1:]
        return shape

    return _axes_map(one, axes, caches)


def _prefill_on_mesh(cfg, mesh, ms, inner, b_axes):
    def prefill_step(params, batch):
        with axis_rules(mesh, ms.rules), torch.no_grad():
            rows = _shape(pytree.tree_leaves(batch)[0])[0]
            lb = {k: _localize(v, b_axes[k]) for k, v in batch.items()}
            with partitioning.batch_split(batch_dims(batch)), \
                    ms.params(params) as cp:
                logits, caches = inner(cp, lb)
            axes = registry.cache_axes(cfg)
            caches = ms.caches_out(caches, axes,
                                   _global_cache_shapes(cfg, caches, rows))
            return logits, caches

    return prefill_step


def make_decode_step(cfg, mesh=None, *, fsdp: Optional[bool] = None):
    """``decode_step(params, token (B, 1), caches)`` -> (logits (B, V),
    caches) (``repro/launch/steps.py:302``); an encoder-decoder's is
    ``decode_step(params, token, caches, memory_kv)`` (``:304-307``). On a
    mesh the caches come and go as DTensors (or whole tensors in), and
    ``decode_step.shardings_for((params, token, caches, memory_kv))`` gives
    the placements."""
    inner = registry.make_decode_fn(cfg)
    if mesh is None:
        if cfg.is_encoder_decoder:

            def decode_step(params, token, caches, memory_kv):
                with torch.no_grad():
                    return inner(params, token, caches, memory_kv)

            return decode_step

        def decode_step(params, token, caches):
            with torch.no_grad():
                return inner(params, token, caches)

        return decode_step

    ms = _MeshServe(cfg, mesh, fsdp)
    kv = ("kv_batch", "seq", "kv_heads", "head_dim")

    def decode_step(params, token, caches, memory_kv=None):
        with axis_rules(mesh, ms.rules), torch.no_grad():
            local, axes, shapes = ms.caches_in(caches)
            extra = () if memory_kv is None else (
                [tuple(_localize(m, kv, tp=False) for m in pair)
                 for pair in memory_kv],)
            with partitioning.batch_split(batch_dims(token)), \
                    ms.params(params) as cp:
                logits, local = inner(cp, _localize(token, ("batch", None)),
                                      local, *extra)
            return logits, ms.caches_out(local, axes, shapes)

    decode_step.shardings_for = ms.shardings_for("decode")
    return decode_step


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------


def _gather_slot(pool, dims, cslot: torch.Tensor):
    """Slot ``cslot`` ((1,) int64) of the pool as a batch-1 cache
    (``repro/launch/steps.py:346``): batch-bearing leaves keep a batch axis
    of 1, position leaves drop their slot axis. A copy: the slot's leaves
    are not views of the pool."""
    return pytree.tree_map(
        lambda leaf, d: (leaf.index_select(0, cslot).reshape(leaf.shape[1:])
                         if d == registry.POS_LEAF
                         else leaf.index_select(0, cslot)), pool, dims)


def _scatter_slot(pool, cache, dims, cslot: torch.Tensor):
    """Write a batch-1 cache back into slot ``cslot`` of the pool, in place
    (``repro/launch/steps.py:362``)."""
    pytree.tree_map(
        lambda leaf, c, d: leaf.index_copy_(
            0, cslot, c.reshape((1,) + tuple(c.shape)) if d == registry.POS_LEAF
            else c), pool, cache, dims)
    return pool


def _reset_if(first: torch.Tensor, cache):
    """Zero a gathered slot's cache where ``first`` (a () bool tensor) is
    set, in place: a reused slot must not see its previous request's keys,
    states or position (``repro/launch/steps.py:374``)."""
    pytree.tree_map(lambda leaf: leaf.masked_fill_(first, 0), cache)
    return cache


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _keep_unless(own, new_cache, old_cache):
    """``new_cache`` where ``own`` (a (1,) bool tensor) is set, else
    ``old_cache``: a rank writes a chunk's slot only if it owns it."""
    own = own.reshape(())
    return pytree.tree_map(lambda n, o: torch.where(own, n, o), new_cache,
                           old_cache)


def _decode_body(decode_fn, params, tokens, pool):
    """Every slot of ``pool`` one token: the greedy next tokens into
    ``tokens``, in place."""
    logits, pool = decode_fn(params, tokens, pool)
    tokens.copy_(_greedy(logits)[:, None])
    return tokens, pool


def _chunk_body(chunk_fn, dims, params, pool, cslot, ctokens, cpos, cfirst,
                own=None):
    """One prompt chunk into slot ``cslot`` of ``pool`` -> (greedy token,
    pool); with ``own``, the slot is written only where it is set."""
    cache = _reset_if(cfirst, _gather_slot(pool, dims, cslot))
    logits, cache = chunk_fn(params, ctokens[None], cache, cpos)
    if own is not None:
        cache = _keep_unless(own, cache, _gather_slot(pool, dims, cslot))
    pool = _scatter_slot(pool, cache, dims, cslot)
    return _greedy(logits[0]), pool


def _serve_body(decode_fn, chunk_fn, dims, params, tokens, pool, cslot,
                ctokens, cpos, cfirst, cemit, own=None):
    """The fused step (:func:`make_serve_step`) on ``pool``; with ``own``,
    the chunk's slot and its token in the feed are written only where it
    is set."""
    cache = _reset_if(cfirst, _gather_slot(pool, dims, cslot))
    logits, pool = decode_fn(params, tokens, pool)
    nxt = _greedy(logits)[:, None]
    clogits, cache = chunk_fn(params, ctokens[None], cache, cpos)
    if own is not None:
        # a slot this rank does not own keeps its decode leg's write
        cache = _keep_unless(own, cache, _gather_slot(pool, dims, cslot))
        cemit = cemit & own.reshape(())
    pool = _scatter_slot(pool, cache, dims, cslot)
    ctok = _greedy(clogits).reshape(1, 1)
    mine = nxt.index_select(0, cslot)
    nxt.index_copy_(0, cslot, torch.where(cemit, ctok, mine))
    tokens.copy_(nxt)
    return tokens, pool


class _SlotShard:
    """Where a rank of a mesh step holds its block of the pool's slots:
    ``n`` ranks over mesh ``dims`` (``kv_batch``'s), ``per`` slots each,
    from global slot ``lo``."""

    def __init__(self, slots: int):
        self.dims = partitioning.mesh_dims(
            partitioning.resolve_axis("kv_batch", slots))
        self.n = partitioning._shards(self.dims)
        self.per = slots // self.n
        self.lo = partitioning.block_index(self.dims) * self.per

    def local(self, cslot: torch.Tensor):
        """A global slot ((1,) int64) -> (the rank's index of it, clamped
        into its block, and whether the rank owns it), on the device."""
        li = cslot - self.lo
        own = (li >= 0) & (li < self.per)
        return li.clamp(0, self.per - 1), own

    def rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rank's rows of the whole token feed (a view)."""
        return tokens.narrow(0, self.lo, self.per)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of dim 0, exactly, in slot order."""
        return partitioning.gather_exact(t.contiguous(), 0, self.dims)


def _slot_step_on_mesh(cfg, mesh, fsdp, step, sharded, pool_at: int):
    """A slot step on a mesh: ``step(params, *args)`` (the mesh-free step's
    function) with the pool at ``args[pool_at]``, run on the rank's
    compute layout of the parameters and the pool, the pool returned as
    DTensors at :func:`registry.slot_pool_axes`' placements.

    Where ``kv_batch`` shards the slots over n > 1 ranks (the data ranks),
    rank r holds slots [r * slots/n, (r + 1) * slots/n) and
    ``sharded(cp, shard, *args)`` runs instead: the rank decodes its
    slots (each slot routes alone, so ranks do not couple), a chunk runs
    on every rank against the clamped local index of the global ``cslot``
    and only the owner writes its slot (the non-owners' chunk is
    discarded: every rank runs the same program, so the layers'
    collectives match), and the next tokens (and a chunk's token) reach
    every rank by an exact gather of the ranks' blocks. A pool whose slots
    do not split over the data ranks raises ``ValueError``
    (``registry.slot_shards``); the token feed and ``cslot`` are whole
    tensors every rank holds."""
    if mesh is None:
        return step
    ms = _MeshServe(cfg, mesh, fsdp)
    axes = registry.slot_pool_axes(cfg)

    def on_mesh(params, *args):
        with axis_rules(mesh, ms.rules), torch.no_grad():
            pool = args[pool_at]
            slots = _shape(pytree.tree_leaves(pool)[0])[0]
            registry.slot_shards(mesh, slots)
            shard = _SlotShard(slots)
            local, _, shapes = ms.caches_in(pool, axes)
            args = args[:pool_at] + (local,) + args[pool_at + 1:]
            with ms.params(params) as cp:
                if shard.n > 1:
                    out, local = sharded(cp, shard, *args)
                else:
                    out, local = step(cp, *args)
            return out, ms.caches_out(local, axes, shapes, pool)

    on_mesh.shardings_for = ms.shardings_for("decode")
    return on_mesh


def make_slot_decode_step(cfg, mesh=None, *, fsdp: Optional[bool] = None):
    """``slot_decode_step(params, tokens (slots, 1), pool)`` decodes every
    slot one token (``repro/launch/steps.py:412``): the greedy next tokens
    go into ``tokens`` and the pool advances, in place; both are returned.
    Free slots decode garbage the host never reads (fixed shapes, no
    masks). Each slot's token routes alone through MoE layers."""
    decode_fn = registry.make_decode_fn(cfg, route_rows=True)

    def slot_decode_step(params, tokens, pool):
        with torch.no_grad():
            return _decode_body(decode_fn, params, tokens, pool)

    def sharded(params, shard, tokens, pool):
        with torch.no_grad():
            _, pool = _decode_body(decode_fn, params, shard.rows(tokens),
                                   pool)
            tokens.copy_(shard.gather(shard.rows(tokens)))
        return tokens, pool

    return _slot_step_on_mesh(cfg, mesh, fsdp, slot_decode_step, sharded, 1)


def make_slot_chunk_step(cfg, mesh=None, *, fsdp: Optional[bool] = None):
    """``slot_chunk_step(params, pool, cslot, ctokens (C,), cpos, cfirst)``
    -> (chunk_token () int32, pool): one prompt chunk into one slot, with no
    decode leg (``repro/launch/steps.py:438``). ``cfirst`` zero-resets the
    slot first, so a reused slot is never reallocated. The token is the
    greedy continuation after the chunk: meaningful on a prompt's last
    chunk. On a sharded pool ``cslot`` is global and the token is the
    owner's on every rank."""
    chunk_fn = registry.make_chunk_prefill_fn(cfg)
    dims = registry.cache_batch_dims(cfg)

    def slot_chunk_step(params, pool, cslot, ctokens, cpos, cfirst):
        with torch.no_grad():
            return _chunk_body(chunk_fn, dims, params, pool, cslot, ctokens,
                               cpos, cfirst)

    def sharded(params, shard, pool, cslot, ctokens, cpos, cfirst):
        with torch.no_grad():
            li, own = shard.local(cslot)
            ctok, pool = _chunk_body(chunk_fn, dims, params, pool, li,
                                     ctokens, cpos, cfirst, own)
            owner = torch.div(cslot, shard.per, rounding_mode="floor")
            ctok = shard.gather(ctok.reshape(1)).index_select(0, owner)
        return ctok.reshape(()), pool

    return _slot_step_on_mesh(cfg, mesh, fsdp, slot_chunk_step, sharded, 0)


def make_serve_step(cfg, mesh=None, *, fsdp: Optional[bool] = None):
    """The fused continuous-batching step (``repro/launch/steps.py:465``):
    ``serve_step(params, tokens (slots, 1), pool, cslot, ctokens (C,), cpos,
    cfirst, cemit)`` decodes every slot one token and runs one prompt chunk
    into slot ``cslot``, in one step, so admission never stalls decoding.

    The chunked slot's cache is gathered before the decode leg and
    scattered back after it: the decode leg's write to that slot (it
    decodes every slot) is overwritten whole, which is what makes at most
    one request mid-prefill safe. With ``cemit`` (a prompt's last chunk)
    the chunk's greedy token replaces the slot's entry of the token feed,
    so the request decodes on the very next step. ``tokens`` and the pool
    are written in place and returned. The decode leg routes each slot's
    token alone through MoE layers. On a sharded pool ``cslot`` is global:
    its owner writes the slot and splices the token into its rows of the
    feed before the gather."""
    decode_fn = registry.make_decode_fn(cfg, route_rows=True)
    chunk_fn = registry.make_chunk_prefill_fn(cfg)
    dims = registry.cache_batch_dims(cfg)

    def serve_step(params, tokens, pool, cslot, ctokens, cpos, cfirst, cemit):
        with torch.no_grad():
            return _serve_body(decode_fn, chunk_fn, dims, params, tokens,
                               pool, cslot, ctokens, cpos, cfirst, cemit)

    def sharded(params, shard, tokens, pool, cslot, ctokens, cpos, cfirst,
                cemit):
        with torch.no_grad():
            li, own = shard.local(cslot)
            rows = shard.rows(tokens)
            _, pool = _serve_body(decode_fn, chunk_fn, dims, params, rows,
                                  pool, li, ctokens, cpos, cfirst, cemit, own)
            tokens.copy_(shard.gather(rows))
        return tokens, pool

    return _slot_step_on_mesh(cfg, mesh, fsdp, serve_step, sharded, 1)


# ---------------------------------------------------------------------------
# serve input specs
# ---------------------------------------------------------------------------


def decode_input_specs(cfg, batch: int, max_len: int):
    """(params, token, caches, memory_kv or None) of a decode step as
    ``meta`` tensors (``repro/launch/steps.py:516``)."""
    caches, extras = registry.decode_state_spec(cfg, batch, max_len)
    return (registry.param_specs(cfg), registry.decode_token_spec(cfg, batch),
            caches, extras.get("memory_kv"))


def prefill_input_specs(cfg, batch: int, seq: int):
    """(params, batch) of a prefill step as ``meta`` tensors."""
    return registry.param_specs(cfg), registry.prefill_spec(cfg, batch, seq)
