"""Mesh construction (``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over ranks, one rank
standing for one device of the reference's mesh, its dim names the
reference's axis names. Every constructor is a function, never a module
constant, and construction is collective: every rank of the world calls
it, also a rank outside the mesh (which gets ``get_coordinate() is
None``). ``device`` is explicit (default ``"cuda"``).

This module is the one home of mesh axis-name tuples: everywhere else
imports these (the ``mesh-axes-literal`` lint rule of both registries).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from .. import compat

# Canonical replica axes of the production mesh, outermost first.
REPLICA_AXES = ("pod", "data")  # lint: disable=mesh-axes-literal

# Mesh axis name per replica level, innermost first: the innermost level
# owns "data" (fast links), its parent "pod" (slow links), a grandparent
# "superpod"; deeper stacks get "repl<depth>" names.
_REPLICA_LEVEL_AXES = ("data", "pod", "superpod")  # lint: disable=mesh-axes-literal

# The production meshes of the reference's dry run (launch/dryrun.py):
# 16 x 16 (data, model) on one pod, 2 x 16 x 16 (pod, data, model) on two.
_PRODUCTION = {
    False: ((16, 16), ("data", "model")),  # lint: disable=mesh-axes-literal
    True: ((2, 16, 16), ("pod", "data", "model")),  # lint: disable=mesh-axes-literal
}


def _normalize_stack(placements) -> Tuple[Tuple[str, int, str], ...]:
    """Any placement-stack spec -> ``((name, size, kind), ...)``, outermost
    first: a ``Mapping[name, size]`` (all replica-kind), a
    ``PlacementContext``, or a sequence of ``Placement``s or ``(name,
    size[, kind])`` tuples."""
    if hasattr(placements, "placements"):  # PlacementContext
        placements = placements.placements
    if isinstance(placements, Mapping):
        return tuple((str(n), int(s), "replicas")
                     for n, s in placements.items())
    out = []
    for p in placements:
        if hasattr(p, "name"):  # Placement
            out.append((p.name, p.size, getattr(p, "kind", "replicas")))
        else:
            entry = tuple(p)
            kind = str(entry[2]) if len(entry) > 2 else "replicas"
            out.append((str(entry[0]), int(entry[1]), kind))
    return tuple(out)


def level_axes_for(placements) -> Tuple[str, ...]:
    """The mesh axis name of each placement level, outermost first.
    Replica levels take ``(data, pod, superpod, repl4, ...)`` innermost
    out; stage-kind levels take ``"stage"``, then ``"stage2"``, ..."""
    stack = _normalize_stack(placements)
    n_replica = sum(1 for _, _, k in stack if k != "stages")
    axes = []
    replica_seen = stage_seen = 0
    for _name, _size, kind in stack:
        if kind == "stages":
            axes.append("stage" if stage_seen == 0
                        else f"stage{stage_seen + 1}")
            stage_seen += 1
        else:
            depth_from_inner = n_replica - 1 - replica_seen
            axes.append(_REPLICA_LEVEL_AXES[depth_from_inner]
                        if depth_from_inner < len(_REPLICA_LEVEL_AXES)
                        else f"repl{depth_from_inner + 1}")
            replica_seen += 1
    return tuple(axes)


def production_mesh_spec(*, multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axes)`` of :func:`make_production_mesh`, as data."""
    return _PRODUCTION[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 (data, model) or 2 x 16 x 16 (pod, data, model): needs a
    world of 256 or 512 ranks."""
    shape, axes = production_mesh_spec(multi_pod=multi_pod)
    return compat.make_mesh(shape, axes, device=device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device="cuda", devices=None):
    return compat.make_mesh(shape, axes, device=device, devices=devices)


def make_host_mesh(model_parallel: int = 1, *, device="cuda"):
    """A (data, model) mesh over every rank of the world; None for a
    world of one rank."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n == 1:
        return None
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"),  # lint: disable=mesh-axes-literal
                     device=device)


def partition_axes_for(mesh):
    """DrJAX partition axes on this mesh: the replica axes when pods
    exist (prefixed with "superpod" on a 3-level mesh), else "data"."""
    if mesh is None:
        return None
    names = compat.mesh_axis_names(mesh)
    if "pod" in names:
        axes = REPLICA_AXES
        if "superpod" in names:
            axes = ("superpod",) + axes
        return axes
    if "data" in names:
        return "data"
    return None


def placement_axes_for(mesh, placements=None) -> Optional[Dict[str, str]]:
    """Per-placement mesh axes for a placement stack on this mesh.

    Without ``placements``: the nested {"pods", "clients"} stack, pods on
    "pod" and clients on "data", each only where the mesh has the dim.
    With ``placements``: each level takes its :func:`level_axes_for` axis,
    levels whose axis the mesh lacks stay logical."""
    if mesh is None:
        return None
    names = compat.mesh_axis_names(mesh)
    if placements is None:
        axes: Dict[str, str] = {}
        if "pod" in names:
            axes["pods"] = "pod"
        if "data" in names:
            axes["clients"] = "data"
        return axes or None
    stack = _normalize_stack(placements)
    level = level_axes_for(stack)
    axes = {nm: ax for (nm, _s, _k), ax in zip(stack, level) if ax in names}
    return axes or None


def mesh_for_placements(placements, model_parallel: int = 1, *,
                        devices=None, device="cuda"):
    """A mesh with one dim per placement level (plus "model" when
    ``model_parallel > 1``), named by :func:`level_axes_for`: ``{"clients":
    n}`` gives ``("data",)``, ``{"pods": P, "clients": m}`` the pod and
    data pair. ``devices``: the ranks to build it over, row-major (the
    elastic re-mapping path: the surviving pods' ranks); default the
    first ranks of the world."""
    stack = _normalize_stack(placements)
    if not stack:
        raise ValueError("placements must not be empty")
    shape: Tuple[int, ...] = tuple(s for _, s, _ in stack)
    axes: Tuple[str, ...] = level_axes_for(stack)
    if model_parallel > 1:
        shape = shape + (model_parallel,)
        axes = axes + ("model",)
    return compat.make_mesh(shape, axes, device=device, devices=devices)
