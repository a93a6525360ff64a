"""Placement stack for DrJAX programs (``repro/core/placement.py``).

A placement names a logical partition (``"clients"``) and its number of
groups. Placements nest: a context holds an ordered stack, outermost first
(``{"pods": P, "clients": m}``), and a value partitioned at depth ``k``
carries the ``k`` outermost placements' group axes as its leading axes;
depth 0 is the server. The paper's flat API is the one-entry stack.

Each level has a kind: ``"replicas"`` (the default: data-replica groups,
which ``broadcast``/``reduce_*`` address) or ``"stages"`` (model pipeline
stages, which exchange values by ``stage_transfer`` and run per-stage
functions by ``stage_map``).

Each level carries its own mesh axes (``axes``: the dim name(s) of a
``torch.distributed`` ``DeviceMesh`` its group axis is sharded over), and
the context carries the mesh and the sharding switches: with a mesh and
``use_sharding_annotations`` a value partitioned at depth ``k`` is a
DTensor whose ``k`` leading group axes are ``Shard``ed over their levels'
mesh dims (``core/sharding.py``); ``use_sharding_annotations=False`` is
the paper's DrJAX-NS ablation (Fig. 6): every rank computes every group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

AxisSpec = Union[str, Tuple[str, ...], None]

#: Valid placement kinds: ``"replicas"`` (data-replica groups, addressed by
#: broadcast/reduce) and ``"stages"`` (pipeline stages, which communicate
#: only by ``stage_transfer`` and run per-stage functions by ``stage_map``).
PLACEMENT_KINDS = ("replicas", "stages")


def _axes_tuple(axes: AxisSpec) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One named level of the placement stack: ``size`` groups of
    ``kind`` (``"replicas"`` or ``"stages"``), sharded over the mesh dim(s)
    ``axes`` (``None``: a purely logical level)."""

    name: str
    size: int
    axes: AxisSpec = None
    kind: str = "replicas"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(
                f"placement {self.name!r} must have size >= 1, got {self.size}"
            )
        if self.kind not in PLACEMENT_KINDS:
            raise ValueError(
                f"placement {self.name!r} has unknown kind {self.kind!r}; "
                f"valid kinds are {list(PLACEMENT_KINDS)}"
            )

    def axes_tuple(self) -> Tuple[str, ...]:
        return _axes_tuple(self.axes)


@dataclasses.dataclass(frozen=True)
class PlacementContext:
    """Ambient placement stack for the DrJAX primitives, outermost first.

    ``mesh``: a ``torch.distributed`` ``DeviceMesh`` (``None``: no
    sharding, every rank holds every group). ``use_sharding_annotations``:
    the master switch (``False`` is DrJAX-NS). ``use_spmd_axis_name``:
    whether ``map_fn`` runs its body on each rank's own groups (the
    reference's ``spmd_axis_name``)."""

    placements: Tuple[Placement, ...] = (Placement("clients", 1),)
    mesh: Any = None
    use_sharding_annotations: bool = True
    use_spmd_axis_name: bool = True

    def __post_init__(self):
        if not self.placements:
            raise ValueError("PlacementContext needs at least one placement")
        names = [p.name for p in self.placements]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate placement names: {names}")

    @property
    def depth(self) -> int:
        return len(self.placements)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.placements)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(p.size for p in self.placements)

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(p.kind for p in self.placements)

    def stage_names(self) -> Tuple[str, ...]:
        """Names of the stage-kind levels, outermost first."""
        return tuple(p.name for p in self.placements if p.kind == "stages")

    @property
    def innermost(self) -> Placement:
        return self.placements[-1]

    def index_of(self, name: Optional[str]) -> int:
        """Stack index of a placement; ``None`` addresses the innermost."""
        if name is None:
            return self.depth - 1
        for i, p in enumerate(self.placements):
            if p.name == name:
                return i
        raise KeyError(
            f"no placement named {name!r} in this context "
            f"(have {list(self.names)})"
        )

    def get(self, name: Optional[str]) -> Placement:
        return self.placements[self.index_of(name)]

    def total_size(self) -> int:
        """Total number of innermost groups across the whole stack."""
        return math.prod(self.sizes)

    def spmd_axis_name_for(self, placement: Optional[str] = None):
        """The mesh dim name(s) one level's groups are spread over (the
        reference's vmap ``spmd_axis_name``), or None."""
        if not self.use_sharding_annotations or not self.use_spmd_axis_name:
            return None
        axes = self.get(placement).axes_tuple()
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def sharded(self) -> bool:
        """Are values of this context sharded over its mesh?"""
        return (self.mesh is not None and self.use_sharding_annotations
                and any(p.axes_tuple() for p in self.placements))

    @property
    def placement(self) -> str:
        return self.innermost.name

    @property
    def partition_size(self) -> int:
        return self.innermost.size

    @property
    def partition_axes(self) -> AxisSpec:
        return self.innermost.axes

    def axes_tuple(self) -> Tuple[str, ...]:
        return self.innermost.axes_tuple()

    def spmd_axis_name(self):
        return self.spmd_axis_name_for(None)


class _ContextStack(threading.local):
    def __init__(self):
        super().__init__()
        self.stack = []


_CTX = _ContextStack()


def current_context() -> PlacementContext:
    if not _CTX.stack:
        raise RuntimeError(
            "No DrJAX placement context active. Wrap your computation with "
            "@drjax.program(partition_size=...) or `with placement_context(...)`."
        )
    return _CTX.stack[-1]


def has_context() -> bool:
    return bool(_CTX.stack)


@contextlib.contextmanager
def placement_context(ctx: PlacementContext):
    _CTX.stack.append(ctx)
    try:
        yield ctx
    finally:
        _CTX.stack.pop()


def _normalize_axes(names: Sequence[str], partition_axes
                    ) -> Tuple[AxisSpec, ...]:
    """Per-placement mesh axes from ``partition_axes``: a mapping
    ``{placement_name: axes}``, or (one placement only) a bare spec."""
    if isinstance(partition_axes, Mapping):
        unknown = set(partition_axes) - set(names)
        if unknown:
            raise ValueError(
                f"partition_axes names unknown placements {sorted(unknown)}; "
                f"placements are {list(names)}"
            )
        return tuple(partition_axes.get(n) for n in names)
    if len(names) == 1:
        return (partition_axes,)
    if partition_axes is None:
        return tuple(None for _ in names)
    raise ValueError(
        "with multiple placements, partition_axes must be a mapping "
        "{placement_name: mesh_axes} (or None)"
    )


def make_context(
    partition_size: Optional[int] = None,
    *,
    placement: str = "clients",
    placements: Optional[Mapping[str, int]] = None,
    partition_axes=None,
    placement_kinds: Optional[Mapping[str, str]] = None,
    mesh=None,
    use_sharding_annotations: bool = True,
    use_spmd_axis_name: bool = True,
) -> PlacementContext:
    """``make_context(n)``: the paper's single placement of size n;
    ``make_context(placements={"pods": P, "clients": m})``: a nested stack,
    outermost first (mapping order is the stack order).
    ``placement_kinds`` maps placement names to a kind (``"replicas"``,
    the default, or ``"stages"``); a name not in the stack is refused.
    ``partition_axes`` names each level's mesh dim(s): a bare spec for one
    placement (``"data"``), a mapping for a stack (``{"pods": "pod",
    "clients": "data"}``)."""
    if placements is not None:
        if partition_size is not None:
            raise ValueError("pass either partition_size or placements, not both")
        if not placements:
            raise ValueError("placements mapping must not be empty")
        entries = tuple(placements.items())
    else:
        if partition_size is None:
            raise ValueError("partition_size (or placements) is required")
        entries = ((placement, partition_size),)
    kinds = dict(placement_kinds or {})
    unknown = set(kinds) - {n for n, _ in entries}
    if unknown:
        raise ValueError(
            f"placement_kinds names unknown placements {sorted(unknown)}; "
            f"placements are {[n for n, _ in entries]}"
        )
    axes = _normalize_axes([n for n, _ in entries], partition_axes)
    return PlacementContext(
        placements=tuple(Placement(n, s, a, kind=kinds.get(n, "replicas"))
                         for (n, s), a in zip(entries, axes)),
        mesh=mesh,
        use_sharding_annotations=use_sharding_annotations,
        use_spmd_axis_name=use_spmd_axis_name)
