"""Placement stack for DrJAX programs (``repro/core/placement.py``).

A placement names a logical partition (``"clients"``) and its number of
groups. Placements nest: a context holds an ordered stack, outermost first
(``{"pods": P, "clients": m}``), and a value partitioned at depth ``k``
carries the ``k`` outermost placements' group axes as its leading axes;
depth 0 is the server. The paper's flat API is the one-entry stack.

Each level has a kind: ``"replicas"`` (the default: data-replica groups,
which ``broadcast``/``reduce_*`` address) or ``"stages"`` (model pipeline
stages, which exchange values by ``stage_transfer`` and run per-stage
functions by ``stage_map``). Left out for later slices: the per-placement
mesh axes and sharding switches (the port runs on one device, where they
are no-ops until ROADMAP queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, Optional, Tuple

#: Valid placement kinds: ``"replicas"`` (data-replica groups, addressed by
#: broadcast/reduce) and ``"stages"`` (pipeline stages, which communicate
#: only by ``stage_transfer`` and run per-stage functions by ``stage_map``).
PLACEMENT_KINDS = ("replicas", "stages")


@dataclasses.dataclass(frozen=True)
class Placement:
    """One named level of the placement stack: ``size`` groups of
    ``kind`` (``"replicas"`` or ``"stages"``)."""

    name: str
    size: int
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


@dataclasses.dataclass(frozen=True)
class PlacementContext:
    """Ambient placement stack for the DrJAX primitives, outermost first."""

    placements: Tuple[Placement, ...] = (Placement("clients", 1),)

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

    @property
    def placement(self) -> str:
        return self.innermost.name

    @property
    def partition_size(self) -> int:
        return self.innermost.size


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


@contextlib.contextmanager
def placement_context(ctx: PlacementContext):
    _CTX.stack.append(ctx)
    try:
        yield ctx
    finally:
        _CTX.stack.pop()


def make_context(
    partition_size: Optional[int] = None,
    *,
    placement: str = "clients",
    placements: Optional[Mapping[str, int]] = None,
    placement_kinds: Optional[Mapping[str, str]] = None,
) -> PlacementContext:
    """``make_context(n)``: the paper's single placement of size n;
    ``make_context(placements={"pods": P, "clients": m})``: a nested stack,
    outermost first (mapping order is the stack order).
    ``placement_kinds`` maps placement names to a kind (``"replicas"``,
    the default, or ``"stages"``); a name not in the stack is refused."""
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
    return PlacementContext(placements=tuple(
        Placement(n, s, kinds.get(n, "replicas")) for n, s in entries))
