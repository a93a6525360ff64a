"""Capability probes and device resolution for the PyTorch port.

The one place that asks what the installation offers: whether a CUDA card is
present, whether it is a Hopper part (compute capability 9.x, the ``sm_90a``
target the hand-written kernels are compiled for), and where ``nvcc`` is.
Nothing here runs at import time; every probe is a function.

Device rule: entry points default to ``"cuda"`` and :func:`resolve_device`
raises when no card is present. Only an explicit ``device="cpu"`` runs the
CPU path (the plain PyTorch versions of the kernels), as the tests do.

Also the one place that builds process groups and meshes: the backend
rule (:func:`dist_backend`), an explicit rendezvous
(:func:`init_process_group`), a fake world of one process
(:func:`fake_world`, the dry run's), ``DeviceMesh`` construction over a
rank subset (:func:`make_mesh`) and the replicated and named shardings as
DTensor placement lists.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def cuda_available() -> bool:
    return torch.cuda.is_available()


def compute_capability(index: int = 0) -> Optional[Tuple[int, int]]:
    """(major, minor) of card ``index``, or None without a card."""
    if not cuda_available():
        return None
    return torch.cuda.get_device_capability(index)


def is_hopper(index: int = 0) -> bool:
    """True on a compute-capability 9.x card (H100/H200)."""
    cap = compute_capability(index)
    return cap is not None and cap[0] == 9


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``). None when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Turn a device spec into a ``torch.device``, raising if it names a
    CUDA device and no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no CUDA card is "
            "available; pass device='cpu' explicitly to run the CPU path."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch supports cuda and cpu, got {dev}")
    return dev


# ---------------------------------------------------------------------------
# process groups and meshes (``repro/compat/meshes.py``, ``shardings.py``)
# ---------------------------------------------------------------------------
#
# The reference is single-controller: one process sees every device. The
# port is SPMD: one process per rank, and a rank stands for one device of
# the reference's mesh. A mesh is a ``torch.distributed`` ``DeviceMesh``
# over ranks; a sharding is a DTensor placement list, one entry per mesh
# dim.


def dist_backend(device: DeviceLike = "cuda", backend: Optional[str] = None
                 ) -> str:
    """The collective backend for ``device``: NCCL for ``cuda`` unless the
    caller names gloo (ranks that share one card), gloo for ``cpu``.
    Nothing falls back to another backend."""
    kind = torch.device(device).type
    if backend is None:
        return "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: nccl or gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend carries CUDA tensors only")
    return backend


def init_process_group(rank: int, world_size: int, *, init_method: str,
                       device: DeviceLike = "cuda",
                       backend: Optional[str] = None) -> str:
    """Join a world of ``world_size`` ranks as ``rank``. ``init_method``
    is the rendezvous, given explicitly (``file:///path`` or
    ``tcp://localhost:<port>``): nothing is read from the environment.
    On ``cuda`` the rank's card is ``rank % device_count()``, so several
    gloo ranks may share one card. Returns the backend."""
    import torch.distributed as dist

    dev = resolve_device(device)
    name = dist_backend(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(name, init_method=init_method, rank=rank,
                            world_size=world_size)
    return name


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a world of ``world`` ranks whose
    collectives move nothing (torch's ``"fake"`` backend over a
    ``FakeStore``): every rank-local decision and every collective call is
    the real run's, with no peers. Torn down on exit, so another may
    follow."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = "cuda", devices=None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the ranks
    ``devices`` (a flat sequence, row-major; default the first
    ``prod(shape)`` ranks of the world). Construction is collective: every
    rank of the world calls it, also one outside the mesh, which gets
    ``get_coordinate() is None``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    need = math.prod(shape)
    ranks = (list(range(need)) if devices is None
             else [int(r) for r in np.asarray(devices).reshape(-1)])
    if len(ranks) != need:
        raise ValueError(f"{len(ranks)} ranks for a mesh of shape {shape}")
    world = dist.get_world_size()
    if any(r < 0 or r >= world for r in ranks) or len(set(ranks)) != need:
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a "
                         f"world of {world}")
    kind = resolve_device(device).type
    return DeviceMesh(kind, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's dim names (a ``DeviceMesh``, or any object with
    ``mesh_dim_names`` and a ``mesh`` array of ranks)."""
    return tuple(mesh.mesh_dim_names)


def mesh_grid(mesh) -> np.ndarray:
    """The mesh's ranks as an integer array of its shape, read outside any
    dispatch mode: a ``DeviceMesh`` may build its rank tensor from its
    layout on each read, which a fake-tensor or tracing mode would
    otherwise take for a step's own work."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return np.asarray(mesh.mesh)


def mesh_shape(mesh) -> Tuple[int, ...]:
    return tuple(int(s) for s in mesh_grid(mesh).shape)


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The mesh's ranks, row-major: its device identity."""
    return tuple(int(r) for r in mesh_grid(mesh).reshape(-1))


def replicated_placements(mesh) -> list:
    """The replicated sharding: ``Replicate()`` on every mesh dim."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh_axis_names(mesh)]


def named_placements(mesh, spec) -> list:
    """The DTensor placements of a named sharding: ``spec`` has one entry
    per tensor dim (a mesh dim name, a tuple of names, or ``None``), as a
    ``PartitionSpec``; each mesh dim it names shards that tensor dim, in
    the order the names appear (row-major, as a tuple of axes shards),
    and the others replicate."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = (() if entry is None else
                (entry,) if isinstance(entry, str) else tuple(entry))
        for ax in axes:
            if ax not in names:
                raise ValueError(f"mesh has no dim {ax!r} (dims {names})")
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            # DTensor splits one tensor dim over several mesh dims in the
            # mesh's order: another order would be another layout.
            raise ValueError(f"tensor dim {dim} is sharded over {axes}, "
                             f"out of the mesh's order {names}")
        for m in idx:
            out[m] = Shard(dim)
    return out
