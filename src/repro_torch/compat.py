"""Capability probes and device resolution for the PyTorch port.

The one place that asks what the installation offers: whether a CUDA card is
present, whether it is a Hopper part (compute capability 9.x, the ``sm_90a``
target the hand-written kernels are compiled for), and where ``nvcc`` is.
Nothing here runs at import time; every probe is a function.

Device rule: entry points default to ``"cuda"`` and :func:`resolve_device`
raises when no card is present. Only an explicit ``device="cpu"`` runs the
CPU path (the plain PyTorch versions of the kernels), as the tests do.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple, Union

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
