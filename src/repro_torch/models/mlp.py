"""Gated feed-forward (SwiGLU / GeGLU) block (``repro/models/mlp.py``).

The gate and the product run in f32 and are cast back to the activation
dtype, as in the reference. The tensor-parallel int8 reduction (``tpcomm``)
is a no-op on one device and is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    act = common.activation(cfg.act)
    h = torch.matmul(x, p["wi"]).to(torch.float32)
    g = torch.matmul(x, p["wg"]).to(torch.float32)
    h = (act(g) * h).to(x.dtype)
    return torch.matmul(h, p["wo"])
