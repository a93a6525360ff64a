"""Gated feed-forward (SwiGLU / GeGLU) block (``repro/models/mlp.py``).

The up and gate products are f32 results of the activation-dtype inputs
(``common.matmul_f32``, the reference's ``preferred_element_type=f32``,
``repro/models/mlp.py:33-34``); the gate and the product run in f32 and
are cast back to the activation dtype, as in the reference. The
tensor-parallel int8 reduction (``tpcomm``) is a no-op on one device and
is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    act = common.activation(cfg.act)
    h = common.matmul_f32(x, p["wi"])
    g = common.matmul_f32(x, p["wg"])
    h = (act(g) * h).to(x.dtype)
    return torch.matmul(h, p["wo"])
