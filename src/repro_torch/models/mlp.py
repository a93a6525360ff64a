"""Gated feed-forward (SwiGLU / GeGLU) block (``repro/models/mlp.py``).

The up and gate products are f32 results of the activation-dtype inputs
(``common.matmul_f32``, the reference's ``preferred_element_type=f32``,
``repro/models/mlp.py:33-34``); the gate and the product run in f32 and
are cast back to the activation dtype, as in the reference.

Tensor parallelism (``models/partitioning.py``): where a step kept the
rank's FFN columns (``wi``/``wg`` (D, F/m), ``wo`` (F/m, D)), the block
enters a tensor-parallel region, and its down product's f32 partial sums
are summed over ``"model"``, or, with ``cfg.tp_comm == "int8"`` and
``"ff"`` resolving to ``"model"`` (``repro/models/mlp.py:37-52``),
reduced in int8 (``tpcomm.int8_matmul_reduce``, forward-only).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common, partitioning, tpcomm
from .partitioning import with_logical_constraint


def param_axes(cfg):
    return {"wi": ("p_fsdp", "p_ff"), "wg": ("p_fsdp", "p_ff"),
            "wo": ("p_ff", "p_fsdp")}


def apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    act = common.activation(cfg.act)
    # the rank's FFN columns, where the step's layout kept them
    tp = partitioning.local_block(cfg, p["wi"], -1, "p_ff", cfg.d_ff)
    xi = partitioning.enter(x) if tp else x
    h = common.matmul_f32(xi, p["wi"])
    g = common.matmul_f32(xi, p["wg"])
    h = (act(g) * h).to(x.dtype)
    h = with_logical_constraint(h, ("batch", "seq", "ff"))
    if not tp:
        return torch.matmul(h, p["wo"])
    if (cfg.tp_comm == "int8"
            and partitioning.resolve_axis("ff", cfg.d_ff) == "model"):
        b, s, f = h.shape
        return tpcomm.int8_matmul_reduce(
            h.reshape(b * s, f), p["wo"], out_dtype=x.dtype).reshape(b, s, -1)
    return partitioning.reduce_sum(common.matmul_f32(h, p["wo"])).to(x.dtype)
