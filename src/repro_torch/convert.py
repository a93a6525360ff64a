"""Parameter conversion between the reference's trees and the port's dicts.

``params_from_jax(cfg, tree)`` takes the tree of the reference's
``registry.init_params`` with numpy leaves (``jax.device_get``) and returns
the port's flat dict (``TransformerLM`` names) on ``device`` (default
``"cuda"``, which raises without a card). The reference stacks the
uniform layers on a leading ``num_layers`` axis for ``lax.scan`` and keeps a
mixed (hybrid) stack as a list of per-layer trees; the port keeps one entry
per layer, so the axis is unstacked and the list is numbered. Each leaf
keeps its own dtype (the hybrid's f32 ``lam`` beside bf16 weights).
``params_to_numpy`` is the inverse, for comparisons. Neither imports JAX:
a numpy bf16 array (ml_dtypes) is read through a ``uint16`` view, and bf16
tensors come back as exact f32 numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import compat
from .models import blocks


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_jax(cfg, tree, device="cuda") -> Dict[str, torch.Tensor]:
    device = compat.resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten({k: v for k, v in tree.items() if k != "layers"}):
        out[name] = _to_tensor(leaf, device)
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        if len(layers) != cfg.num_layers:
            raise ValueError(f"layers: {len(layers)} trees, num_layers is "
                             f"{cfg.num_layers}")
        for i, layer in enumerate(layers):
            for name, leaf in _flatten(layer):
                out[f"layers.{i}.{name}"] = _to_tensor(leaf, device)
        return out
    for name, leaf in _flatten(layers):
        leaf = np.asarray(leaf)
        if leaf.shape[0] != cfg.num_layers:
            raise ValueError(
                f"layers.{name}: leading axis {leaf.shape[0]} is not "
                f"num_layers={cfg.num_layers}"
            )
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{name}"] = _to_tensor(leaf[i], device)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _stacked(cfg) -> bool:
    """Whether the reference stacks the layers (``transformer._uniform``)."""
    return len(set(blocks.layer_kinds(cfg))) == 1 and cfg.scan_layers


def _insert(tree: dict, name: str, value) -> None:
    *path, leaf = name.split(".")
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def params_to_numpy(cfg, params: Dict[str, torch.Tensor]):
    """The port's dict back to the reference's nested tree, layers stacked
    or listed as the reference keeps them (bf16 leaves as exact f32 numpy
    arrays)."""
    tree: dict = {}
    per_layer = [dict() for _ in range(cfg.num_layers)]
    for name, t in params.items():
        if name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            per_layer[int(idx)][rest] = _numpy(t)
        else:
            _insert(tree, name, _numpy(t))
    if _stacked(cfg):
        layers: dict = {}
        for rest in per_layer[0]:
            _insert(layers, rest, np.stack([lp[rest] for lp in per_layer]))
        tree["layers"] = layers
    else:
        tree["layers"] = []
        for lp in per_layer:
            layer: dict = {}
            for rest, arr in lp.items():
                _insert(layer, rest, arr)
            tree["layers"].append(layer)
    return tree
