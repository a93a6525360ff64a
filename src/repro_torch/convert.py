"""Parameter conversion between the reference's trees and the port's dicts.

``params_from_jax(cfg, tree)`` takes the tree of the reference's
``registry.init_params`` with numpy leaves (``jax.device_get``) and returns
the port's flat dict (``TransformerLM`` names) on ``device`` (default
``"cuda"``, which raises without a card). The reference stacks the
uniform layers on a leading ``num_layers`` axis for ``lax.scan`` and keeps a
mixed (hybrid) stack as a list of per-layer trees; the port keeps one entry
per layer, so the axis is unstacked and the list is numbered. Each leaf
keeps its own dtype (the hybrid's f32 ``lam``, or an MoE layer's f32
``moe.router``, beside bf16 weights); qkv biases and MoE experts are
leaves like any other.
An encoder-decoder's tree has two stacks, ``enc_layers`` (``encoder_layers``
deep) and ``dec_layers`` (``num_layers``), both stacked by the reference,
which become ``enc_layers.<i>.*`` and ``dec_layers.<i>.*``.
``params_to_numpy`` is the inverse, for comparisons. Neither imports JAX:
a numpy bf16 array (ml_dtypes) is read through a ``uint16`` view, and bf16
tensors come back as exact f32 numpy arrays.

``state_to_numpy`` and ``state_from_jax`` do the same for the whole
training state (params and server optimizer state), keeping every leaf's
dtype, for checkpoints that either package restores.

``caches_from_jax`` and ``caches_to_numpy`` do it for the serve caches
(``transformer.init_caches``, or with ``pool=True`` the serve slot pool):
the reference stacks a uniform stack's caches on a leading layers axis
(a position leaf (L,), in a pool (slots, L)); the port keeps a list of
one cache dict per layer. ``memory_kv_from_jax`` and ``memory_kv_to_numpy``
translate an encoder-decoder's cross-attention memory K/V: the reference's
pair of stacked (L, B, Sm, Hkv, hd) arrays, the port's list of one (k, v)
pair per decoder layer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import compat
from .models import blocks


def _to_tensor(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(device, copy=True)
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


def _stacks(cfg) -> Dict[str, int]:
    """The layer stacks of ``cfg``'s tree and their depths."""
    if cfg.is_encoder_decoder:
        return {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.num_layers}
    return {"layers": cfg.num_layers}


def params_from_jax(cfg, tree, device="cuda") -> Dict[str, torch.Tensor]:
    device = compat.resolve_device(device)
    stacks = _stacks(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k not in stacks}):
        out[name] = _to_tensor(leaf, device)
    for stack, depth in stacks.items():
        layers = tree[stack]
        if isinstance(layers, (list, tuple)):
            if len(layers) != depth:
                raise ValueError(f"{stack}: {len(layers)} trees, depth is "
                                 f"{depth}")
            for i, layer in enumerate(layers):
                for name, leaf in _flatten(layer):
                    out[f"{stack}.{i}.{name}"] = _to_tensor(leaf, device)
            continue
        for name, leaf in _flatten(layers):
            if not torch.is_tensor(leaf):
                leaf = np.asarray(leaf)
            if leaf.shape[0] != depth:
                raise ValueError(
                    f"{stack}.{name}: leading axis {leaf.shape[0]} is not "
                    f"the depth {depth}"
                )
            for i in range(depth):
                out[f"{stack}.{i}.{name}"] = _to_tensor(leaf[i], device)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _stacked(cfg) -> bool:
    """Whether the reference stacks the layers (``transformer._uniform``;
    an encoder-decoder's two stacks always)."""
    if cfg.is_encoder_decoder:
        return True
    return len(set(blocks.layer_kinds(cfg))) == 1 and cfg.scan_layers


def _insert(tree: dict, name: str, value) -> None:
    *path, leaf = name.split(".")
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _layout(cfg, params: Dict[str, object], stack):
    """The port's flat dict (leaves already converted) as the reference's
    nested tree, layers stacked by ``stack`` or listed as the reference
    keeps them."""
    stacks = _stacks(cfg)
    tree: dict = {}
    per_layer = {name: [dict() for _ in range(depth)]
                 for name, depth in stacks.items()}
    for name, leaf in params.items():
        head = name.split(".", 1)[0]
        if head in stacks:
            _, idx, rest = name.split(".", 2)
            per_layer[head][int(idx)][rest] = leaf
        else:
            _insert(tree, name, leaf)
    for head, layers in per_layer.items():
        if _stacked(cfg):
            stacked: dict = {}
            for rest in layers[0]:
                _insert(stacked, rest, stack([lp[rest] for lp in layers]))
            tree[head] = stacked
        else:
            tree[head] = []
            for lp in layers:
                layer: dict = {}
                for rest, leaf in lp.items():
                    _insert(layer, rest, leaf)
                tree[head].append(layer)
    return tree


def params_to_numpy(cfg, params: Dict[str, torch.Tensor]):
    """The port's dict back to the reference's nested tree, layers stacked
    or listed as the reference keeps them (bf16 leaves as exact f32 numpy
    arrays)."""
    return _layout(cfg, {k: _numpy(t) for k, t in params.items()}, np.stack)


def _host(t: torch.Tensor):
    """A NumPy array of the tensor's dtype, or for bf16 (which NumPy lacks)
    a CPU bf16 tensor."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _stack_host(leaves):
    if torch.is_tensor(leaves[0]):
        return torch.stack(leaves)
    return np.stack(leaves)


def state_to_numpy(cfg, state) -> dict:
    """The training state ``{"params": ..., "server": ...}`` in the
    reference's layout, every leaf on the host in its own dtype: the params
    and each tree of the server state (``mu``, ``m``, ``v``) nested with the
    layers stacked as the reference stacks them, the server's ``step`` an
    int32 scalar. Leaves are NumPy arrays, except bf16 leaves, which NumPy
    cannot hold: those are CPU bf16 tensors. Saved by the port's
    ``CheckpointManager``, the tree restores through the reference's
    ``CheckpointManager.restore`` bitwise, with the reference's sha256 of
    every leaf."""

    def tree(value):
        if isinstance(value, dict):
            return _layout(cfg, {k: _host(t) for k, t in value.items()},
                           _stack_host)
        return _host(value)

    return {"params": tree(state["params"]),
            "server": {k: tree(v) for k, v in state["server"].items()}}


def state_from_jax(cfg, tree, device="cuda") -> dict:
    """Inverse of :func:`state_to_numpy`: the reference's training state (or
    the port's restore of a checkpoint in its layout), with NumPy, ml_dtypes
    bf16 or tensor leaves, as the port's ``{"params", "server"}`` on
    ``device``."""

    def leaf(value):
        if isinstance(value, dict):
            return params_from_jax(cfg, value, device)
        return _to_tensor(value, compat.resolve_device(device))

    return {"params": leaf(tree["params"]),
            "server": {k: leaf(v) for k, v in tree["server"].items()}}


def caches_from_jax(cfg, caches, device="cuda", *, pool: bool = False):
    """The reference's serve caches (numpy, ml_dtypes or tensor leaves) as
    the port's per-layer list on ``device``; ``pool=True`` for a slot pool,
    whose stacked position leaf is (slots, L)."""
    device = compat.resolve_device(device)
    if isinstance(caches, (list, tuple)):
        return [{k: _to_tensor(v, device) for k, v in c.items()}
                for c in caches]
    out = []
    for i in range(cfg.num_layers):
        layer = {}
        for k, v in caches.items():
            v = v if torch.is_tensor(v) else np.asarray(v)
            layer[k] = _to_tensor(v[:, i] if (pool and k == "pos") else v[i],
                                  device)
        out.append(layer)
    return out


def caches_to_numpy(cfg, caches, *, pool: bool = False):
    """Inverse of :func:`caches_from_jax`: the reference's layout with
    numpy leaves (bf16 as exact f32), for comparisons or to continue a
    port's cache in the reference."""
    layers = [{k: _numpy(v) for k, v in c.items()} for c in caches]
    if not _stacked(cfg):
        return layers
    return {k: np.stack([lp[k] for lp in layers],
                        axis=1 if (pool and k == "pos") else 0)
            for k in layers[0]}


def memory_kv_from_jax(cfg, memory_kv, device="cuda"):
    """The reference's cross-attention memory (mk, mv), each (L, B, Sm, Hkv,
    hd), as the port's list of one (k, v) pair per decoder layer."""
    device = compat.resolve_device(device)
    mk, mv = memory_kv
    return [(_to_tensor(mk[i], device), _to_tensor(mv[i], device))
            for i in range(cfg.num_layers)]


def memory_kv_to_numpy(memory_kv):
    """Inverse of :func:`memory_kv_from_jax`: (mk, mv) stacked on a leading
    layers axis, numpy (bf16 as exact f32)."""
    return (np.stack([_numpy(k) for k, _ in memory_kv]),
            np.stack([_numpy(v) for _, v in memory_kv]))
