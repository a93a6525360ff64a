"""Logical-axis partitioning of the port (``repro_torch/models/
partitioning.py``) held to the reference's (``repro/models/
partitioning.py``).

Every parameter and cache leaf of all thirteen architectures, at full
width, on the two production meshes (16 x 16 ``(data, model)`` and 2 x 16
x 16 ``(pod, data, model)``) under the ``tp`` and ``dp`` rule chains with
FSDP on and off, resolves to the same mesh axes in both packages. The
reference's resolution reads only ``mesh.axis_names`` and
``mesh.devices.shape`` (``partitioning.py:89-97``) and the port's only the
dim names and sizes, so stand-ins with just those drive both on one CPU
device. Reference leaves go through ``convert``'s naming: a stacked leaf's
leading ``"layers"`` axis (rule ``(None,)``) is dropped per layer.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.launch import steps as ref_steps
from repro.models import partitioning as ref_part
from repro.models import registry as ref_registry
from repro_torch import compat
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import attention, partitioning, registry

MESHES = {"pod": mesh_lib.production_mesh_spec(multi_pod=False),
          "multipod": mesh_lib.production_mesh_spec(multi_pod=True)}
RULES = [("tp", False), ("tp", True), ("dp", False), ("dp", True)]
CACHE_BATCH, CACHE_LEN = 64, 128


def _ref_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(shape, axes):
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 mesh=np.zeros(shape, dtype=np.int64))


def _flat(tree, prefix=""):
    """(name, leaf) of a reference tree, named as ``convert`` names it; a
    list is numbered."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)) and not _is_axes(tree):
        for i, sub in enumerate(tree):
            yield from _flat(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _is_axes(v):
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in v)


def _unstack(cfg, axes, shapes, stacks):
    """Reference (name, axes, shape) per port leaf: a stacked leaf (its
    first axis ``"layers"``) becomes one leaf a layer."""
    shape_of = dict(_flat(shapes))
    out = {}
    for name, ax in _flat(axes):
        shape = tuple(shape_of[name].shape)
        head = name.split(".")[0]
        if head in stacks and ax and ax[0] == "layers":
            rest = name[len(head) + 1:]
            for i in range(shape[0]):
                out[f"{head}.{i}.{rest}"] = ("stacked", ax, shape)
        else:
            out[name] = ("plain", ax, shape)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = ref_registry.get_config(arch)
    shapes = jax.eval_shape(
        lambda: ref_registry.init_params(jax.random.PRNGKey(0), cfg))
    stacks = (("enc_layers", "dec_layers") if cfg.is_encoder_decoder
              else ("layers",))
    params = _unstack(cfg, ref_registry.param_axes(cfg), shapes, stacks)
    mod = ref_registry.family_module(cfg)
    if cfg.is_encoder_decoder:
        c_axes = ref_steps._encdec_cache_axes(cfg)
    else:
        c_axes = mod.cache_axes(cfg)
    c_shapes = jax.eval_shape(
        lambda: mod.init_caches(cfg, CACHE_BATCH, CACHE_LEN))
    if isinstance(c_shapes, dict):  # stacked: one entry a layer
        caches = {f"{i}.{k}": ("stacked", c_axes[k], tuple(v.shape))
                  for k, v in c_shapes.items()
                  for i in range(v.shape[0])}
    else:
        caches = {f"{i}.{k}": ("plain", c_axes[i][k], tuple(v.shape))
                  for i, layer in enumerate(c_shapes)
                  for k, v in layer.items()}
    return cfg, params, caches


@functools.lru_cache(maxsize=None)
def _port(arch):
    cfg = registry.get_config(arch)
    shapes = {k: tuple(v.shape) for k, v in registry.param_specs(cfg).items()}
    caches, _ = registry.decode_state_spec(cfg, CACHE_BATCH, CACHE_LEN)
    c_axes = registry.cache_axes(cfg)
    cache = {f"{i}.{k}": (c_axes[i][k], tuple(v.shape))
             for i, layer in enumerate(caches) for k, v in layer.items()}
    return cfg, registry.param_axes(cfg), shapes, cache


def _ref_spec(kind, ax, shape):
    spec = tuple(ref_part.spec_for(ax, shape))
    spec = spec + (None,) * (len(ax) - len(spec))
    if kind == "stacked":
        assert spec[0] is None, spec  # the layers axis stays whole
        return spec[1:]
    return spec


def _norm(entry):
    return tuple(entry) if isinstance(entry, list) else entry


@pytest.mark.parametrize("strategy,fsdp", RULES,
                         ids=[f"{s}-fsdp{int(f)}" for s, f in RULES])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_leaf_axes_match_reference(arch, mesh, strategy, fsdp):
    shape, axes = MESHES[mesh]
    _, rparams, rcaches = _reference(arch)
    _, p_axes, p_shapes, caches = _port(arch)
    ref_rules = ref_steps.strategy_rules(
        type("C", (), {"mesh_strategy": strategy})(), fsdp)
    port_rules = steps.strategy_rules(
        type("C", (), {"mesh_strategy": strategy})(), fsdp)
    assert set(rparams) == set(p_axes)
    assert {k for k in rcaches} == set(caches)
    with ref_part.axis_rules(_ref_mesh(shape, axes), ref_rules):
        want_p = {k: _ref_spec(*v) for k, v in rparams.items()}
        want_c = {k: _ref_spec(*v) for k, v in rcaches.items()}
    with partitioning.axis_rules(_port_mesh(shape, axes), port_rules):
        got_p = {k: partitioning.spec_for(p_axes[k], p_shapes[k])
                 for k in p_axes}
        got_c = {k: partitioning.spec_for(*v) for k, v in caches.items()}
    for k in want_p:
        assert tuple(map(_norm, got_p[k])) == want_p[k], (k, got_p[k],
                                                          want_p[k])
        kind, _, rshape = rparams[k]
        assert p_shapes[k] == (rshape[1:] if kind == "stacked" else rshape)
    for k in want_c:
        assert tuple(map(_norm, got_c[k])) == want_c[k], (k, got_c[k],
                                                          want_c[k])


# ---------------------------------------------------------------------------
# the rules and the resolution
# ---------------------------------------------------------------------------


def test_default_rules_are_the_references():
    assert partitioning.DEFAULT_RULES == ref_part.DEFAULT_RULES


@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_strategy_rules_are_the_references(strategy, fsdp):
    cfg = type("C", (), {"mesh_strategy": strategy})()
    assert steps.strategy_rules(cfg, fsdp) == ref_steps.strategy_rules(
        cfg, fsdp)
    assert steps.fsdp_rules(fsdp) == ref_steps.fsdp_rules(fsdp)


def test_odd_width_replicates():
    """qwen2_72b's 8 kv heads do not divide a model axis of 16: the
    ``("model", None)`` chain of ``p_kv_heads`` / ``kv_heads`` falls to
    replication, and its kv weights and caches shard head_dim instead, in
    both packages."""
    cfg = registry.get_config("qwen2_72b")
    shape, axes = MESHES["pod"]
    with partitioning.axis_rules(_port_mesh(shape, axes)):
        assert partitioning.resolve_axis("kv_heads", 8) is None
        assert partitioning.resolve_axis("kv_heads", 16) == "model"
        assert partitioning.resolve_axis("p_kv_heads", 8) is None
        wk = attention.param_axes(cfg)["wk"]
        assert wk == ("p_fsdp", None, "kv_head_dim")
        assert partitioning.spec_for(wk, (8192, 8, 128)) == ("data", None,
                                                             "model")
        assert attention.cache_logical_axes(cfg)[2:] == (None, "kv_head_dim")
    with ref_part.axis_rules(_ref_mesh(shape, axes)):
        assert ref_part.resolve_axis("kv_heads", 8) is None
        assert tuple(ref_part.spec_for(wk, (8192, 8, 128))) == (
            "data", None, "model")


def test_resolution_without_a_mesh_and_constraint_noop():
    x = torch.arange(6.0).reshape(2, 3)
    assert partitioning.current_mesh() is None
    assert partitioning.resolve_axis("batch", 2) is None
    assert partitioning.spec_for(("batch", "embed"), (2, 3)) == (None, None)
    assert partitioning.named_sharding(("batch", "embed")) is None
    assert partitioning.with_logical_constraint(x, ("batch", "embed")) is x
    assert partitioning.model_size() == 1 and partitioning.model_index() == 0
    assert partitioning.enter(x) is x and partitioning.reduce_sum(x) is x


def test_tuple_axes_shard_outer_first():
    """``("pod", "data")`` on one tensor dim is ``Shard(i)`` on both mesh
    dims, outer first, as JAX lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    shape, axes = MESHES["multipod"]
    with partitioning.axis_rules(_port_mesh(shape, axes)):
        assert partitioning.spec_for(("batch", None), (64, 8)) == (
            ("pod", "data"), None)
        assert partitioning.named_sharding(("batch", None, "heads"),
                                           (64, 8, 32)) == [
            Shard(0), Shard(0), Shard(2)]
        assert partitioning.named_sharding((None,), (4,)) == [
            Replicate(), Replicate(), Replicate()]
    assert compat.mesh_axis_names(_port_mesh(shape, axes)) == axes


def test_cell_applicable_is_the_references():
    for arch in registry.ARCH_IDS:
        for cell in ("train_4k", "long_500k", "decode_32k"):
            assert registry.cell_applicable(registry.get_config(arch),
                                            cell) == \
                ref_registry.cell_applicable(ref_registry.get_config(arch),
                                             cell)


@pytest.mark.parametrize("arch", ["lm_350m", "llava_next_34b",
                                  "seamless_m4t_medium"])
def test_specs_are_meta_and_match_the_references(arch):
    """The input specs are ``meta`` tensors (nothing allocated) of the
    reference's ShapeDtypeStructs' shapes."""
    cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
    got = registry.train_batch_spec(cfg, 4, 64)
    want = ref_registry.train_batch_spec(rcfg, 4, 64)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    assert registry.batch_axes(cfg) == ref_registry.batch_axes(rcfg)
    assert tuple(registry.decode_token_spec(cfg, 4).shape) == tuple(
        ref_registry.decode_token_spec(rcfg, 4).shape)
    params, token, caches, memkv = steps.decode_input_specs(cfg, 4, 32)
    assert token.device.type == "meta"
    assert all(t.device.type == "meta" for t in params.values())
    if cfg.is_encoder_decoder:
        assert len(memkv) == cfg.num_layers
        assert tuple(memkv[0][0].shape) == (4, 32, cfg.num_kv_heads,
                                            cfg.head_dim)
    else:
        assert memkv is None
    p, batch = steps.prefill_input_specs(cfg, 4, 64)
    assert set(batch) == set(want)


def test_modules_read_the_layouts_decision():
    """A module that splits over "model" reads where from
    ``partitioning.local_block``, the decision the step's layout makes
    (``tp_leaf``, ``local_dims``): the rank's FFN columns on a (data 1,
    model 2) mesh under the tp rules, a whole weight there raises (in the
    module too), the dp rules and an encoder-decoder never split, and
    without a mesh a rank's block raises."""
    from repro_torch.models import mlp

    mesh = _port_mesh((1, 2), ("data", "model"))
    cfg = registry.get_config("lm_1b").reduced(
        d_model=64, num_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        dtype="float32")
    d, f = cfg.d_model, cfg.d_ff
    local = torch.zeros(d, f // 2)
    whole = torch.zeros(d, f)
    with partitioning.axis_rules(mesh, steps.strategy_rules(cfg, False)):
        assert partitioning.local_block(cfg, local, -1, "p_ff", f)
        assert partitioning.tp_leaf(cfg, "layers.0.mlp.wi")
        assert not partitioning.tp_leaf(cfg, "layers.0.ln1.scale")
        assert partitioning.local_dims(("p_fsdp", "p_ff"), (d, f),
                                       tp=True) == {1: (1,)}
        with pytest.raises(ValueError, match="layout gives 64"):
            partitioning.local_block(cfg, whole, -1, "p_ff", f)
        p = {"wi": whole, "wg": whole, "wo": whole.T}
        with pytest.raises(ValueError, match="layout gives 64"):
            mlp.apply(cfg, p, torch.zeros(1, 2, d))
        seamless = registry.get_config("seamless_m4t_medium")
        assert not partitioning.tp_leaf(seamless, "layers.0.mlp.wi")
        assert not partitioning.local_block(
            seamless, torch.zeros(1, seamless.d_ff), -1, "p_ff",
            seamless.d_ff)
    dp = dataclasses.replace(cfg, mesh_strategy="dp")
    with partitioning.axis_rules(mesh, steps.strategy_rules(dp, False)):
        assert not partitioning.local_block(dp, whole, -1, "p_ff", f)
    assert not partitioning.local_block(cfg, whole, -1, "p_ff", f)
    with pytest.raises(ValueError):
        partitioning.local_block(cfg, local, -1, "p_ff", f)
