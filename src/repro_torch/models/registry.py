"""Architecture registry (``repro/models/registry.py``): config lookup,
parameter init, the loss, the serve functions, the training batch's
shapes and the serve slot pool's layout. The port registers every
architecture of the reference: the dense lm_350m, lm_1b, lm_8b, yi_34b,
internlm2_20b, qwen2_72b (qkv bias) and stablelm_3b, the MoE phi35_moe and
qwen3_moe, the VLM llava_next_34b, recurrentgemma_2b (hybrid: RG-LRU and
local attention), rwkv6_3b (ssm: RWKV-6) and the encoder-decoder
seamless_m4t_medium (:mod:`encdec`).

The distributed layer's specs (``repro/models/registry.py:55-130,
285-305``): :func:`param_axes` and :func:`batch_axes` (logical axes, the
parameters' keyed by the port's names), and the "specs" of a step's inputs
(:func:`param_specs`, :func:`train_batch_spec`, :func:`decode_state_spec`,
:func:`prefill_spec`, :func:`decode_token_spec`): trees of tensors on the
``meta`` device, shapes and dtypes that are never allocated, the
counterpart of the reference's ``ShapeDtypeStruct`` trees.

The slot pool (``repro/models/registry.py:198-265``) is the per-layer
cache list of :func:`transformer.init_caches` at ``slots`` rows in the
no-ring layout, every position leaf (:data:`POS_LEAF`) given one entry
per slot. In the port's unstacked layout every batch-bearing leaf has its
batch axis first, so the slot axis of every leaf is 0
(:func:`slot_vmap_axes`), where the reference's stacked leaves carry it at
1, after the layers axis. Chunked prefill and the slot pool take
token-only decoders, as the reference's do."""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import compat
from . import encdec, partitioning, transformer, vlm
from .config import ModelConfig

ARCH_IDS = ("lm_350m", "lm_1b", "lm_8b", "yi_34b", "internlm2_20b",
            "qwen2_72b", "stablelm_3b", "phi35_moe", "qwen3_moe",
            "llava_next_34b", "recurrentgemma_2b", "rwkv6_3b",
            "seamless_m4t_medium")


# The dry run's shape cells (``repro/models/registry.py:38-47``).
SHAPE_CELLS: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# archs whose cost grows less than quadratically in the sequence: the only
# ones that run the 512k decode cell
SUBQUADRATIC = ("recurrentgemma_2b", "rwkv6_3b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh parameters as a flat dict of tensors on ``device``, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the same seed
    gives other numbers on the CPU than on the card): the family's module,
    :class:`encdec.EncDecLM` or :class:`transformer.TransformerLM`."""
    dev = compat.resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    lm = encdec.EncDecLM if cfg.is_encoder_decoder else transformer.TransformerLM
    with torch.no_grad():
        model = lm(cfg, generator, device=dev)
    return {k: v.detach() for k, v in model.named_parameters()}


def cell_applicable(cfg: ModelConfig, cell: str):
    """(applicable, reason) of a dry-run cell for ``cfg``
    (``repro/models/registry.py:55-58``)."""
    if cell == "long_500k" and cfg.attention == "global" and cfg.family != "ssm":
        return False, "full attention is O(S^2); 512k decode out of scope"
    return True, ""


def family_module(cfg: ModelConfig):
    """The module of ``cfg``'s family (``repro/models/registry.py:53-59``):
    :mod:`encdec`, :mod:`vlm` or :mod:`transformer`."""
    if cfg.is_encoder_decoder:
        return encdec
    return vlm if cfg.family == "vlm" else transformer


def param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of every parameter, keyed as :func:`init_params`'
    dict."""
    return family_module(cfg).param_axes(cfg)


def param_specs(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """:func:`init_params`' tensors on the ``meta`` device: their shapes
    and dtypes, nothing allocated."""
    lm = encdec.EncDecLM if cfg.is_encoder_decoder else transformer.TransformerLM
    with torch.no_grad():
        model = lm(cfg, torch.Generator(), device="meta")
    return {k: v.detach() for k, v in model.named_parameters()}


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return family_module(cfg).loss_fn(cfg, params, batch)


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int):
    """{name: (shape, dtype)} of one training step's batch
    (``repro/models/registry.py:90-108 train_batch_spec``): an
    encoder-decoder's frames (B, seq, D) and max(seq // 8, 16) text
    tokens and labels; a VLM's patch embeddings (at most half of ``seq``)
    before the text; else seq tokens and labels."""
    if cfg.is_encoder_decoder:
        st = max(seq // 8, 16)
        return {"frames": ((batch, seq, cfg.d_model), cfg.torch_dtype),
                "tokens": ((batch, st), torch.int32),
                "labels": ((batch, st), torch.int32)}
    if cfg.family == "vlm":
        nf = max(min(cfg.num_frontend_tokens, seq // 2), 1)
        return {"embeds": ((batch, nf, cfg.d_model), cfg.torch_dtype),
                "tokens": ((batch, seq - nf), torch.int32),
                "labels": ((batch, seq - nf), torch.int32)}
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int):
    """One training batch as ``meta`` tensors (``repro/models/registry.py:
    90-108``)."""
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in
            train_batch_shapes(cfg, batch, seq).items()}


def batch_axes(cfg: ModelConfig):
    """The logical axes of the training batch (``repro/models/registry.py:
    111-125``)."""
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.is_encoder_decoder:
        axes["frames"] = ("batch", "seq", "embed")
    elif cfg.family == "vlm":
        axes["embeds"] = ("batch", "seq", "embed")
    return axes


def make_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
               lead=(), device="cuda") -> Dict[str, torch.Tensor]:
    """A training batch of :func:`train_batch_shapes` from numpy streams
    spawned off ``SeedSequence(seed)``, one per leaf in name order: token
    ids uniform below the vocabulary, embeddings standard normals cast to
    the model dtype. ``lead`` prefixes every shape (e.g. (cohort,
    local_steps) for a round's data). The counterpart of the reference's
    ``make_concrete_batch``, whose ``jax.random`` numbers differ."""
    dev = compat.resolve_device(device)
    shapes = train_batch_shapes(cfg, batch, seq)
    streams = np.random.SeedSequence(seed).spawn(len(shapes))
    out = {}
    for (name, (shape, dtype)), ss in zip(sorted(shapes.items()), streams):
        rng = np.random.default_rng(ss)
        shape = tuple(lead) + shape
        if dtype == torch.int32:
            a = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
        else:
            a = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dtype)
        out[name] = a.to(dev)
    return out


# ---------------------------------------------------------------------------
# serve functions
# ---------------------------------------------------------------------------


def _decoder_only(cfg: ModelConfig, what: str) -> None:
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise ValueError(f"{what} supports token-only decoder models; "
                         f"{cfg.name} is {cfg.family}")


def make_prefill_fn(cfg: ModelConfig, *, max_len: Optional[int] = None):
    """``prefill_fn(params, batch)`` -> (last logits, caches sized for
    ``max_len``, default the prompt length) (``repro/models/registry.py:
    149``); a VLM's batch holds ``embeds`` (B, P, D) beside ``tokens``,
    and its caches hold P + S positions; an encoder-decoder's holds
    ``frames`` (B, Sf, D) beside ``tokens``, and its memory K/V are
    dropped, as the reference drops them (``registry.py:155-162``)."""
    mod = family_module(cfg)

    if cfg.is_encoder_decoder:

        def prefill_fn(params, batch):
            logits, caches, _ = mod.prefill(cfg, params, batch["frames"],
                                            batch["tokens"], max_len=max_len)
            return logits, caches

        return prefill_fn

    if cfg.family == "vlm":

        def prefill_fn(params, batch):
            return mod.prefill(cfg, params, batch["tokens"],
                               embeds=batch["embeds"], max_len=max_len)

        return prefill_fn

    def prefill_fn(params, batch):
        return mod.prefill(cfg, params, batch["tokens"], max_len=max_len)

    return prefill_fn


def make_decode_fn(cfg: ModelConfig, *, route_rows: bool = False):
    """``decode_fn(params, token (B, 1), caches)`` -> (logits (B, V),
    caches) (``repro/models/registry.py:180``); an MoE layer routes the B
    tokens as one batch, as the reference's. ``route_rows`` is internal to
    the serve slot steps (``launch/steps.py``): each row's token routes
    alone (``transformer.decode_step``). An encoder-decoder's is
    ``decode_fn(params, token, caches, memory_kv)`` (``:183-189``)."""
    mod = family_module(cfg)

    if cfg.is_encoder_decoder:

        def decode_fn(params, token, caches, memory_kv):
            return mod.decode_step(cfg, params, token, caches, memory_kv)

        return decode_fn

    def decode_fn(params, token, caches):
        return mod.decode_step(cfg, params, token, caches,
                               route_rows=route_rows)

    return decode_fn


def make_chunk_prefill_fn(cfg: ModelConfig):
    """``chunk_fn(params, tokens (B, C), caches, pos0)`` -> (last logits,
    caches), continuing no-ring caches from ``pos0``
    (``repro/models/registry.py:266``); refuses models that are not
    token-only decoders, as the reference does."""
    _decoder_only(cfg, "chunked prefill")

    def chunk_fn(params, tokens, caches, pos0):
        return transformer.chunk_prefill(cfg, params, tokens, caches, pos0)

    return chunk_fn


# ---------------------------------------------------------------------------
# the serve slot pool
# ---------------------------------------------------------------------------

POS_LEAF = -1  # a leaf with no batch axis: an attention cache's "pos"


def cache_batch_dims(cfg: ModelConfig):
    """The batch axis of every leaf of :func:`transformer.init_caches`'s
    tree, or :data:`POS_LEAF` for a position (``repro/models/registry.py:
    208``): a list with one dict per layer."""
    _decoder_only(cfg, "slot pools")
    caches = transformer.init_caches(cfg, 1, 1, ring=False, device="meta")
    return [{k: POS_LEAF if k == "pos" else 0 for k in c} for c in caches]


def slot_vmap_axes(cfg: ModelConfig):
    """The slot axis of every leaf of the pool (``repro/models/registry.py:
    233``): 0 for all, the port's layout putting the batch axis first and
    giving a position leaf its slot axis first. Kept for parity with the
    reference, whose steps ``vmap`` over these axes: the port's steps
    decode the pool as one batch and read none of it."""
    return pytree.tree_map(lambda d: 0, cache_batch_dims(cfg))


def init_slot_pool(cfg: ModelConfig, slots: int, max_len: int, *,
                   device="cuda", mesh=None):
    """The serve cache pool, allocated once for the life of the server and
    updated in place (``repro/models/registry.py:239``): the no-ring caches
    of ``slots`` rows, each position leaf with one entry per slot.

    With ``mesh``, each leaf is a DTensor at the placements of
    :func:`slot_pool_axes` under the default rules, and a rank allocates
    only its storage block: its slots where ``kv_batch`` shards them (the
    data ranks), its kv heads where they split over ``"model"``. A pool
    whose slots do not split over the data ranks raises ``ValueError``
    (:func:`slot_shards`)."""
    if mesh is not None:
        return _slot_pool_on_mesh(cfg, slots, max_len, device, mesh)
    dev = compat.resolve_device(device) if str(device) != "meta" else device
    caches = transformer.init_caches(cfg, slots, max_len, ring=False,
                                     device=dev)
    return pytree.tree_map(
        lambda leaf, d: leaf if d != POS_LEAF else torch.zeros(
            (slots,) + tuple(leaf.shape), dtype=leaf.dtype,
            device=leaf.device),
        caches, cache_batch_dims(cfg))


def slot_pool_axes(cfg: ModelConfig):
    """The logical axes of the pool's leaves: :func:`cache_axes`, a
    position leaf's slot axis ``kv_batch``."""
    return pytree.tree_map(
        lambda ax, d: ("kv_batch",) if d == POS_LEAF else ax,
        cache_axes(cfg), cache_batch_dims(cfg),
        is_leaf=partitioning.is_axes_leaf)


def slot_shards(mesh, slots: int) -> int:
    """How many ranks ``mesh`` splits a pool's ``slots`` over: the ranks
    of the first ``kv_batch`` candidate of the default rules whose axes
    the mesh has. Raises ``ValueError`` where they do not divide
    ``slots`` (the rules would keep such a pool whole on every rank)."""
    with partitioning.axis_rules(mesh):
        n = partitioning._shards(partitioning.mesh_dims(
            partitioning.resolve_axis("kv_batch")))
    if slots % n:
        raise ValueError(f"a pool of {slots} slots does not split over the "
                         f"mesh's {n} data ranks")
    return n


def _slot_pool_on_mesh(cfg, slots, max_len, device, mesh):
    slot_shards(mesh, slots)
    dev = compat.resolve_device(device)
    whole = init_slot_pool(cfg, slots, max_len, device="meta")
    axes = slot_pool_axes(cfg)

    def one(ax, leaf):
        shape = tuple(leaf.shape)
        local = list(shape)
        for i, dims in partitioning.sharded_dims(ax, shape).items():
            local[i] //= partitioning._shards(dims)
        return partitioning.wrap(
            torch.zeros(local, dtype=leaf.dtype, device=dev), ax, shape)

    with partitioning.axis_rules(mesh):
        return pytree.tree_map(one, axes, whole,
                               is_leaf=partitioning.is_axes_leaf)


def slot_pool_bytes(cfg: ModelConfig, slots: int, max_len: int) -> int:
    """The bytes the slot pool pins (``repro/models/registry.py:256``),
    from its shapes on the meta device (nothing allocated)."""
    pool = init_slot_pool(cfg, slots, max_len, device="meta")
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(pool))


# ---------------------------------------------------------------------------
# serve input specs (``repro/models/registry.py:285-305``)
# ---------------------------------------------------------------------------


def cache_axes(cfg: ModelConfig):
    """The logical axes of the serve caches' leaves, one dict a layer."""
    return family_module(cfg).cache_axes(cfg)


def decode_state_spec(cfg: ModelConfig, batch: int, max_len: int):
    """(caches, extras) of a decode step as ``meta`` tensors; an
    encoder-decoder's extras hold ``memory_kv``, one (k, v) pair a decoder
    layer of (B, max_len, Hkv, hd)."""
    caches = family_module(cfg).init_caches(cfg, batch, max_len,
                                            device="meta")
    extras = {}
    if cfg.is_encoder_decoder:
        kv = torch.empty((batch, max_len, cfg.num_kv_heads, cfg.head_dim),
                         dtype=cfg.torch_dtype, device="meta")
        extras["memory_kv"] = [(kv, kv) for _ in range(cfg.num_layers)]
    return caches, extras


def prefill_spec(cfg: ModelConfig, batch: int, seq: int):
    return train_batch_spec(cfg, batch, seq)


def decode_token_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, 1), dtype=torch.int32, device="meta")
