"""Decoder-only language model (``repro/models/transformer.py``).

:class:`TransformerLM` is the ``nn.Module``: it owns the parameters, named
``embed.table``, ``final_ln.scale``, ``lm_head.w`` and
``layers.<i>.{ln1,ln2}.scale`` / ``layers.<i>.attn.w{q,k,v,o}`` (attention
layers), ``layers.<i>.rec.*`` (recurrent layers of the hybrid family) or
``layers.<i>.tm.*`` (rwkv layers of the ssm family, no MLP) /
``layers.<i>.mlp.w{i,g,o}`` (``layers.<i>.moe.{router,wi,wg,wo}`` in the
MoE family). The math is :func:`forward` and
:func:`loss_fn` over a flat dict of those tensors, so a training round can
run a client's own copy of the parameters through the same code
(``TransformerLM.forward`` passes its own). The reference stacks the layers
on a leading axis for ``lax.scan`` (a hybrid stack is a list); here each
layer is its own module of its kind (``blocks.layer_kinds``) and the stack
is a Python loop. ``remat="full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant); ``remat="dots"`` checkpoints
it selectively (``repro/models/transformer.py:86-89``, the reference's
``dots_with_no_batch_dims_saveable``): the outputs of the matrix products
without batch dims are saved, the rest (batched products, K2's op, the
norms and activations) is recomputed. The layers' aux losses (MoE
load balancing) are summed through the stack, and :func:`loss_fn` adds
0.01 of the sum to the cross-entropy, as the reference.

A VLM (``models/vlm.py``) passes ``embeds`` (B, P, D), precomputed patch
embeddings, which :func:`forward` puts before the token embeddings; its
loss covers the text tail (the labels' length) alone, and its
:func:`prefill` sizes the caches for the patches and the prompt.

The serve paths (``repro/models/transformer.py:202-267``):
:func:`init_caches`, :func:`prefill`, :func:`decode_step` and
:func:`chunk_prefill`, through :func:`forward` with ``mode`` and
``caches``. The caches are a list with one entry per layer (the block's
cache, :func:`blocks.block_cache_init`), where the reference stacks a
uniform stack's caches on a leading layers axis for ``lax.scan`` (and
keeps a hybrid stack's as a list); ``convert.caches_from_jax`` and
``caches_to_numpy`` translate. They are updated in place and returned.

Tensor parallelism (``models/partitioning.py``): :func:`param_axes` and
:func:`cache_axes` give the reference's logical axes, flat and keyed by
the port's names (the reference prepends ``"layers"`` to stacked leaves,
whose rule is ``(None,)``; the port keeps one entry per layer). Where a
step kept the rank's vocabulary rows of ``embed.table`` and columns of
``lm_head.w``, the lookup is vocabulary-parallel (each rank looks up the
tokens in its rows, the others read zeros, and the sum over ``"model"``
is exact) and the head computes the rank's logit columns: the loss is
vocabulary-parallel (:func:`vocab_parallel_cross_entropy`), and the
serving steps' logits are gathered exactly. Where a module splits is read
from ``partitioning.local_block``, the step layout's own decision. A
step's ``partitioning.layer_view`` gathers each layer's sharded leaves
inside the layer (its checkpoint, under remat), one layer at a time.

Left out for later slices: tied embeddings (no config uses them).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import blocks, common, partitioning
from .partitioning import with_logical_constraint

F32 = torch.float32


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // 512) * 512


def param_axes(cfg) -> Dict[str, tuple]:
    """The logical axes of every parameter, keyed as
    ``TransformerLM.named_parameters()`` (``repro/models/transformer.py:
    59-77``)."""
    axes = {"embed.table": ("p_vocab", "p_fsdp"), "final_ln.scale": (None,),
            "lm_head.w": ("p_fsdp", "p_vocab")}
    for i, kind in enumerate(blocks.layer_kinds(cfg)):
        axes.update({f"layers.{i}.{k}": v
                     for k, v in blocks.block_axes(cfg, kind).items()})
    return axes


def cache_axes(cfg):
    """The logical axes of :func:`init_caches`' leaves, one dict a layer
    (``repro/models/transformer.py:214``)."""
    return [blocks.block_cache_axes(cfg, kind)
            for kind in blocks.layer_kinds(cfg)]


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, generator, device=None):
        super().__init__()
        self.table = nn.Parameter(common.normal_init(
            generator, (vocab, d), dtype, stddev=1.0, device=device))


class Readout(nn.Module):
    def __init__(self, d: int, vocab: int, dtype, generator, device=None):
        super().__init__()
        self.w = nn.Parameter(common.normal_init(
            generator, (d, vocab), dtype, device=device))


class TransformerLM(nn.Module):
    """The dense, MoE, VLM, hybrid or ssm (RWKV-6) LM. Parameters are drawn
    from ``generator`` (whose device must be ``device``)."""

    def __init__(self, cfg, generator: torch.Generator, device=None):
        super().__init__()
        if cfg.tie_embeddings:
            raise NotImplementedError("tied embeddings are not ported")
        kinds = blocks.layer_kinds(cfg)  # rejects the encoder-decoder
        self.cfg = cfg
        pv, d, dt = padded_vocab(cfg), cfg.d_model, cfg.torch_dtype
        self.embed = Embedding(pv, d, dt, generator, device)
        self.final_ln = blocks.RMSNorm(d, dt, device)
        self.lm_head = Readout(d, pv, dt, generator, device)
        self.layers = nn.ModuleList(
            blocks.Block(cfg, kind, generator, device) for kind in kinds
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, dict(self.named_parameters()), tokens)


def layer_params(params: Dict[str, torch.Tensor], i: int):
    return blocks.sub(params, f"layers.{i}.")


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matrix products without batch dims (``torch.matmul`` of an
    activation and a weight dispatches ``aten.mm``; ``common.matmul_f32``
    ``aten.mm.dtype`` on the card); recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.mm.dtype):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _layer(cfg, kind: str, prefix: str, p: Dict[str, torch.Tensor], view,
           x: torch.Tensor, positions: torch.Tensor):
    """One layer, its parameters through the step's ``view`` first (inside
    a checkpoint, so a recomputation gathers them again)."""
    return blocks.block_apply(cfg, kind, view(prefix, p), x, positions)


def apply_layers(cfg, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, start: int = 0,
                 stop: Optional[int] = None):
    """Layers ``start`` to ``stop`` (default: all) of the stack on the
    activation ``x`` (B, S, D), each checkpointed under ``remat="full"``
    (selectively under ``"dots"``) when grad mode is on: the backbone of
    :func:`forward`, and a pipeline stage's work (a contiguous range of
    layers). Returns ``(x, aux)``, the sum of the layers' aux losses (0.0
    without an MoE layer)."""
    kinds = blocks.layer_kinds(cfg)
    aux = 0.0
    view = partitioning.current_view()
    for i in range(start, len(kinds) if stop is None else stop):
        layer = functools.partial(_layer, cfg, kinds[i], f"layers.{i}.",
                                  layer_params(params, i), view)
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, positions, use_reentrant=False,
                              preserve_rng_state=False)
        elif cfg.remat == "dots" and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, positions, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=_DOTS_CONTEXT)
        elif cfg.remat in ("none", "full", "dots"):
            x, a = layer(x, positions)
        else:
            raise ValueError(f"remat {cfg.remat!r} is not ported")
        aux = aux + a
    return x, aux


def _head(cfg, params: Dict[str, torch.Tensor], x: torch.Tensor):
    """(the f32 logits, whether they are the rank's vocabulary columns
    only: the step's layout kept ``lm_head.w``'s)."""
    x = common.rmsnorm_apply(params["final_ln.scale"], x, cfg.norm_eps)
    w = params["lm_head.w"]
    tp = partitioning.local_block(cfg, w, 1, "p_vocab", padded_vocab(cfg))
    if tp:
        x = partitioning.enter(x)
    # f32 logits from the activation-dtype inputs, as the reference's
    # preferred_element_type=f32 product.
    logits = torch.matmul(x.to(F32), w.to(F32))
    return with_logical_constraint(
        logits, ("batch", "seq", "vocab") if logits.ndim == 3
        else ("batch", "vocab")), tp


def _logits(cfg, params: Dict[str, torch.Tensor], x: torch.Tensor):
    """The whole f32 logits (a rank's columns gathered exactly)."""
    logits, tp = _head(cfg, params, x)
    return partitioning.gather(logits, logits.ndim - 1) if tp else logits


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``common.softmax_cross_entropy`` of logits whose vocabulary columns
    are split over ``"model"``, each rank holding its (..., V/m) block
    (Megatron's vocabulary-parallel loss): the log-sum-exp of each rank's
    columns is gathered (m values a token) and reduced to the whole
    log-sum-exp, and the gold logit is summed over the ranks, the one
    holding its column and zeros, so no rank gathers the logits."""
    logits = logits.to(F32)
    v = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    logz = torch.logsumexp(partitioning.gather(lse, lse.ndim - 1), dim=-1)
    ids = labels.long() - partitioning.model_index() * v
    mine = (ids >= 0) & (ids < v)
    gold = torch.gather(logits, -1, torch.where(mine, ids, 0)[..., None])
    gold = partitioning.reduce_sum(gold[..., 0] * mine.to(F32))
    return common.masked_mean(logz - gold, mask)


def embed_tokens(cfg, table: torch.Tensor, tokens: torch.Tensor):
    """The embeddings of ``tokens``; vocabulary-parallel where ``table``
    holds the rank's rows."""
    rows = table.shape[0]
    if not partitioning.local_block(cfg, table, 0, "p_vocab",
                                    padded_vocab(cfg)):
        return torch.nn.functional.embedding(tokens.long(), table)
    ids = tokens.long() - partitioning.model_index() * rows
    mine = (ids >= 0) & (ids < rows)
    x = torch.nn.functional.embedding(torch.where(mine, ids, 0), table)
    # one rank holds each token's row and the others add zeros: exact
    x = x * mine[..., None].to(x.dtype)
    return partitioning.reduce_sum(x.to(F32)).to(table.dtype)


def _embed(cfg, params: Dict[str, torch.Tensor], tokens, embeds):
    """The input activations: the token embeddings, or ``embeds`` in the
    model dtype, followed by the token embeddings when both are given."""
    x = None if tokens is None else embed_tokens(cfg, params["embed.table"],
                                                 tokens)
    if embeds is None:
        return x
    e = embeds.to(cfg.torch_dtype)
    return e if x is None else torch.cat([e, x], dim=1)


def _inputs(cfg, params: Dict[str, torch.Tensor], tokens, embeds, positions):
    """(input activations (B, S, D), positions (B, S), default 0..S-1)."""
    x = with_logical_constraint(_embed(cfg, params, tokens, embeds),
                                ("batch", "seq", "embed"))
    if positions is None:
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def forward(cfg, params: Dict[str, torch.Tensor], tokens: Optional[torch.Tensor],
            positions: Optional[torch.Tensor] = None, *, embeds=None,
            mode: str = "train", caches=None, route_rows: bool = False):
    """tokens (B, S) (after ``embeds`` (B, P, D), when given) -> logits
    (B, P + S, padded_vocab) f32 in train mode; in the serve modes
    ("prefill", "decode", "chunk", ``blocks.MODES``) ``(last logits (B,
    V), caches)``, the per-layer caches updated in place
    (``repro/models/transformer.py:161 forward``, whose serve callers all
    take the last position's logits). ``route_rows``: see
    :func:`decode_step`."""
    x, positions = _inputs(cfg, params, tokens, embeds, positions)
    if mode == "train":
        return _logits(cfg, params, apply_layers(cfg, params, x, positions)[0])
    kinds = blocks.layer_kinds(cfg)
    if caches is None or len(caches) != len(kinds):
        raise ValueError(f"mode {mode!r} needs one cache per layer")
    view = partitioning.current_view()
    for i, kind in enumerate(kinds):
        x, caches[i] = blocks.block_apply(
            cfg, kind, view(f"layers.{i}.", layer_params(params, i)), x,
            positions, mode=mode, cache=caches[i], route_rows=route_rows)
    return _logits(cfg, params, x[:, -1]), caches


def loss_fn(cfg, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    """batch: {tokens, labels, [embeds], [mask]} -> scalar mean
    cross-entropy, plus 0.01 x the MoE aux loss. With ``embeds`` the loss
    covers the last ``labels.shape[1]`` positions (the text tail); the
    head runs on those positions alone, row for row the same logits."""
    x, positions = _inputs(cfg, params, batch.get("tokens"),
                           batch.get("embeds"), None)
    x, aux = apply_layers(cfg, params, x, positions)
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:
        x = x[:, -labels.shape[1]:]
    logits, tp = _head(cfg, params, x)
    loss = (vocab_parallel_cross_entropy if tp else
            common.softmax_cross_entropy)(logits, labels, batch.get("mask"))
    return loss + 0.01 * aux if cfg.family == "moe" else loss


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_caches(cfg, batch: int, max_len: int, *, ring: bool = True,
                device=None):
    """One zero cache per layer (``repro/models/transformer.py:202
    init_caches``); ``ring=False`` gives the no-ring attention layout that
    chunked prefill needs."""
    return [blocks.block_cache_init(cfg, kind, batch, max_len, ring=ring,
                                    device=device)
            for kind in blocks.layer_kinds(cfg)]


def prefill(cfg, params: Dict[str, torch.Tensor],
            tokens: Optional[torch.Tensor] = None, *, embeds=None,
            max_len: Optional[int] = None):
    """A prompt (B, S), after ``embeds`` (B, P, D) when given -> (last
    logits (B, V) f32, caches sized for ``max_len`` positions, default P +
    S) (``repro/models/transformer.py:227 prefill``). Attention runs
    ``self_attention``: K2 on the card."""
    first = tokens if tokens is not None else embeds
    b = first.shape[0]
    s = sum(t.shape[1] for t in (tokens, embeds) if t is not None)
    caches = init_caches(cfg, b, max_len or s, device=first.device)
    return forward(cfg, params, tokens, embeds=embeds, mode="prefill",
                   caches=caches)


def decode_step(cfg, params: Dict[str, torch.Tensor], token: torch.Tensor,
                caches, *, route_rows: bool = False):
    """token (B, 1) -> (logits (B, V) f32, caches advanced one position)
    (``repro/models/transformer.py:245 decode_step``). The MoE layers
    route the B tokens as one batch, as the reference's. ``route_rows``
    routes each row's token as its own group instead: the serve slot
    steps (``launch/steps.py``) pass it, as the reference's vmap of a
    batch-1 decode over the slots routes each slot alone."""
    return forward(cfg, params, token, mode="decode", caches=caches,
                   route_rows=route_rows)


def chunk_prefill(cfg, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                  caches, pos0):
    """One prompt chunk (B, C) from absolute position ``pos0`` (an int or a
    0-d tensor, the caches' position) against no-ring caches -> (last
    logits (B, V) f32, caches) (``repro/models/transformer.py:253
    chunk_prefill``). Recurrent and RWKV states continue across the chunk
    boundary; attention writes and reads the no-ring layout."""
    b, c = tokens.shape
    pos0 = torch.as_tensor(pos0, device=tokens.device)
    positions = pos0 + torch.arange(c, device=tokens.device).expand(b, c)
    return forward(cfg, params, tokens, positions, mode="chunk", caches=caches)
