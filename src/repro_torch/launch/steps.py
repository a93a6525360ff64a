"""Serve steps over the slot pool (``repro/launch/steps.py:272-506``).

The serve half of the reference's step builders:

* :func:`make_prefill_step` / :func:`make_decode_step`: a whole prompt into
  fresh caches (attention through ``self_attention``: K2 on the card), and
  one decode step of such caches;
* the slot-pool steps of the continuous-batching runtime
  (``launch/serve.py``): :func:`make_slot_decode_step` (every slot one
  token), :func:`make_slot_chunk_step` (one prompt chunk into one slot) and
  the fused :func:`make_serve_step` (both in one step), with
  :func:`_gather_slot`, :func:`_scatter_slot` and :func:`_reset_if`.

The pool is the scheduler's state for the life of the server, as the
reference's donated pool is: every step writes it in place, and writes the
greedy next tokens into the token feed ``tokens`` (slots, 1) int32 in
place, so steps chain on the device. Their scalar inputs (``cslot`` (1,)
int64, ``cpos`` () int32, ``cfirst`` and ``cemit`` () bool) are device
tensors, so nothing in a step reads a value on the host.

The reference ``vmap``s a batch-1 decode over the slots, so a request's
tokens cannot depend on who else is in flight. The port decodes the slots
as one batch whose rows each carry their own position (the pool's
position leaves hold one entry per slot, and ``attention.decode_attention``
masks and writes per row), and the pool's shapes are fixed. Every
operation of the decode leg acts on each row alone but one: an MoE
layer's expert capacity couples the tokens of a routing group, so two
slots routed together that pick the same expert could drop one of them,
and a free slot's garbage could evict a live token. The decode leg
therefore routes each row as its own group of one token
(``registry.make_decode_fn(cfg, route_rows=True)``; only these steps
pass it, and a plain decode step routes its batch as one group, as the
reference's ``decode_step``), which is what the reference's batch-1
decode of each slot does; the chunk leg of the fused
step routes the chunk's tokens as their own groups, as the reference's
separate chunk call. So a row's result is the same whatever the other
rows hold.

The serve runtime runs each step through ``runtime.executor.CudaGraphs``
keyed by chunk bucket: on the card its first call for a key runs eagerly
on a side stream, then the same call is captured into a CUDA graph
(recorded, not run) over the same static buffers, and every later call
replays it: the counterpart of the reference's ``jax.jit`` with the pool
donated, one executable per chunk bucket and one decode step. On the CPU
every call runs eagerly. Either way the first call for a key counts as a
build on its ``runtime.executor.TraceCounter``.

The training-step functions of the reference's ``steps.py`` (with their
mesh, FSDP and logical axis rules: the model-parallel half of the
distributed layer) wait for ROADMAP queue 1 item 3, with ``dryrun``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..models import registry


def make_prefill_step(cfg, *, max_len: Optional[int] = None):
    """``prefill_step(params, batch)`` -> (last logits (B, V), caches sized
    for ``max_len``) (``repro/launch/steps.py:276``); an encoder-decoder's
    batch holds ``frames`` beside ``tokens`` (``registry.make_prefill_fn``).
    """
    inner = registry.make_prefill_fn(cfg, max_len=max_len)

    def prefill_step(params, batch):
        with torch.no_grad():
            return inner(params, batch)

    return prefill_step


def make_decode_step(cfg):
    """``decode_step(params, token (B, 1), caches)`` -> (logits (B, V),
    caches) (``repro/launch/steps.py:302``); an encoder-decoder's is
    ``decode_step(params, token, caches, memory_kv)`` (``:304-307``)."""
    inner = registry.make_decode_fn(cfg)

    if cfg.is_encoder_decoder:

        def decode_step(params, token, caches, memory_kv):
            with torch.no_grad():
                return inner(params, token, caches, memory_kv)

        return decode_step

    def decode_step(params, token, caches):
        with torch.no_grad():
            return inner(params, token, caches)

    return decode_step


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------


def _gather_slot(pool, dims, cslot: torch.Tensor):
    """Slot ``cslot`` ((1,) int64) of the pool as a batch-1 cache
    (``repro/launch/steps.py:346``): batch-bearing leaves keep a batch axis
    of 1, position leaves drop their slot axis. A copy: the slot's leaves
    are not views of the pool."""
    return pytree.tree_map(
        lambda leaf, d: (leaf.index_select(0, cslot).reshape(leaf.shape[1:])
                         if d == registry.POS_LEAF
                         else leaf.index_select(0, cslot)), pool, dims)


def _scatter_slot(pool, cache, dims, cslot: torch.Tensor):
    """Write a batch-1 cache back into slot ``cslot`` of the pool, in place
    (``repro/launch/steps.py:362``)."""
    pytree.tree_map(
        lambda leaf, c, d: leaf.index_copy_(
            0, cslot, c.reshape((1,) + tuple(c.shape)) if d == registry.POS_LEAF
            else c), pool, cache, dims)
    return pool


def _reset_if(first: torch.Tensor, cache):
    """Zero a gathered slot's cache where ``first`` (a () bool tensor) is
    set, in place: a reused slot must not see its previous request's keys,
    states or position (``repro/launch/steps.py:374``)."""
    pytree.tree_map(lambda leaf: leaf.masked_fill_(first, 0), cache)
    return cache


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_slot_decode_step(cfg):
    """``slot_decode_step(params, tokens (slots, 1), pool)`` decodes every
    slot one token (``repro/launch/steps.py:412``): the greedy next tokens
    go into ``tokens`` and the pool advances, in place; both are returned.
    Free slots decode garbage the host never reads (fixed shapes, no
    masks). Each slot's token routes alone through MoE layers."""
    decode_fn = registry.make_decode_fn(cfg, route_rows=True)

    def slot_decode_step(params, tokens, pool):
        with torch.no_grad():
            logits, pool = decode_fn(params, tokens, pool)
            tokens.copy_(_greedy(logits)[:, None])
        return tokens, pool

    return slot_decode_step


def make_slot_chunk_step(cfg):
    """``slot_chunk_step(params, pool, cslot, ctokens (C,), cpos, cfirst)``
    -> (chunk_token () int32, pool): one prompt chunk into one slot, with no
    decode leg (``repro/launch/steps.py:438``). ``cfirst`` zero-resets the
    slot first, so a reused slot is never reallocated. The token is the
    greedy continuation after the chunk: meaningful on a prompt's last
    chunk."""
    chunk_fn = registry.make_chunk_prefill_fn(cfg)
    dims = registry.cache_batch_dims(cfg)

    def slot_chunk_step(params, pool, cslot, ctokens, cpos, cfirst):
        with torch.no_grad():
            cache = _reset_if(cfirst, _gather_slot(pool, dims, cslot))
            logits, cache = chunk_fn(params, ctokens[None], cache, cpos)
            pool = _scatter_slot(pool, cache, dims, cslot)
            return _greedy(logits[0]), pool

    return slot_chunk_step


def make_serve_step(cfg):
    """The fused continuous-batching step (``repro/launch/steps.py:465``):
    ``serve_step(params, tokens (slots, 1), pool, cslot, ctokens (C,), cpos,
    cfirst, cemit)`` decodes every slot one token and runs one prompt chunk
    into slot ``cslot``, in one step, so admission never stalls decoding.

    The chunked slot's cache is gathered before the decode leg and
    scattered back after it: the decode leg's write to that slot (it
    decodes every slot) is overwritten whole, which is what makes at most
    one request mid-prefill safe. With ``cemit`` (a prompt's last chunk)
    the chunk's greedy token replaces the slot's entry of the token feed,
    so the request decodes on the very next step. ``tokens`` and the pool
    are written in place and returned. The decode leg routes each slot's
    token alone through MoE layers."""
    decode_fn = registry.make_decode_fn(cfg, route_rows=True)
    chunk_fn = registry.make_chunk_prefill_fn(cfg)
    dims = registry.cache_batch_dims(cfg)

    def serve_step(params, tokens, pool, cslot, ctokens, cpos, cfirst, cemit):
        with torch.no_grad():
            cache = _reset_if(cfirst, _gather_slot(pool, dims, cslot))
            logits, pool = decode_fn(params, tokens, pool)
            nxt = _greedy(logits)[:, None]
            clogits, cache = chunk_fn(params, ctokens[None], cache, cpos)
            pool = _scatter_slot(pool, cache, dims, cslot)
            ctok = _greedy(clogits).reshape(1, 1)
            mine = nxt.index_select(0, cslot)
            nxt.index_copy_(0, cslot, torch.where(cemit, ctok, mine))
            tokens.copy_(nxt)
        return tokens, pool

    return serve_step
