"""VLM (llava-next) backbone (``repro/models/vlm.py``): the decoder-only LM
of :mod:`transformer` taking precomputed patch embeddings.

The vision tower and the anyres tiling are a stub in the reference too:
the caller passes patch embeddings (B, n_patches, D), which go before the
text-token embeddings; the loss covers the text positions alone
(``transformer.loss_fn``).
"""

from __future__ import annotations

from . import transformer

forward = transformer.forward
loss_fn = transformer.loss_fn
prefill = transformer.prefill
decode_step = transformer.decode_step
init_caches = transformer.init_caches
param_axes = transformer.param_axes
cache_axes = transformer.cache_axes
