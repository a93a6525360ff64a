"""Delta compression: the int8 wire format with flat packing, top-k
sparsification and error feedback."""

from .api import (
    PACK_COLS,
    ErrorFeedback,
    PackSpec,
    flat_pack,
    flat_unpack,
    int8_roundtrip,
    topk_sparsify,
    topk_sparsify_layers,
)

__all__ = ["ErrorFeedback", "PACK_COLS", "PackSpec", "flat_pack",
           "flat_unpack", "int8_roundtrip", "topk_sparsify",
           "topk_sparsify_layers"]
