"""Delta compression (int8 wire format and flat packing)."""

from .api import (
    PACK_COLS,
    PackSpec,
    flat_pack,
    flat_unpack,
    int8_roundtrip,
)

__all__ = ["PACK_COLS", "PackSpec", "flat_pack", "flat_unpack",
           "int8_roundtrip"]
