"""Model zoo of the port: the dense LM family (lm_350m) and the hybrid
RG-LRU + local-attention family (recurrentgemma_2b)."""

from .config import ModelConfig

__all__ = ["ModelConfig"]
