"""Model zoo of the port: the dense LM family (lm_350m) in this slice."""

from .config import ModelConfig

__all__ = ["ModelConfig"]
