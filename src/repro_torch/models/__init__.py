"""Model zoo of the port: the dense, MoE and VLM decoder families, the
hybrid RG-LRU + local-attention family (recurrentgemma_2b), the ssm
family (rwkv6_3b) and the encoder-decoder (seamless_m4t_medium);
``registry.ARCH_IDS`` lists the configs."""

from .config import ModelConfig

__all__ = ["ModelConfig"]
