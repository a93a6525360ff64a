"""Model configuration (``repro/models/config.py``), carried over as data.

The same frozen dataclass and the same ``reduced()`` as the reference, so a
config means the same model in both packages. The port runs the dense,
hybrid and ssm (RWKV-6) families; the MoE, encoder-decoder and VLM fields
are kept so configs carry over unchanged, and the model code rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    attention: str = "global"  # global | local | none
    window_size: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    rwkv_head_dim: int = 64
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    frontend: str = "none"
    num_frontend_tokens: int = 0
    eos_id: Optional[int] = None

    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    mesh_strategy: str = "tp"
    scan_layers: bool = True
    remat: str = "none"  # none | full
    attn_impl: str = "blocked"  # blocked | flash | naive
    tp_comm: str = "bf16"
    q_block: int = 512
    kv_block: int = 1024

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.family == "hybrid" and not self.block_pattern:
            object.__setattr__(
                self, "block_pattern", ("recurrent", "recurrent", "attention")
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (as the reference)."""
        small = dict(
            num_layers=min(self.num_layers, 2 * len(self.block_pattern) or 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            lru_width=64,
            window_size=min(self.window_size, 32) if self.window_size else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=(
                min(self.experts_per_token, 2) if self.experts_per_token else 0
            ),
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=(
                min(self.num_frontend_tokens, 8) if self.num_frontend_tokens else 0
            ),
            dtype="float32",
            attn_impl="naive",
            q_block=8,
            kv_block=8,
        )
        if self.family == "hybrid":
            small["num_layers"] = len(self.block_pattern)
        small.update(overrides)
        return dataclasses.replace(self, **small)
