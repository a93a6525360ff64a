"""Model configuration (``repro/models/config.py``), carried over as data.

The same frozen dataclass and the same ``reduced()`` as the reference, so a
config means the same model in both packages. The port runs every family
of the reference: the dense, MoE, VLM, hybrid and ssm (RWKV-6) decoders
and the encoder-decoder (``models/encdec.py``).

The parameter accounting (``repro/models/config.py:98-186``) is the
reference's formulas: ``param_count`` counts every weight at the
unpadded vocabulary, ``active_param_count`` the weights one token touches
(an MoE layer's routed experts only), for 6 x N x D FLOP accounting.
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
    remat: str = "none"  # none | full | dots
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

    def _attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # gated: wi, wg, wo

    def _rglru_params(self) -> int:
        w = self.lru_width
        return 2 * self.d_model * w + 2 * w * (w // 8) * 8 // 8 + 2 * w

    def _rwkv_params(self) -> int:
        d = self.d_model
        tm = 5 * d * d + 2 * d * 64 + 6 * d
        cm = 2 * d * self.d_ff + d * d
        return tm + cm

    def layer_params(self, layer_kind: str = "attention") -> int:
        norms = 2 * self.d_model
        if self.family == "ssm":
            return self._rwkv_params() + norms
        if layer_kind == "recurrent":
            return self._rglru_params() + self._dense_ffn_params() + norms
        if self.family == "moe":
            ffn = (self.num_experts * self._dense_ffn_params()
                   + self.d_model * self.num_experts)  # experts + router
        else:
            ffn = self._dense_ffn_params()
        return self._attn_params() + ffn + norms

    def active_layer_params(self) -> int:
        """Parameters one token touches in a layer (MoE: its routed
        experts and the router)."""
        if self.family != "moe":
            return self.layer_params()
        ffn = (self.experts_per_token * self._dense_ffn_params()
               + self.d_model * self.num_experts)
        return self._attn_params() + ffn + 2 * self.d_model

    def _pattern_counts(self):
        if self.family != "hybrid":
            return {"attention": self.num_layers}
        pat = self.block_pattern
        full, rem = divmod(self.num_layers, len(pat))
        counts = {}
        for i, kind in enumerate(pat):
            counts[kind] = counts.get(kind, 0) + full + (1 if i < rem else 0)
        return counts

    def _embed_params(self) -> int:
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return self.vocab_size * self.d_model + head

    def param_count(self) -> int:
        body = sum(cnt * self.layer_params(kind)
                   for kind, cnt in self._pattern_counts().items())
        if self.is_encoder_decoder:
            body += self.encoder_layers * self.layer_params()
            body += self.num_layers * self._attn_params()  # cross-attention
        return self._embed_params() + body + self.d_model  # final norm

    def active_param_count(self) -> int:
        body = 0
        for kind, cnt in self._pattern_counts().items():
            if kind == "attention" or self.family != "hybrid":
                body += cnt * self.active_layer_params()
            else:
                body += cnt * self.layer_params(kind)
        if self.is_encoder_decoder:
            body += self.encoder_layers * self.active_layer_params()
            body += self.num_layers * self._attn_params()
        return self._embed_params() + body + self.d_model

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
