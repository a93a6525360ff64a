"""llava-next-34b [hf:llava-hf family; unverified] — yi-34b LM backbone,
anyres vision tiling STUBBED to precomputed patch embeddings (2880 tokens).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="global",
    frontend="vision_patches",
    num_frontend_tokens=2880,  # anyres: base 576 + 4 tiles x 576
    remat="full",
)
