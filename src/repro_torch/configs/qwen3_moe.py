"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert, vocab 151936,
MoE 128 experts top-8. head_dim=128 (Qwen3 uses decoupled head_dim).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    attention="global",
    remat="full",
)
