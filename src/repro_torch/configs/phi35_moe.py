"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert, vocab 32064,
MoE 16 experts top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi35_moe",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    attention="global",
    remat="full",
)
