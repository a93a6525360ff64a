"""rwkv6-3b "Finch" [arXiv:2404.05892; hf]. 32L d=2560 attn-free (WKV6,
head_dim 64 => 40 heads) d_ff=8960 vocab=65536. O(1) state => runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=0,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    remat="full",
    mesh_strategy="dp",
)
