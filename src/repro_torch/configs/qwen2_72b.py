"""qwen2-72b [arXiv:2407.10671; hf]. 80L d=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    attention="global",
    remat="full",
)
