"""yi-34b [arXiv:2403.04652; hf]. llama-arch GQA: 60L d=7168 56H (kv=8)
d_ff=20480 vocab=64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi_34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="global",
    remat="full",
)
