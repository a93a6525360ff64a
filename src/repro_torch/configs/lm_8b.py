"""Paper's 8B local-SGD model (Section 4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="lm_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=14336,
    vocab_size=32768,
    attention="global",
    remat="full",
)
