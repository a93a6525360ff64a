"""Paper's 1B local-SGD model (Section 4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="lm_1b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=32768,
    attention="global",
    remat="full",
)
