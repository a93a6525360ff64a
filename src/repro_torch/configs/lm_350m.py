"""Paper's 350M local-SGD model (Section 4). GPT-style, seq 512."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="lm_350m",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=32768,
    attention="global",
    remat="full",
    mesh_strategy="dp",
)
