"""seamless-m4t-medium [arXiv:2308.11596; hf]. Enc-dec, 12L+12L d=1024 16H
(kv=16) d_ff=4096 vocab=256206. Speech frontend STUBBED to frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium",
    family="audio",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attention="global",
    frontend="audio_frames",
    remat="full",
    mesh_strategy="dp",
)
