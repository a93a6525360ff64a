"""stablelm-3b (``repro/configs/stablelm_3b.py``), carried over as data.
32L d=2560 32H (kv=32 => full MHA) head_dim 80, d_ff=6912 vocab=50304: the
reference serve runtime's default architecture."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    attention="global",
    remat="full",
    mesh_strategy="dp",
)
