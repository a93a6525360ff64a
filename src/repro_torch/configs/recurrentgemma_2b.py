"""recurrentgemma-2b [arXiv:2402.19427; hf]. 26L d=2560 10H (MQA kv=1,
head_dim 256) d_ff=7680, vocab 256000. RG-LRU + local attn (win 2048), 1:2.
Sub-quadratic => runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention="local",
    window_size=2048,
    block_pattern=("recurrent", "recurrent", "attention"),
    lru_width=2560,
    act="gelu",
    scan_layers=False,  # mixed block kinds
    remat="full",
    mesh_strategy="dp",
)
