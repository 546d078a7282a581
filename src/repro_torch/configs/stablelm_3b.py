"""stablelm-3b [dense]: full-attention MHA-style GQA (kv == heads).
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    layer_pattern=("full",),
    rope_theta=10_000.0,
    supports_long_context=False,      # pure full attention -> long_500k skip
)
