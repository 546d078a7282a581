"""gemma3-27b [dense]: 5:1 local:global attention pattern, 128k context.
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,                      # 10 groups of (5 local + 1 global) + 2
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,                      # gemma3 local window
    rope_theta=1_000_000.0,
    supports_long_context=True,       # 5/6 layers windowed; global layers
                                      # are O(S) per decoded token
)
