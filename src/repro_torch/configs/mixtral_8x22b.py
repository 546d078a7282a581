"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    layer_pattern=("swa",),
    window=4096,
    num_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
    supports_long_context=True,
)
