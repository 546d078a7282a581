"""llama-3.2-vision-90b [vlm]: decoder with gated cross-attention image
layers every 5th layer (20 of 100).  Vision frontend is a STUB: input_specs
provides precomputed patch embeddings at d_model.
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    layer_pattern=("full", "full", "full", "full", "xattn"),
    vision_tokens=1600,               # stub ViT patch-embedding count
    rope_theta=500_000.0,
    supports_long_context=False,
)
