"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual FFN.
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base; hf]

The JAX package's config, field for field: its params (and Adam
states) are held in bf16."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    layer_pattern=("full",),
    num_experts=128,
    top_k=2,
    dense_residual=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    adam_dtype="bfloat16",
    supports_long_context=False,
)
