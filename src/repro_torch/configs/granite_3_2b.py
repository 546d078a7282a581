"""granite-3-2b [dense]: GQA full attention.
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,                      # padded to 51200 (vocab_pad_multiple)
    layer_pattern=("full",),
    rope_theta=10_000.0,
    supports_long_context=False,
)
