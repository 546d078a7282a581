"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000
[arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    layer_pattern=("swa",),
    window=4096,                      # mistral-style SWA
    rope_theta=10_000.0,
    supports_long_context=True,       # SWA caps attention cost
)
