"""recurrentgemma-2b [hybrid]: RG-LRU recurrence + local attention, 1:2
attention:recurrent pattern (Griffin).
26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,                      # 8 groups of (rglru,rglru,local) + 2
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    supports_long_context=True,
)
