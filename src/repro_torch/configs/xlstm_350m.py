"""xlstm-350m [ssm]: alternating sLSTM + mLSTM blocks, no separate FFN.
24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                           # per spec: cell-internal projections only
    vocab=50304,
    layer_pattern=("slstm", "mlstm"),
    mlstm_chunk=256,
    supports_long_context=True,       # O(1)/token recurrent state
)
