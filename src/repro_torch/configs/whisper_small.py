"""whisper-small [audio]: encoder-decoder backbone; the conv audio frontend
is a STUB (input_specs provides precomputed frame embeddings at d_model).
12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                      # decoder depth (12L per spec)
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    layer_pattern=("dec",),           # causal self + cross to encoder
    enc_layers=12,
    enc_seq=1500,                     # 30 s of audio at 50 Hz frames
    rope_theta=10_000.0,
    supports_long_context=False,
)
