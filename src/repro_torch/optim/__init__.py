"""Optimizer substrate: AdamW updating in place, bf16 gradient compression
with error feedback, and EARL-adaptive gradient accumulation."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.compression import (compress_decompress,
                                           error_feedback_compress,
                                           init_residual)
from repro_torch.optim.adaptive_accum import (AccumDecision,
                                              earl_accumulate_gradients,
                                              gradient_cv)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update", "global_norm",
    "compress_decompress", "error_feedback_compress", "init_residual",
    "AccumDecision", "earl_accumulate_gradients", "gradient_cv",
]
