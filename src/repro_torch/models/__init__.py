"""The model stack of the JAX package's ``repro.models`` for every config:
the dense attention ones, the mixture-of-experts ones, the VLM (gated
cross-attention layers), the encoder-decoder and the recurrent ones
(RG-LRU, mLSTM and sLSTM cells): config, layers, blocks
and the decoder's forward, losses and serving paths (``decoder.encode``
runs the encoder).  ``partitioning`` gives every leaf of the params,
caches and batches its logical axes; ``act_shard`` holds the
activation-sharding context and ``hint``, which redistributes a DTensor
activation to the placements the context resolves (the identity with no
context or on a plain tensor); ``sharded`` runs the blocks on a mesh,
each sublayer on its rank's local shards."""
from repro_torch.models.config import (SHAPES, SMOKE_SHAPES, ModelConfig,
                                       ShapeConfig, shape_is_supported)
from repro_torch.models.act_shard import hint
from repro_torch.models.decoder import (decode_step, embed, forward_hidden,
                                        init_params, init_serve_cache,
                                        logits_from_hidden, loss_fn,
                                        num_params, per_example_loss,
                                        prefill)


__all__ = [
    "SHAPES", "SMOKE_SHAPES", "ModelConfig", "ShapeConfig",
    "shape_is_supported",
    "decode_step", "embed", "forward_hidden", "hint", "init_params",
    "init_serve_cache", "logits_from_hidden", "loss_fn", "num_params",
    "per_example_loss", "prefill",
]
