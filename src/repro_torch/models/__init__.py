"""The model stack of the JAX package's ``repro.models`` for every config:
the dense attention ones, the mixture-of-experts ones, the VLM (gated
cross-attention layers), the encoder-decoder and the recurrent ones
(RG-LRU, mLSTM and sLSTM cells): config, layers, blocks
and the decoder's forward, losses and serving paths (``decoder.encode``
runs the encoder).  ``act_shard`` holds the activation-sharding context
that ``moe_ffn_shard_map`` reads; ``partitioning`` and ``act_shard.hint``
are not ported yet (ROADMAP.md §1 item 5; they build on the mesh of
``core/_mesh.py``), and ``hint`` is the identity here."""
from repro_torch.models.config import (SHAPES, SMOKE_SHAPES, ModelConfig,
                                       ShapeConfig, shape_is_supported)
from repro_torch.models.decoder import (decode_step, embed, forward_hidden,
                                        init_params, init_serve_cache,
                                        logits_from_hidden, loss_fn,
                                        num_params, per_example_loss,
                                        prefill)


def hint(x, axes=None):
    """The JAX package's activation-sharding hint: the identity without a
    mesh."""
    del axes
    return x


__all__ = [
    "SHAPES", "SMOKE_SHAPES", "ModelConfig", "ShapeConfig",
    "shape_is_supported",
    "decode_step", "embed", "forward_hidden", "hint", "init_params",
    "init_serve_cache", "logits_from_hidden", "loss_fn", "num_params",
    "per_example_loss", "prefill",
]
