"""Model configuration: the port's own copy of the JAX package's
``repro/models/config.py``, field for field, apart from one documented
drop: ``attention_backend``, since the device of the tensors picks the
kernel (a CUDA tensor) or the plain version (a CPU tensor).

A model is a cyclic ``layer_pattern`` of block kinds repeated to
``n_layers`` (the repeating group is the lax.scan body, so compile time is
~independent of depth).  Block kinds:

  full    causal self-attention (no window)
  swa     causal sliding-window self-attention
  local   alias of swa (gemma/recurrentgemma naming)
  global  alias of full (gemma3's 5:1 local:global pattern)
  xattn   causal self-attention + gated cross-attention to aux tokens (VLM)
  rglru   RG-LRU recurrent block w/ temporal conv (RecurrentGemma)
  mlstm   xLSTM matrix-memory block (chunkwise-parallel linear attention)
  slstm   xLSTM scalar-memory block (sequential scan)

Encoder-decoder models (whisper) add an encoder stack of bidirectional
blocks plus cross-attention in every decoder block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ATTN_KINDS = ("full", "swa", "local", "global", "xattn", "enc", "dec")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("full",)
    window: int = 0                   # SWA window (rows), 0 = disabled
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense FFN in parallel w/ MoE
    #: "gspmd"     — global routing, GSPMD partitions the scatter/gather
    #: "shard_map" — group-local routing per data shard, TP-sharded expert
    #:               weights, ONE activation-sized psum per layer (§Perf H2)
    moe_impl: str = "gspmd"

    # VLM / enc-dec auxiliaries (modality frontends are stubs: input_specs
    # provides precomputed embeddings at d_model)
    vision_tokens: int = 0
    enc_layers: int = 0
    enc_seq: int = 0

    # recurrent blocks
    rnn_width: int = 0                # RG-LRU lru width (0 -> d_model)
    conv_width: int = 4
    mlstm_chunk: int = 256

    # embeddings / output
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 2048    # lcm(model_axis=16, lane=128)
    norm_eps: float = 1e-6

    # numerics & runtime
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    #: dtype of projection-matmul OUTPUTS (and hence of the TP partial-sum
    #: all-reduces GSPMD fuses to them).  "float32" = conservative baseline;
    #: "compute" = bf16 reductions (halves TP collective traffic — §Perf H1)
    matmul_out_dtype: str = "float32"
    adam_dtype: str = "float32"
    remat: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 1024
    loss_chunk: int = 1024            # tokens per vocab-logit chunk (0=off)
    scan_layers: bool = True

    # which serve shapes are legal (long_500k skipped for pure full attn)
    supports_long_context: bool = False

    # --- derived -------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return self.vocab + (-self.vocab) % m

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def rem_pattern(self) -> Tuple[str, ...]:
        rem = self.n_layers % self.pattern_len
        return self.layer_pattern[:rem]

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def num_params(self) -> int:
        """Total parameter count (analytic; used for MODEL_FLOPS)."""
        d, dh = self.d_model, self.head_dim_
        hq, hkv, f = self.n_heads, self.n_kv_heads, self.d_ff
        per_kind = {}
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        mlp = 3 * d * f if f else 0
        moe = (d * self.num_experts
               + self.num_experts * 3 * d * f) if self.num_experts else 0
        if self.num_experts:
            mlp = moe + (3 * d * f if self.dense_residual else 0)
        rglru = (d * 3 * self.rnn_width_ + self.conv_width * self.rnn_width_
                 + 2 * self.rnn_width_ + self.rnn_width_ * d)
        lstm = (4 * d * hq * dh + 4 * hq * dh * dh + 3 * d * hq * dh)
        norms = 2 * d
        per_kind.update(full=attn + mlp + norms, swa=attn + mlp + norms,
                        local=attn + mlp + norms, global_=attn + mlp + norms,
                        xattn=2 * attn + mlp + norms + d,
                        rglru=rglru + mlp + norms,
                        mlstm=lstm + norms, slstm=lstm + mlp + norms,
                        enc=attn + mlp + norms, dec=2 * attn + mlp + norms)
        total = 0
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % self.pattern_len]
            total += per_kind[kind if kind != "global" else "global_"]
        if self.is_encdec:
            total += self.enc_layers * per_kind["enc"]
        total += self.padded_vocab * d      # embedding
        if not self.tie_embeddings:
            total += d * self.padded_vocab
        total += d                          # final norm
        return total

    def uncounted_params(self) -> int:
        """What the analytic ``num_params`` miscounts, signed, so that
        ``num_params() + uncounted_params()`` is the parameters' own count:
        it leaves out a gate a cross-attention, an x_norm a ``dec`` layer
        (an ``xattn`` layer's is counted) and the encoder's final norm; an
        ``rglru`` layer holds 2r² - d·r - r more than it counts, an
        ``mlstm`` layer 2·d·h - 4·h·dh² - 3·d·h·dh - d and an ``slstm``
        layer -2·d·h·dh - d."""
        d, h, dh, r = self.d_model, self.n_heads, self.head_dim_, \
            self.rnn_width_
        kinds = [self.layer_pattern[i % self.pattern_len]
                 for i in range(self.n_layers)]
        return (kinds.count("xattn") + kinds.count("dec") * (d + 1)
                + (d if self.is_encdec else 0)
                + kinds.count("rglru") * (2 * r * r - d * r - r)
                + kinds.count("mlstm") * (2 * d * h - 4 * h * dh * dh
                                          - 3 * d * h * dh - d)
                + kinds.count("slstm") * (-2 * d * h * dh - d))

    def num_active_params(self) -> int:
        """Per-token active params (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        inactive = (self.num_experts - self.top_k) * 3 * d * f
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.layer_pattern[i % self.pattern_len] in
            ("full", "swa", "local", "global"))
        return self.num_params() - inactive * n_moe_layers

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide"
        assert self.d_model % self.n_heads == 0 or self.head_dim, \
            "head_dim underivable"
        if self.num_experts:
            assert self.top_k <= self.num_experts
        for k in self.layer_pattern:
            assert k in ATTN_KINDS + RECURRENT_KINDS, k


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 64, 2),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 96, 2),
    "decode_32k": ShapeConfig("decode_32k", "decode", 96, 2),
    "long_500k": ShapeConfig("long_500k", "decode", 128, 1),
}


def shape_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if supported, else a skip reason (recorded in DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k-token cache is "
                "assignment-sanctioned skip (DESIGN.md §6)")
    return None
