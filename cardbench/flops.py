"""The benchmark's own count of the work a cell needs, and the card's
peaks: the yardstick of every share of a peak or of a roofline.

The count is of the work the model needs, from the cell's shapes, and
stays the same whatever implements it: 2·N operations a token for each
forward product of N weights (3× that in training: the backward's two
products), attention at 4·D operations a visible (query, key) pair and
query head forward and 10·D backward, visible pairs counted under the
causal mask and the window, nothing for a recompute, the vocabulary as
published (not padded).  Bytes count each input read once and each
output written once.
"""
from __future__ import annotations

#: NVIDIA's data sheet for one H100 SXM at its 700 W limit: dense bf16
#: tensor-core operations a second, and HBM3 bytes a second
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

ATTENTION_KINDS = {"full": False, "global": False, "swa": True,
                   "local": True}


def layer_kinds(cfg):
    """Each layer's kind, in order."""
    return [cfg.layer_pattern[i % len(cfg.layer_pattern)]
            for i in range(cfg.n_layers)]


def layer_window(cfg, kind: str) -> int:
    """The window a layer of ``kind`` attends over, 0 for none."""
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(f"no count for layers of kind {kind!r}")
    return cfg.window if ATTENTION_KINDS[kind] else 0


def visible_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention over ``seq`` positions
    computes, key j visible to query i where i - window < j <= i."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def product_weights(cfg) -> int:
    """Weights in the layers' forward products (the logits apart)."""
    d, hq, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim_, cfg.d_ff)
    per = 2 * d * hq * dh + 2 * d * hkv * dh + 3 * d * f
    return per * cfg.n_layers


def attention_pairs(cfg, batch: int, seq: int) -> int:
    """Visible pairs over every layer, query head and sequence."""
    return sum(visible_pairs(seq, layer_window(cfg, k))
               for k in layer_kinds(cfg)) * cfg.n_heads * batch


def forward_ops(cfg, batch: int, seq: int, logit_rows: int) -> float:
    """A forward over ``batch`` sequences of ``seq`` tokens, with the
    logits of ``logit_rows`` positions."""
    return (2.0 * product_weights(cfg) * batch * seq
            + 2.0 * cfg.d_model * cfg.vocab * logit_rows
            + 4.0 * cfg.head_dim_ * attention_pairs(cfg, batch, seq))


def train_ops(cfg, batch: int, seq: int) -> float:
    """A training step (forward and backward) over batch x seq tokens,
    the loss at every position."""
    tokens = batch * seq
    return (6.0 * (product_weights(cfg) + cfg.d_model * cfg.vocab) * tokens
            + 14.0 * cfg.head_dim_ * attention_pairs(cfg, batch, seq))


def _attention_layers(cfg):
    """(window, how many layers) of each window the model's layers use."""
    out = {}
    for k in layer_kinds(cfg):
        w = layer_window(cfg, k)
        out[w] = out.get(w, 0) + 1
    return out


def attention_fwd_bound_s(cfg, batch: int, seq: int,
                          elem_bytes: int = 2) -> float:
    """The least time the card could take for every layer's attention
    forward: the larger of its operations over the bf16 peak and its
    bytes (q, k, v read, o written) over HBM's rate, a layer at a time."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    total = 0.0
    for w, n in _attention_layers(cfg).items():
        ops = 4.0 * dh * visible_pairs(seq, w) * hq * batch
        nbytes = elem_bytes * batch * seq * dh * (2 * hq + 2 * hkv)
        total += n * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return total


def attention_bwd_bound_s(cfg, batch: int, seq: int,
                          elem_bytes: int = 2) -> float:
    """The same for the backward: 10·D a visible pair; q, k, v, o, dO and
    each row's f32 log-sum-exp read, dq, dk and dv written."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    total = 0.0
    for w, n in _attention_layers(cfg).items():
        ops = 10.0 * dh * visible_pairs(seq, w) * hq * batch
        nbytes = (elem_bytes * batch * seq * dh * (4 * hq + 4 * hkv)
                  + 4 * batch * hq * seq)
        total += n * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return total
