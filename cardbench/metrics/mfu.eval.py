"""mfu.eval: the model forwards' operations (``flops.forward_ops`` of one
document a forward) over the untraced window's time, as a share of the
card's bf16 peak."""
from cardbench import flops


def read(rec):
    if not rec.get("forwards"):
        return None
    seq = rec["tokens_per_forward"]
    ops = sum(rec["forwards"]) * flops.forward_ops(rec["cfg"], 1, seq, seq)
    return 100.0 * ops / rec["window_s"] / flops.PEAK_BF16_FLOPS
