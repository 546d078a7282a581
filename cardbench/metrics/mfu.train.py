"""mfu.train: the training steps' operations (``flops.train_ops``) over
the untraced window's time to the end of its last step, as a share of the
card's bf16 peak."""
from cardbench import flops


def read(rec):
    ends = rec.get("step_ends")
    if not ends:
        return None
    ops = len(ends) * flops.train_ops(rec["cfg"], rec["batch"], rec["seq"])
    return 100.0 * ops / ends[-1] / flops.PEAK_BF16_FLOPS
