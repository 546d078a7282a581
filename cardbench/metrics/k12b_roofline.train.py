"""k12b_roofline.train: kernel 12's backward against its bound: the
least time the card could take for the traced steps' attention backward
(``flops.attention_bwd_bound_s``) over the device time of the
``attention_bwd_*`` kernels in the trace."""
from cardbench import flops, harness


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("traced_steps"):
        return None
    spent = harness.kernel_seconds(tr["kernel_s"], r"attention_bwd")
    if spent <= 0:
        return None
    bound = rec["traced_steps"] * flops.attention_bwd_bound_s(
        rec["cfg"], rec["batch"], rec["seq"])
    return 100.0 * bound / spent
