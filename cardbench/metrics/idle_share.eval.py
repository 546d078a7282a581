"""The device's idle share of the traced window: 1 - busy_s / window_s,
from torch.profiler's trace."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
