"""adamw_ms.train: ``adamw_update``'s device time a step, between CUDA
events, in the traced steps."""


def read(rec):
    ms = rec.get("adamw_ms")
    return sum(ms) / len(ms) if ms else None
