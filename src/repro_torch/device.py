"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names the CPU: ``None``
means ``"cuda"``, and asking for CUDA on a machine without a card raises
instead of carrying on on the CPU.  ``"meta"`` builds shape stand-ins
(``configs.input_specs``, the partitioning axes of a full config) and
allocates nothing.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu' "
                         f"('meta' for shape stand-ins)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a float32 tensor on ``device``."""
    t = torch.as_tensor(x)
    if not t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device=device, dtype=torch.float32)


def check_ieee_matmul(t: torch.Tensor) -> None:
    """Raise unless f32 matrix products on ``t``'s device run in IEEE f32:
    on the card, TF32 would keep about three decimal digits of a weighted
    moment (the package turns it off at import; a caller may turn it on)."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "f32 matmuls are set to TF32 (torch.backends.cuda.matmul."
            "allow_tf32 / set_float32_matmul_precision); the weighted "
            "moments need IEEE f32: set allow_tf32 = False and precision "
            "'highest'")
