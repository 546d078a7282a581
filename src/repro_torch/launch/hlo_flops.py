"""Dot FLOP/byte accounting of a step, the counterpart of the JAX package's
``repro/launch/hlo_flops.py``.

The JAX package parses every ``dot`` of the partitioned HLO and multiplies
``while`` bodies by their trip counts.  Here a dispatch mode (``DotFlops``)
counts the products while the step runs, for real or under FakeTensorMode
(``launch/dryrun.py``).  It returns ``NotImplemented`` on DTensor types, so
a DTensor op reaches it as the local ops of one rank: the counts are
per-rank, as the JAX package's are per chip.  The formulas are
``torch.utils.flop_counter``'s registry: ``mm``, ``addmm``, ``bmm`` and
``baddbmm`` (2·m·n·k), their ``out_dtype`` overloads (the card's bf16
products with an f32 output), and kernels 12 and 12b
(``repro_torch::flash_attention``, ``_lse`` and ``_backward``: 4·D a
visible pair forward, 10·D backward; ``kernels/flash_attention/ops.py``).
An op the registry does not know is no dot.  ``dot_bytes`` is each dot's
operands and result once (for the attention operators, their inputs and
outputs once); ``bytes_accessed`` the same over every ``aten`` op but
views and allocations (the counterpart of XLA's cost analysis' bytes
accessed; metadata queries and collectives are not accesses).
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List

import torch

from repro_torch.launch.hlo_analysis import CollectiveBytes

#: the attention operators (kernels 12 and 12b), counted apart as well
ATTENTION_OPS = ("flash_attention", "flash_attention_lse",
                 "flash_attention_backward")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def in_shape_propagation() -> bool:
    """Whether the op being dispatched is one of DTensor's own shape
    computations: its sharding propagator runs an op on fake tensors of
    the global shapes (under the active FakeTensorMode, so below these
    modes) to learn its output's metadata.  No rank runs those ops; the
    counters skip them."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class DotFlops:
    """A dispatch mode that counts, while entered, each product's FLOPs
    (``flop_counter``'s registry) and bytes: ``flops``, ``dot_bytes``,
    ``num_dots``, ``by_op`` (op -> [count, flops]) and
    ``attention_flops`` (kernels 12 and 12b alone); ``bytes_accessed``
    every ``aten`` op's tensor inputs and outputs but views' and
    allocations'."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        import repro_torch.kernels.flash_attention.ops  # noqa: F401 (formulas)
        outer = self
        self.registry = flop_registry

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                outer.record(func, args, kwargs, out)
                return out
        self.mode = Mode()
        self.flops = 0
        self.dot_bytes = 0
        self.num_dots = 0
        self.attention_flops = 0
        self.bytes_accessed = 0
        self.by_op: Dict[str, List[int]] = {}

    def record(self, func, args, kwargs, out) -> None:
        if in_shape_propagation():
            return
        packet = func._overloadpacket
        if func.namespace == "aten" and not func.is_view and not \
                packet.__name__.startswith(("empty", "new_empty")):
            self.bytes_accessed += _nbytes(list(args)) + _nbytes(out)
        formula = self.registry.get(packet)
        if formula is None:
            return
        if func._overloadname == "dtype":    # (a, b, out_dtype): the product
            args = args[:2]
        flops = int(formula(*args, **kwargs, out_val=out))
        name = f"{func.namespace}.{packet.__name__}"
        self.flops += flops
        self.num_dots += 1
        self.dot_bytes += _nbytes(list(args)) + _nbytes(out)
        if func.namespace == "repro_torch" and \
                packet.__name__ in ATTENTION_OPS:
            self.attention_flops += flops
        row = self.by_op.setdefault(name, [0, 0])
        row[0] += 1
        row[1] += flops

    def record_dict(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "dot_bytes": float(self.dot_bytes),
                "num_dots": self.num_dots}

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def dot_flops(fn: Callable[[], object]) -> Dict[str, float]:
    """Per-rank dot FLOPs and dot operand/result bytes of ``fn()``:
    {"flops", "dot_bytes", "num_dots"}."""
    with DotFlops() as df:
        fn()
    return df.record_dict()


def collective_breakdown(fn: Callable[[], object]) -> List[dict]:
    """Top collective contributors of ``fn()``, largest first: each
    (kind, the port's call site, local shapes) with its bytes once, its
    count (``mult``; the JAX package's trip multiplier) and bytes in all;
    ``op_name`` is the site (the JAX package's HLO ``op_name``)."""
    with CollectiveBytes(sites=True) as cb:
        fn()
    rows = [dict(computation=site.split(" ")[0], kind=kind,
                 bytes_once=float(once), mult=float(n),
                 bytes_total=float(once * n), op_name=site, shape=str(shape))
            for (kind, site, shape), (n, once) in cb.rows.items()]
    rows.sort(key=lambda r: -r["bytes_total"])
    return rows


__all__ = ["ATTENTION_OPS", "DotFlops", "collective_breakdown", "dot_flops"]
