"""Collective-traffic accounting of a step, the counterpart of the JAX
package's ``repro/launch/hlo_analysis.py``.

PyTorch has no partitioned HLO to read.  The collectives are counted
instead while the step runs (for real, or under FakeTensorMode over a
``"fake"`` process group: ``launch/dryrun.py``), by a dispatch mode that
sits below DTensor's dispatch (``CollectiveBytes``): a DTensor op returns
``NotImplemented`` there, desugars into the local ops and the collectives
of its redistributions, and each collective reaches the mode with its
local (per-rank) tensors.  So the totals are per-rank bytes, as the JAX
package's are per chip.

Wire-byte conventions (the JAX package's, on the local tensors):
    all-reduce        2 × result      (reduce-scatter + all-gather phases)
    all-gather        1 × result      (result is the gathered local tensor)
    reduce-scatter    1 × operand     (operand is the pre-scatter tensor)
    all-to-all        1 × result

There is no ``while`` loop to multiply out: the port's loops (the layer
groups, the loss chunks, xlstm's sLSTM steps, the mLSTM chunks) are
Python loops, and the counter sees every iteration's collectives.
``while_trip_counts`` is kept for the record's keys and is always empty.
"""
from __future__ import annotations

import traceback
from typing import Callable, Dict, List, Tuple


class CollectiveBytes:
    """A dispatch mode that counts the collectives DTensor issues while
    entered (the functional ``_c10d_functional`` ops and the native
    ``c10d`` ones, as CommDebugMode counts both), by kind, with their bytes
    by this module's conventions: an all-reduce 2 x its result, an
    all-gather 1 x its result, a reduce-scatter 1 x its operand, an
    all-to-all 1 x its result.  ``ops`` counts each op by name.  With
    ``sites=True`` each collective is also filed under the innermost frame
    of the port that issued it (``rows``, for
    ``hlo_flops.collective_breakdown``)."""

    #: op name -> (kind, multiple, the argument or result measured): "out"
    #: the functional op's result, an int that argument (a tensor or a
    #: list of them)
    KINDS = {"all_reduce": ("all-reduce", 2, "out"),
             "all_gather_into_tensor": ("all-gather", 1, "out"),
             "reduce_scatter_tensor": ("reduce-scatter", 1, 0),
             "all_to_all_single": ("all-to-all", 1, "out"),
             "allreduce_": ("all-reduce", 2, 0),
             "_allgather_base_": ("all-gather", 1, 0),
             "allgather_": ("all-gather", 1, 0),
             "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
             "_reduce_scatter_base_": ("reduce-scatter", 1, 1),
             "reduce_scatter_": ("reduce-scatter", 1, 1),
             "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 1),
             "alltoall_base_": ("all-to-all", 1, 0),
             "alltoall_": ("all-to-all", 1, 0)}

    def __init__(self, sites: bool = False):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                # a DTensor op first desugars (with this mode on) into the
                # local ops and the collectives of its redistributions
                if any(t is DTensor for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                outer.record(func, args, out)
                return out
        self.mode = Mode()
        self.counts, self.bytes, self.ops = {}, {}, {}
        self.sites = sites
        #: (kind, site, local shape) -> [count, bytes of one]
        self.rows: Dict[Tuple[str, str, tuple], List[int]] = {}

    def record(self, func, args, out) -> None:
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns == "_c10d_functional":
            name = name.rstrip("_")
        elif ns != "c10d":
            return
        if name not in self.KINDS:
            return
        kind, mult, which = self.KINDS[name]
        t = out if which == "out" else args[which]
        ts = t if isinstance(t, (list, tuple)) else [t]
        nbytes = sum(x.numel() * x.element_size() for x in ts
                     if hasattr(x, "numel"))
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + mult * nbytes
        key = f"{ns}.{name}"
        self.ops[key] = self.ops.get(key, 0) + 1
        if self.sites:
            shape = tuple(tuple(x.shape) for x in ts if hasattr(x, "shape"))
            row = self.rows.setdefault((kind, port_site(), shape),
                                       [0, mult * nbytes])
            row[0] += 1

    def totals(self) -> Dict[str, float]:
        """{kind: bytes, "total": their sum}: ``collective_bytes``'s
        record."""
        out = {k: float(v) for k, v in self.bytes.items()}
        out["total"] = float(sum(self.bytes.values()))
        return out

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def port_site() -> str:
    """``file:line function`` of the innermost frame of the port's models,
    train or optim code on the stack (the op's call site), else of the
    innermost port frame."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and "/launch/hlo_" not in f.filename]
    if not frames:
        return "?"
    model = [f for f in frames if any(
        f"/{p}/" in f.filename for p in ("models", "train", "optim"))]
    f = (model or frames)[-1]
    return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"


def collective_bytes(fn: Callable[[], object]) -> Dict[str, float]:
    """Per-rank wire bytes of the collectives ``fn()`` issues, by kind
    ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"), plus
    "total"."""
    with CollectiveBytes() as cb:
        fn()
    return cb.totals()


def while_trip_counts(fn: Callable[[], object] = None
                      ) -> List[Tuple[str, int]]:
    """The JAX package's (body, trip count) of each ``while`` op: always
    empty here, since every loop of the port is a Python loop whose
    iterations the counters see one by one (``fn`` is not run)."""
    return []


__all__ = ["CollectiveBytes", "collective_bytes", "port_site",
           "while_trip_counts"]
