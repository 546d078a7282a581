"""Logical partitioning axes for params / caches / batches (t5x-style), the
JAX package's ``repro/models/partitioning.py``.

Every leaf is identified by its innermost dict key (names are unique
across block kinds by construction) and mapped to a tuple of *logical*
axis names for its trailing dims; leading stacked-group dims get the
"layers" axis.  ``launch/sharding.py`` turns logical axes into mesh
placements with divisibility-aware fallback.

The trees are the port's nested dicts of tensors; tensors on the ``meta``
device serve as shape stand-ins (the JAX package's ``ShapeDtypeStruct``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

LogicalAxes = Tuple[Optional[str], ...]

PARAM_AXES: Dict[str, LogicalAxes] = {
    "embedding": ("vocab", "embed"),
    "out_proj": ("embed", "vocab"),
    "final_norm": ("embed",),
    "attn_norm": ("embed",),
    "mlp_norm": ("embed",),
    "x_norm": ("embed",),
    "norm": ("embed",),
    # attention
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "gate": (),
    # mlp
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    # moe
    "router": ("embed", "expert"),
    "we_gate": ("expert", "embed", "mlp"),
    "we_up": ("expert", "embed", "mlp"),
    "we_down": ("expert", "mlp", "embed"),
    # rg-lru
    "w_x": ("embed", "rnn"),
    "w_y": ("embed", "rnn"),
    "conv": (None, "rnn"),
    "w_a": ("rnn", "rnn2"),
    "w_i": ("rnn", "rnn2"),
    "lam": ("rnn",),
    "w_out": ("rnn", "embed"),
    # xlstm
    "wi": ("embed", "heads"),
    "wf": ("embed", "heads"),
    "wx": ("embed", None, "heads", "head_dim"),
    "r": ("heads", "head_dim", None, "head_dim2"),
}

CACHE_AXES: Dict[str, LogicalAxes] = {
    "k": ("batch", "kv_heads", "cache_seq", "head_dim"),
    "v": ("batch", "kv_heads", "cache_seq", "head_dim"),
    "slot_pos": ("cache_seq",),
    "mC": ("batch", "heads", "head_dim", "head_dim2"),
    "mn": ("batch", "heads", "head_dim"),
    "mm": ("batch", "heads"),
    "sc": ("batch", "heads", "head_dim"),
    "sn": ("batch", "heads", "head_dim"),
    "sh": ("batch", "heads", "head_dim"),
    "sm": ("batch", "heads", "head_dim"),
    "lru": ("batch", "rnn"),
    "conv_state": ("batch", None, "rnn"),
    "enc_out": ("batch", "aux_seq", "embed"),
}

BATCH_AXES: Dict[str, LogicalAxes] = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "aux": ("batch", "aux_seq", "embed"),
    "token": ("batch", "seq"),
    "pos": (),
}


def _keystr(path) -> str:
    """The path as ``jax.tree_util.keystr`` prints dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def logical_axes(tree: Any, table: Dict[str, LogicalAxes]) -> Any:
    """Map a nested dict of tensors (or ``meta`` stand-ins) to logical-axis
    tuples, padding leading stacked-group dims with "layers"."""

    def one(path, leaf):
        if not path:
            raise KeyError(f"no dict key in path {tuple(path)}")
        name = str(path[-1])
        if name not in table:
            raise KeyError(f"no logical axes registered for leaf {name!r} "
                           f"at {_keystr(path)}")
        axes = table[name]
        extra = len(leaf.shape) - len(axes)
        assert extra >= 0, (name, tuple(leaf.shape), axes)
        return ("layers",) * extra + tuple(axes)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return one(path, node)

    return walk(tree, ())


def param_axes(params: Any) -> Any:
    return logical_axes(params, PARAM_AXES)


def cache_axes(cache: Any) -> Any:
    return logical_axes(cache, CACHE_AXES)


def batch_axes(batch: Any) -> Any:
    return logical_axes(batch, BATCH_AXES)


__all__ = ["BATCH_AXES", "CACHE_AXES", "PARAM_AXES", "LogicalAxes",
           "batch_axes", "cache_axes", "logical_axes", "param_axes"]
