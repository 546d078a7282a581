"""Inputs the cross-attending models need in the port's CPU tests: gates
set to non-zero values, and seeded stub aux embeddings.

A freshly initialised cross-attention gate is zero (the JAX package's
law), so the layer adds tanh(0)·y = 0 and a wrong cross-attention would
pass every logit check.  ``with_gates`` draws each gate of a numpy params
tree from uniform [0.5, 1.0) before the tree is carried into either
package, and ``assert_gates_set`` fails on a tree whose gates are absent
or zero.  ``aux_for`` makes the stub frontend embeddings, seeded normal
(B, Ta, d_model) as tests/test_models.py makes them.
"""
import numpy as np


def with_gates(tree, seed=0):
    """The numpy params ``tree`` with every cross-attention gate drawn from
    uniform [0.5, 1.0) (numpy, ``seed``), in its own shape and dtype."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if not isinstance(t, dict):
            return t
        return {k: (rng.uniform(0.5, 1.0, np.shape(v)).astype(v.dtype)
                    if k == "gate" else walk(v)) for k, v in t.items()}
    return walk(tree)


def gate_values(tree) -> list:
    """Every gate of a params tree (numpy or torch), flattened."""
    out = []

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "gate":
                out.extend(np.asarray(v, np.float32).reshape(-1).tolist())
    walk(tree)
    return out


def assert_gates_set(tree) -> None:
    """Fails on a tree whose cross-attention would add nothing: no gates,
    or a gate at zero."""
    gates = gate_values(tree)
    assert gates and all(g != 0.0 for g in gates), gates


def aux_len(cfg) -> int:
    return cfg.vision_tokens or cfg.enc_seq


def aux_for(cfg, b, seed=7):
    """Seeded normal (b, Ta, d_model) f32 stub embeddings, or None for a
    config that reads none."""
    if not aux_len(cfg):
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, aux_len(cfg), cfg.d_model)).astype(np.float32)
