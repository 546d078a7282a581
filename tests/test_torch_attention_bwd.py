"""Kernel 12's backward on the tensor cores (bf16 up to head dim 256,
csrc/flash_attention_bwd.cu), what of it the CPU can hold.

The tile walks: ``_pass.attention_bwd_geometry`` mirrors the dK/dV pass
(a CTA a block of keys, 128 up to head dim 128 and 64 past it, walking
each query head of the group over the BQ-row query tiles its keys can
see; its two warpgroups split the keys up to head dim 128 and a tile's
query rows past it) and the dQ pass (a CTA a 128-row query block over
the BN-key tiles its rows can see, BN = 64).  At
tests/test_torch_cuda.py's FA_BWD_CASES, chip_smoke.py's BWD_CASES (the
models' train-mode geometries, granite-3-2b's step among them) and
hypothesis-drawn geometries: each pass covers every visible (key, row)
pair exactly once, a tile it skips holds no visible pair, a tile a
warpgroup does not mask holds only visible pairs (rows past Sq aside:
their lse₂ is +inf in the padded scratch), and every tile lies inside
the scratch's rows.

The tolerance: the route rounds P and dS to bf16 (RNE) before the three
products that take them, so the card's checks add 2^-8·Σ|terms| to the
CUDA-core route's.  Up to head dim 128 the rounded values are wgmma's
register fragments; past it they go through shared memory as bf16 (the
dK/dV pass's Pᵀ and dSᵀ tiles), the same single RNE rounding of each
value.  A dense copy of the plain backward that rounds the same way lies
within that of the unrounded copy, of ``flash_attention_backward_plain``
and of ``jax.vjp`` through the JAX package's blockwise path (plus
1e-5·Σ|terms| for f32 summation order) at five small geometries, two of
them at head dims 168 and 256.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_attention import ops as jfa
from repro_torch.kernels._pass import (BWD_TC_BLOCK, attention_bwd_geometry,
                                       attention_bwd_tiles)
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import attention_mask
from test_torch_train import bwd_bounds

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _case_lists():
    """FA_BWD_CASES and chip_smoke.py's BWD_CASES as (shape, kwargs)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from test_torch_cuda import FA_BWD_CASES
    return list(FA_BWD_CASES) + [(s, kw) for _, s, kw in chip_smoke.BWD_CASES]


def _visible(sq, skv, causal, window, kv_offset):
    """(skv, sq) bool: key c visible to query row r."""
    c = np.arange(skv)[:, None]
    pos = np.arange(sq)[None, :] + kv_offset
    vis = np.ones((skv, sq), dtype=bool)
    if causal:
        vis &= c <= pos
    if window:
        vis &= c > pos - window
    return vis


def _check_walk(shape, causal=True, window=None, kv_offset=0):
    _, hq, hkv, sq, skv, d = shape
    walk = attention_bwd_geometry(hq, hkv, sq, skv, d, causal, window,
                                  kv_offset)
    vis = _visible(sq, skv, causal, window, kv_offset)
    blk, wg, bq, bn = BWD_TC_BLOCK, 64, walk.bq, walk.bn
    kbk = walk.keys
    assert (bq, bn, kbk) == attention_bwd_tiles(d)
    assert walk.rows % blk == 0 and sq <= walk.rows < sq + blk

    # dK/dV: each head of the group walks the same tiles, key blocks in
    # grid order (the first first)
    g_size = hq // hkv
    by_head = [[(kb, r) for kb, g, r, _ in walk.dkdv if g == h]
               for h in range(g_size)]
    assert all(t == by_head[0] for t in by_head)
    assert [kb for kb, _ in by_head[0]] == sorted(kb for kb, _ in by_head[0])
    assert len(set(by_head[0])) == len(by_head[0])
    count = np.zeros((skv, sq), dtype=np.int32)
    for kb, r0 in by_head[0]:
        assert r0 % bq == 0 and r0 + bq <= walk.rows
        count[kb * kbk:(kb + 1) * kbk, r0:r0 + bq] += 1
    assert (count[vis] == 1).all()
    for kb in range(-(-skv // kbk)):
        for r0 in range(0, sq, bq):
            if (kb, r0) not in by_head[0]:
                assert not vis[kb * kbk:(kb + 1) * kbk, r0:r0 + bq].any()
    for kb, _, r0, masked in walk.dkdv:
        parts = walk.dkdv_parts(kb, r0)
        # the two warpgroups' shares tile the CTA's keys by the tile's rows
        share = np.zeros((kbk, bq), dtype=np.int32)
        for k0, nk, p0, nr in parts:
            share[k0 - kb * kbk:k0 - kb * kbk + nk, p0 - r0:p0 - r0 + nr] += 1
        assert (share == 1).all()
        for (k0, nk, p0, nr), m in zip(parts, masked):
            if not m:
                assert k0 + nk <= skv
                assert vis[k0:k0 + nk, p0:min(p0 + nr, sq)].all()

    # dQ: query blocks from the last, each over its key tiles in order
    qbs = [qb for qb, _, _ in walk.dq]
    assert qbs == sorted(qbs, reverse=True)
    assert len(set((qb, t) for qb, t, _ in walk.dq)) == len(walk.dq)
    count = np.zeros((sq, skv), dtype=np.int32)
    for qb, t0, masked in walk.dq:
        assert t0 % bn == 0 and (qb + 1) * blk <= walk.rows
        count[qb * blk:(qb + 1) * blk, t0:t0 + bn] += 1
        for w, m in enumerate(masked):
            q0 = qb * blk + w * wg
            if not m and q0 < sq:
                assert t0 + bn <= skv
                assert vis[t0:t0 + bn, q0:min(q0 + wg, sq)].all()
    assert (count[vis.T] == 1).all()
    tiles = set((qb, t) for qb, t, _ in walk.dq)
    for qb in range(-(-sq // blk)):
        for t0 in range(0, skv, bn):
            if (qb, t0) not in tiles:
                assert not vis[t0:t0 + bn, qb * blk:(qb + 1) * blk].any()


@pytest.mark.parametrize("shape,kw", _case_lists(),
                         ids=[str(s) for s, _ in _case_lists()])
def test_attention_bwd_walks_cover_the_visible_pairs(shape, kw):
    _check_walk(shape, **kw)


@settings(max_examples=60, deadline=None)
@given(hkv=st.integers(1, 2), g=st.integers(1, 3),
       sq=st.integers(1, 700), skv=st.integers(1, 700),
       causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 800)),
       kv_offset=st.integers(-300, 300),
       d=st.sampled_from([16, 64, 120, 128]))
def test_attention_bwd_walks_on_drawn_geometries(hkv, g, sq, skv, causal,
                                                  window, kv_offset, d):
    _check_walk((1, g * hkv, hkv, sq, skv, d), causal=causal, window=window,
                kv_offset=kv_offset)


@settings(max_examples=60, deadline=None)
@given(hkv=st.integers(1, 2), g=st.integers(1, 3),
       sq=st.integers(1, 700), skv=st.integers(1, 700),
       causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 800)),
       kv_offset=st.integers(-300, 300),
       d=st.integers(17, 32).map(lambda x: 8 * x))
def test_attention_bwd_wide_walks_on_drawn_geometries(hkv, g, sq, skv, causal,
                                                       window, kv_offset, d):
    """The route past head dim 128 (d 136 .. 256, the wrapper's multiples
    of 8): 64 keys a CTA split by query rows."""
    _check_walk((1, g * hkv, hkv, sq, skv, d), causal=causal, window=window,
                kv_offset=kv_offset)


def _dense_backward(q, k, v, o, lse, do, causal, window, kv_offset, scale,
                    rounded):
    """dq, dk, dv (f32) of kernel 12 by dense products, P and dS rounded
    to bf16 (RNE) before dV = Pᵀ·dO, dK = scale·dSᵀ·Q and dQ = scale·dS·K
    when ``rounded``, as the tensor-core route does."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kf) * scale
    mask = attention_mask(sq, skv, causal, window, kv_offset)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hq, sq, 1)), 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta)
    if rounded:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return (dq, dk.reshape(b, hkv, g, skv, d).sum(2),
            dv.reshape(b, hkv, g, skv, d).sum(2))


#: five small geometries: causal GQA 4:1, a window with Sq = Skv = 67,
#: not causal with Sq != Skv and a kv_offset, and the wide route's head
#: dims: gemma3-27b's 168 (GQA 2:1, a window) and recurrentgemma-2b's 256
#: (one KV head, a window, a kv_offset)
TOL_CASES = [
    ((1, 4, 1, 37, 37, 16), dict(causal=True)),
    ((2, 4, 2, 67, 67, 64), dict(causal=True, window=13)),
    ((1, 8, 2, 37, 67, 64), dict(causal=False, kv_offset=5)),
    ((1, 4, 2, 45, 45, 168), dict(causal=True, window=17)),
    ((1, 2, 1, 29, 41, 256), dict(causal=True, window=20, kv_offset=12)),
]


@pytest.mark.parametrize("shape,kw", TOL_CASES,
                         ids=[str(s) for s, _ in TOL_CASES])
def test_bf16_rounding_of_p_and_ds_stays_within_its_term(shape, kw):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq * skv + d)
    # bf16 values, as the kernel reads them, carried in f32
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).float()
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]
    q, k, v, do = arrs
    kw = dict(kw, window=kw.get("window"), kv_offset=kw.get("kv_offset", 0),
              scale=d ** -0.5)
    blocks = dict(block_q=16, block_k=16)
    o, lse = tfa.flash_attention_plain_lse(q, k, v, **blocks, **kw)
    args = (q, k, v, o, lse, do, kw["causal"], kw["window"],
            kw["kv_offset"], kw["scale"])
    got = _dense_backward(*args, rounded=True)
    unrounded = _dense_backward(*args, rounded=False)
    plain = tfa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                               **blocks, **kw)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in arrs)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, backend="blockwise", **blocks, **kw), jq, jk, jv)
    jgrads = [torch.from_numpy(np.array(t)) for t in vjp(jdo)]
    bounds = bwd_bounds(q, k, v, o, do, lse, kw["causal"], kw["window"],
                        kw["kv_offset"], kw["scale"])
    term = 2.0 ** -8
    for name, g_, u, pl, jx, bd in zip(("dq", "dk", "dv"), got, unrounded,
                                       plain, jgrads, bounds):
        assert float(bd.max()) > 0, name
        # the rounding alone: within the term (one rounded factor a term,
        # each within 2^-8 of itself; the two copies sum in one order)
        assert bool(((g_ - u).abs() <= term * bd).all()), name
        for want in (pl, jx):
            assert bool(((g_ - want).abs() <= (term + 1e-5) * bd).all()), \
                name


def _causal_window_pairs(s, w):
    """The hand count of a head's visible pairs under a causal window of
    w over s tokens (w >= s: causal alone): the first w rows see 1 .. w
    keys, every later row w."""
    w = min(w, s)
    return w * (w + 1) // 2 + (s - w) * w


def test_visible_pairs_counts_chip_smokes_causal_windows():
    """``ops.visible_pairs``, the one count of visible pairs that
    chip_smoke.py's bounds and the FLOP formulas use, equals the hand count
    at every causal geometry chip_smoke.py bounds: the serving prefill's
    window, the wide heads' local and global layers, the MoE prefills and
    the training step."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    geos = [(cs.FA_S, w) for w in (cs.FA_W, cs.GEMMA_W, cs.RG_W, None)]
    geos += [(cs.SERVE_PROMPT, w) for *_, w in cs.MOE_FA_TIMED]
    geos += [(cs.TRAIN_S, None)]
    geos += [(s, w) for _, (_, _, _, s, _, _), kw in cs.BWD_CASES
             if kw["causal"] and not kw.get("kv_offset")
             for w in (kw.get("window"),)]
    for s, w in geos:
        assert tfa.visible_pairs(s, s, True, w, 0) == \
            _causal_window_pairs(s, w or s), (s, w)
