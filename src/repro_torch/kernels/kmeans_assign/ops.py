"""One weighted Lloyd pass, and the matrix-free bootstrap over k-means.

``kmeans_assign`` gives (sums (k, d), counts (k,), inertia ()) of one
weighted Lloyd assignment pass; ``fused_poisson_kmeans`` gives B of them
under the shared implicit Poisson(1) weights, whose (B, n) matrix is never
built.  Neither builds an (n, k) distance or one-hot matrix.  A CUDA tensor
launches the hand-written kernel (csrc/kmeans_assign.cu, replacing the TPU
kernel repro/kernels/kmeans_assign/kernel.py: kmeans_assign_kernel;
csrc/fused_kmeans.cu, replacing fused_poisson_kmeans_kernel) or raises; a
CPU tensor runs the plain version, the JAX package's scan lowering tile by
tile.  With ``group_ids`` (GROUP BY) ``fused_poisson_kmeans`` gives one
state per key: on the card one fused_kmeans.cu launch per key under
valid · (key == g), which is the reference's contract for slot g and pays
the hash G times; on the CPU the grouped scan, which assigns each tile once.

d² is computed elementwise in a fixed order, with no matrix product:
xx = Σ_q x_q·x_q, cc = Σ_q c_q·c_q and xc = Σ_q x_q·c_q in ascending q,
each product and each sum an f32 operation of its own, then
max((xx − 2·xc) + cc, 0).  The kernels do the same with __fmul_rn and
__fadd_rn, so d², and with it each point's cluster (ties to the lowest
index, as ``argmin``), is bitwise the same in kernel and plain version, and
counts (sums of whole weights, summed exactly) are bitwise too.  Sums and
inertia agree to f32 rounding: each tile's contraction is f32 and the
running sums across tiles are float64, rounded once, as the moments' are.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (SMEM_BYTES, STATIC_SMEM, TARGET_CTAS,
                                       SlotPass, check_cuda_f32,
                                       kmeans_geometry, stream_ptr)
from repro_torch.kernels.poisson_counts.ref import weight_tile_blocks
from repro_torch.kernels.weighted_stats.ops import (Prepared, _pad_to,
                                                    chunk_scan, fold_tiles,
                                                    key_masks, mask_ptr,
                                                    prepare)

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: Columns each thread of the kmeans_assign kernel's shared-slot layout
#: folds, at the least, before the CTA count reaches TARGET_CTAS.
COLS_PER_THREAD = 8
#: The kmeans_assign kernel's register layout (csrc/kmeans_assign.cu,
#: assign_regs): d up to REG_MAX_DIM and k up to REG_CLUSTERS, 256 threads,
#: each loading 4 points at once (QUAD; a CTA's range is a multiple of 4
#: points) and folding REG_POINTS at the least before the CTAs reach
#: REG_CTAS, two an SM of an H100: the last CTA then sums few partials.
REG_MAX_DIM, REG_CLUSTERS, REG_THREADS, QUAD = 4, 8, 256, 4
REG_POINTS, REG_CTAS = 12, 2 * 132
#: Column assignments in all (columns times the CTAs a column) up to which
#: the fused kernel's bootstrap CTAs assign their own columns, saving the
#: assignment pass's launch (csrc/fused_kmeans.cu; measured in PERF.md §6).
ASSIGN_IN_PLACE = 1 << 18


def assign_tile(x: torch.Tensor, cent: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(one-hot (bn, k) f32, min-d² (bn,)) of x (bn, d) against cent (k, d):
    the JAX package's ``_assign_tile`` with d² in the fixed order above."""
    xx = x[:, 0] * x[:, 0]
    cc = cent[:, 0] * cent[:, 0]
    xc = x[:, :1] * cent[None, :, 0]
    for q in range(1, x.shape[1]):
        xx = xx + x[:, q] * x[:, q]
        cc = cc + cent[:, q] * cent[:, q]
        xc = xc + x[:, q:q + 1] * cent[None, :, q]
    d2 = torch.clamp_min((xx[:, None] - 2.0 * xc) + cc[None, :], 0.0)
    min_d2, a = d2.min(dim=1)
    assign = torch.nn.functional.one_hot(a, cent.shape[0]).to(torch.float32)
    return assign, min_d2


def tile_operands(x: torch.Tensor, cent: torch.Tensor) -> Triple:
    """What a tile's contraction needs from x (bn, d) and the centroids:
    the cluster-masked copies of x (bn, k·d), the one-hot (bn, k) and
    min-d² (bn,)."""
    assign, min_d2 = assign_tile(x, cent)
    bn, d = x.shape
    y = (assign[:, :, None] * x[:, None, :]).reshape(bn, cent.shape[0] * d)
    return y, assign, min_d2


def contract_tile(w: torch.Tensor, ops: Triple, d: int) -> Triple:
    """One tile's f32 (sums (B, k, d), counts (B, k), inertia (B,)) under
    a (B, bn) weight tile, the cluster-masked moments as one
    (B, bn) @ (bn, k·d) product."""
    y, assign, min_d2 = ops
    return ((w @ y).reshape(w.shape[0], assign.shape[1], d), w @ assign,
            w @ min_d2)


def contract_chunk(w: torch.Tensor, ops: Triple, d: int, bn: int
                   ) -> Triple:
    """``contract_tile`` for each tile of a (B, T·bn) chunk of weight
    tiles, stacked: (sums (T, B, k, d), counts (T, B, k), inertia
    (T, B))."""
    tiles = [contract_tile(w[:, c], tuple(o[c] for o in ops), d)
             for c in (slice(t * bn, (t + 1) * bn)
                       for t in range(w.shape[1] // bn))]
    return tuple(torch.stack(p) for p in zip(*tiles))


def assign_plain(x: torch.Tensor, w: torch.Tensor, cent: torch.Tensor
                 ) -> Triple:
    """Plain version of one weighted Lloyd pass over x (n, d), w (n,): the
    JAX package's ``_assign_scan`` over n-tiles of the shared clamp."""
    n, d = x.shape
    bn = weight_tile_blocks(8, n)[1]
    xp, wp = _pad_to(x, bn, 0), _pad_to(w, bn, 0)
    k = cent.shape[0]
    f64 = dict(dtype=torch.float64, device=x.device)
    sums, counts = torch.zeros(k, d, **f64), torch.zeros(k, **f64)
    inertia = torch.zeros((), **f64)
    for t0 in range(0, xp.shape[0], bn):
        xt, wt = xp[t0:t0 + bn], wp[t0:t0 + bn]
        assign, min_d2 = assign_tile(xt, cent)
        sums = sums + assign.T @ (xt * wt[:, None])
        counts = counts + assign.T @ wt
        inertia = inertia + (wt * min_d2).sum()
    return sums.float(), counts.float(), inertia.float()


def fused_kmeans_plain(pr: Prepared, seed: int, cent: torch.Tensor
                       ) -> Triple:
    """Plain version of the bootstrap over k-means: (sums (Bp, k, d),
    counts (Bp, k), inertia (Bp,)), each tile's ``contract_tile`` folded in
    float64 in tile order, a chunk of tiles at a time (``chunk_scan``)."""
    k = cent.shape[0]
    f64 = dict(dtype=torch.float64, device=pr.device)
    acc = [torch.zeros(pr.Bp, k, pr.d, **f64), torch.zeros(pr.Bp, k, **f64),
           torch.zeros(pr.Bp, **f64)]

    def consume(w, x):
        parts = contract_chunk(w, tile_operands(x, cent), pr.d, pr.bn)
        for i, t in enumerate(parts):
            acc[i] = fold_tiles(acc[i], t)

    chunk_scan(pr, seed, consume)
    return tuple(a.float() for a in acc)


def grouped_kmeans_plain(pr: Prepared, seed: int, cent: torch.Tensor
                         ) -> Triple:
    """Plain keyed version, the JAX package's ``_grouped_fused_kmeans_scan``:
    (sums (Bp, G, k, d), counts (Bp, G, k), inertia (Bp, G)).  Each tile is
    assigned once; slot g contracts w · (key == g) as
    ``fused_kmeans_plain`` contracts its masked weights, bitwise."""
    k = cent.shape[0]
    f64 = dict(dtype=torch.float64, device=pr.device)
    acc = [torch.zeros(pr.Bp, pr.G, k, pr.d, **f64),
           torch.zeros(pr.Bp, pr.G, k, **f64),
           torch.zeros(pr.Bp, pr.G, **f64)]

    def consume(w, x, keys):
        ops = tile_operands(x, cent)
        for g, m in enumerate(key_masks(pr, keys)):
            parts = contract_chunk(w * m[None, :], ops, pr.d, pr.bn)
            for i, t in enumerate(parts):
                acc[i][:, g] = fold_tiles(acc[i][:, g], t)

    chunk_scan(pr, seed, consume)
    return tuple(a.float() for a in acc)


def split_entries(out: torch.Tensor, k: int, d: int) -> Triple:
    """(..., k·(d+1)+1) kernel output -> (sums (..., k, d), counts (..., k),
    inertia (...)): the sums of cluster j's dims, then the counts, then
    the inertia."""
    kd = k * d
    return (out[..., :kd].reshape(*out.shape[:-1], k, d),
            out[..., kd:kd + k], out[..., kd + k])


@functools.lru_cache(maxsize=256)
def assign_geometry(n: int, k: int, d: int) -> Tuple[int, int, int]:
    """(threads, columns per CTA, ranges) of a kmeans_assign pass, a
    function of the shapes alone (the sums' order depends on it).  Up to
    d = REG_MAX_DIM and k = REG_CLUSTERS the accumulators are registers:
    256 threads, ranges of a multiple of QUAD columns, at most REG_CTAS
    of them.  Past that a thread
    keeps its k·(d+1)+1 accumulators and d notes in shared memory, so a
    wide (k, d) takes fewer threads a CTA."""
    if d <= REG_MAX_DIM and k <= REG_CLUSTERS:
        threads, per = REG_THREADS, REG_THREADS * REG_POINTS
        ranges = max(1, min(REG_CTAS, -(-n // per)))
        cols = max(QUAD, -(-n // ranges))
        cols += (-cols) % QUAD
        return threads, cols, max(1, -(-n // cols))
    entries = k * (d + 1) + 1
    for threads in (256, 128, 64, 32):
        if 4 * ((entries + d) * threads + k * d + k) <= SMEM_BYTES:
            break
    else:
        raise NotImplementedError(
            f"kmeans_assign keeps k·(d+1)+1 = {entries} accumulators a "
            "thread in shared memory, more than a Hopper SM holds for 32 "
            "threads")
    ranges = max(1, min(TARGET_CTAS, -(-n // (threads * COLS_PER_THREAD))))
    cols = max(1, -(-n // ranges))
    return threads, cols, max(1, -(-n // cols))


#: (device index, stream) -> (ticket, partials): the kmeans_assign
#: kernel's scratch, kept across calls.  The ticket is one u32 that the
#: kernel's last CTA resets to 0; the partials grow to the largest
#: ranges · entries seen.  Launches on one stream run in order, so they
#: share them.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def assign_scratch(device: torch.device, stream: int, size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (ticket, partials of at least ``size`` floats) of a stream."""
    key = (device.index, stream)
    got = _SCRATCH.get(key)
    if got is None or got[1].numel() < size:
        ticket = (torch.zeros(1, dtype=torch.int32, device=device)
                  if got is None else got[0])
        got = (ticket, torch.empty(size, dtype=torch.float32,
                                   device=device))
        _SCRATCH[key] = got
    return got


def assign_cuda(x: torch.Tensor, w, cent: torch.Tensor) -> Triple:
    """One kmeans_assign launch; ``w`` None is unit weights (the kernel
    reads no weights)."""
    check_cuda_f32("values", x)
    if w is not None:
        check_cuda_f32("weights", w)
    check_cuda_f32("centroids", cent)
    n, d = x.shape
    k = cent.shape[0]
    threads, cols, ranges = assign_geometry(n, k, d)
    entries = k * (d + 1) + 1
    stream = stream_ptr(x.device)
    ticket, part = assign_scratch(x.device, stream, ranges * entries)
    out = torch.empty(entries, dtype=torch.float32, device=x.device)
    kmeans_assign.launches += 1
    _build.launch("kmeans_assign", n, d, k, x.data_ptr(),
                  None if w is None else w.data_ptr(), cent.data_ptr(), cols,
                  ranges, threads, part.data_ptr(), ticket.data_ptr(),
                  out.data_ptr(), stream)
    return split_entries(out, k, d)


def assign_in_place(geo: SlotPass, Bp: int, np_: int, k: int,
                    d: int) -> bool:
    """Whether the bootstrap CTAs of a fused k-means call assign their
    columns themselves instead of reading the assignment pass's scratch:
    when they would assign at most ASSIGN_IN_PLACE columns in all, which
    costs less than one more launch, and the centroids fit beside the
    slots."""
    ctas_a_column = -(-Bp // geo.rows) * geo.chunks
    return (ctas_a_column * np_ <= ASSIGN_IN_PLACE
            and geo.smem_bytes() + 4 * k * (d + 1)
            <= SMEM_BYTES - STATIC_SMEM)


def kmeans_cuda(pr: Prepared, seed: int, cent: torch.Tensor) -> Triple:
    """The fused kernel over a prepared call: Bp-row states on the card.
    Its assignment pass writes each column's cluster and min-d² to an
    8-byte-a-column scratch (or, ``assign_in_place``, the bootstrap CTAs
    assign their own columns); the bootstrap pass runs at
    ``kmeans_geometry``'s rows, cluster chunk and column chunk."""
    check_cuda_f32("values", pr.xp)
    check_cuda_f32("centroids", cent)
    k = cent.shape[0]
    if 4 * k * (pr.d + 1) > SMEM_BYTES:
        raise NotImplementedError(
            f"{k} centroids of dimension {pr.d} and their norms do not fit "
            "in shared memory")
    geo = kmeans_geometry(pr.Bp, pr.np_, pr.bn, k, pr.d)
    asg = None
    if not assign_in_place(geo, pr.Bp, pr.np_, k, pr.d):
        asg = torch.empty(pr.np_, 2, dtype=torch.int32, device=pr.device)
    part = torch.empty(pr.Bp, geo.ranges, k * (pr.d + 1) + geo.key_chunks,
                       dtype=torch.float32, device=pr.device)
    out = torch.empty(pr.Bp, k * (pr.d + 1) + 1, dtype=torch.float32,
                      device=pr.device)
    fused_poisson_kmeans.launches += 1
    _build.launch("fused_kmeans", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, k, pr.xp.data_ptr(), mask_ptr(pr),
                  cent.data_ptr(), geo.rows, geo.dc, geo.kc,
                  geo.tiles_per_cta, geo.ranges,
                  None if asg is None else asg.data_ptr(),
                  part.data_ptr(), out.data_ptr(), stream_ptr(pr.device))
    return split_entries(out, k, pr.d)


def grouped_kmeans_cuda(pr: Prepared, seed: int, cent: torch.Tensor
                        ) -> Triple:
    """One fused k-means launch per key under valid · (key == g): slot g
    is that launch, bitwise.  (Bp, G, ...) states on the card."""
    outs = []
    for g in range(pr.G):
        keyed = copy.copy(pr)
        keyed.mp = (pr.gp == g).to(torch.float32)
        keyed.mp[pr.n:] = 0.0
        if pr.mp is not None:
            keyed.mp = keyed.mp * pr.mp
        outs.append(kmeans_cuda(keyed, seed, cent))
    return tuple(torch.stack(slots, dim=1) for slots in zip(*outs))


def centroids_on(centroids, device: torch.device, d: int) -> torch.Tensor:
    """(k, d) f32 centroids, contiguous, on ``device``."""
    cent = torch.as_tensor(centroids).to(device=device, dtype=torch.float32)
    if cent.ndim != 2 or cent.shape[0] < 1 or cent.shape[1] != d:
        raise ValueError(f"centroids must be (k, {d}) for {d}-dimensional "
                         f"values, got {tuple(cent.shape)}")
    return cent.contiguous()


def kmeans_assign(values: torch.Tensor, weights, centroids) -> Triple:
    """values (n, d) or (n,) × centroids (k, d) [× weights (n,)] ->
    (sums (k, d), counts (k,), inertia ()); the centroids move to the
    values' device."""
    x = values if values.ndim == 2 else values.reshape(values.shape[0], -1)
    x = x.to(torch.float32).contiguous()
    w = None if weights is None else torch.as_tensor(weights).to(
        device=x.device, dtype=torch.float32).contiguous()
    if w is not None and w.shape != (x.shape[0],):
        raise ValueError(f"weights must be ({x.shape[0]},), got "
                         f"{tuple(w.shape)}")
    cent = centroids_on(centroids, x.device, x.shape[1])
    if x.device.type == "cuda":
        return assign_cuda(x, w, cent)
    if w is None:
        w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return assign_plain(x, w, cent)


kmeans_assign.launches = 0


def fused_poisson_kmeans(seed: int, values: torch.Tensor, centroids, B: int,
                         n_valid=None, valid_mask=None, group_ids=None,
                         num_groups=None) -> Triple:
    """values (n, d) or (n,) × centroids (k, d) -> (sums (B, k, d),
    counts (B, k), inertia (B,)) under the implicit Poisson(1) weights of
    every fused path (``implicit_weights(seed, B, n)``).  ``n_valid`` and
    ``valid_mask`` zero weight columns as in ``fused_poisson_moments``;
    ``group_ids`` gives (B, G, k, d), (B, G, k), (B, G), slot g bitwise
    the call under ``valid_mask = valid · (group_ids == g)``."""
    pr = prepare(values, B, n_valid, valid_mask, group_ids, num_groups)
    cent = centroids_on(centroids, pr.device, pr.d)
    if pr.device.type == "cuda":
        run = grouped_kmeans_cuda if pr.gp is not None else kmeans_cuda
    else:
        run = grouped_kmeans_plain if pr.gp is not None \
            else fused_kmeans_plain
    return tuple(t[:pr.B] for t in run(pr, seed, cent))


fused_poisson_kmeans.launches = 0
