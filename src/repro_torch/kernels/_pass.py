"""Launch geometry and argument checks shared by the fused kernels' wrappers.

The column ranges of a pass (``pass_geometry``) are a function of the
shapes alone, never of the card: the moments' fixed accumulation order
depends on them, and with them repeated runs and the dedicated-versus-group
runs are bitwise equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

#: CTAs a pass aims for: 8 per SM of a 132-SM H100.  A constant, so the
#: ranges (and with them the moments' summation order) never follow the
#: card a run lands on.
TARGET_CTAS = 1056
#: Longest column range in RNG tiles (bounds the CTA's shared key table).
MAX_TILES_PER_CTA = 1024
#: Rows of W per CTA (kMaxRows in csrc/moments_tile.cuh).
MAX_ROWS = 8
#: Shared memory a CTA may use on Hopper, in bytes.
SMEM_BYTES = 232448
#: f32 slots of one row's key chunk in the slot kernels (kernel 6, the
#: grouped moments of csrc/fused_grouped.cu, and kernel 8,
#: csrc/fused_kmeans.cu; csrc/slot_tile.cuh): a chunk takes as many keys
#: as fit, and each further chunk hashes its weights again.
SLOT_FLOATS = 96
#: CTAs an SM the slot kernels' rows aim for: rows are added while the
#: CTA's shared memory leaves room for this many.  Three measured best
#: against two and four in both kernels (probe_slots.py, PERF.md §6).
SLOT_CTAS = 3
#: Shared memory of an H100 SM, of which each CTA reserves 1 KB more.
SM_SMEM_BYTES = 233472
#: Threads a CTA of the fused kernels (kThreads in csrc/moments_tile.cuh).
THREADS = 256


def pass_geometry(Bp: int, np_: int, bn: int) -> Tuple[int, int]:
    """(tiles_per_cta, ranges) of a pass over a (Bp, np_) implicit W cut
    into RNG tiles bn columns wide."""
    nt = np_ // bn
    rowblocks = -(-Bp // MAX_ROWS)
    ranges = min(nt, max(-(-TARGET_CTAS // rowblocks),
                         -(-nt // MAX_TILES_PER_CTA)))
    tpc = -(-nt // ranges)
    return tpc, -(-nt // tpc)


def explicit_geometry(R: int, n: int, rows: int) -> Tuple[int, int]:
    """(cols, ranges) of a pass over an explicit (R, n) weight matrix,
    ``rows`` rows of it a CTA: about TARGET_CTAS CTAs, each over a range
    of ``cols`` columns, a whole number of warps wide."""
    rowblocks = -(-R // rows)
    ranges = max(1, min(-(-n // 256), -(-TARGET_CTAS // rowblocks)))
    cols = -(-n // ranges)
    cols += (-cols) % 32
    return cols, -(-n // cols)


#: Shared memory a pass kernel keeps beside its dynamic part (the static
#: block-sum scratch of csrc/fused_pass.cu, with room to spare), in bytes.
STATIC_SMEM = 64


def _align16(v: int) -> int:
    return v + (-v) % 16


def hist_rows(row_bins: int, fixed_bytes: int) -> int:
    """Rows of W a CTA takes (up to MAX_ROWS) whose ``row_bins`` 4-byte
    bins a row fit in shared memory beside ``fixed_bytes`` of its other
    shared memory; raises, naming block_bins, when not one row fits."""
    free = SMEM_BYTES - STATIC_SMEM - fixed_bytes
    rows = min(MAX_ROWS, free // (4 * row_bins))
    if rows < 1:
        raise NotImplementedError(
            f"a histogram pass needs {row_bins} bins (d·nbins, summed over "
            "the slots; one key's when keyed) of shared memory per row of "
            "W, more than a Hopper SM holds; pass block_bins= (a "
            "Quantile's or fused_poisson_hist's) to run the output-tiled "
            "kernel")
    return int(rows)


def pass_meta_bytes(tiles_per_cta: int, n_hist: int, d: int) -> int:
    """Shared bytes of a fused pass before its bins (pass_meta_end in
    csrc/fused_pass.cu): two tile keys an n-tile, the histogram slots'
    (nbins, offset) pairs and their lo and hi, to a 16-byte boundary."""
    return _align16(16 * tiles_per_cta + 8 * n_hist + 8 * n_hist * d)


def pass_smem_bytes(tiles_per_cta: int, n_hist: int, d: int, rows: int,
                    hist_total: int) -> int:
    """Dynamic shared memory of a fused pass (pass_smem_bytes in
    csrc/fused_pass.cu): the tile keys alone without histograms, else
    the slots' table and ``rows`` rows of ``hist_total`` u32 bins too."""
    if n_hist == 0:
        return 16 * tiles_per_cta
    return (pass_meta_bytes(tiles_per_cta, n_hist, d)
            + 4 * rows * hist_total)


def pass_hist_rows(tiles_per_cta: int, n_hist: int, d: int,
                   hist_total: int) -> int:
    """Rows of W a CTA of a fused pass with histograms (kernels 3 and 4)
    takes: as many as the bins fit beside its keys and slot table."""
    return hist_rows(hist_total, pass_meta_bytes(tiles_per_cta, n_hist, d))


#: Largest key chunk of the keyed histogram (kMaxKeyChunk in
#: csrc/fused_grouped.cu: an index entry holds the key within its chunk
#: in 11 bits).
KEYED_MAX_KG = 2048
#: Bins a keyed histogram CTA aims to keep, in bytes: a key chunk grows to
#: fill them, which leaves room for three CTAs an SM.
KEYED_BIN_BYTES = 65536


class KeyedHist(NamedTuple):
    """Launch geometry of the keyed histogram (csrc/fused_grouped.cu).
    First keyed_index_kernel, one CTA a range, sorts each range's columns
    by key chunk into an index; then grouped_hist_kernel: grid x =
    ``ranges`` column ranges of ``tiles_per_cta`` RNG n-tiles
    (pass_geometry's) times ``chunks`` key chunks of ``kg`` keys, the
    chunk fastest; y = blocks of ``rows`` rows of W.  A CTA keeps its
    rows' bins of its chunk's keys, and draws the weights of the columns
    whose key its chunk holds, once."""
    rows: int
    kg: int
    chunks: int
    tiles_per_cta: int
    ranges: int

    def keys_of(self, chunk: int, G: int) -> range:
        return range(chunk * self.kg, min((chunk + 1) * self.kg, G))

    def smem_bytes(self, d: int, nbins: int) -> int:
        """Two tile keys an n-tile, then the bins."""
        return 16 * self.tiles_per_cta + 4 * self.rows * self.kg * d * nbins

    def index_ints(self, np_: int) -> int:
        """The index pass's scratch: an entry a column, the end of each
        (range, chunk) segment and a mask flag a range."""
        return np_ + self.ranges * self.chunks + self.ranges


def keyed_hist_geometry(Bp: int, np_: int, bn: int, G: int, d: int,
                        nbins: int) -> KeyedHist:
    """Geometry of a keyed histogram pass over a (Bp, np_) implicit W cut
    into RNG tiles bn columns wide, G keys and d·nbins bins a key.

    The ranges are pass_geometry's.  Rows are as many (up to MAX_ROWS) as
    one key's bins a row fit beside the tile keys, so the pass raises and
    names block_bins only once d·nbins alone is past an SM (about 57,800
    bins), whatever G.  A chunk then takes as many keys as fit in
    KEYED_BIN_BYTES (at least one), evened out over the chunks."""
    tpc, ranges = pass_geometry(Bp, np_, bn)
    row = d * nbins
    rows = hist_rows(row, 16 * tpc)
    kg = max(1, min(G, KEYED_MAX_KG, KEYED_BIN_BYTES // (4 * rows * row)))
    chunks = -(-G // kg)
    return KeyedHist(rows, -(-G // chunks), chunks, tpc, ranges)


#: Rows of W a kernel 7 CTA keeps (kCacheRows in csrc/fused_binblocked.cu):
#: a 4-column group of them is one 16-byte word of its weight cache.
BINBLOCKED_ROWS = 4
#: Largest thread block cluster of kernel 7: an H100 keeps 66 clusters of
#: 2 CTAs (one an SM) resident, but only 30 of 4.
MAX_CLUSTER = 2
#: CTAs kernel 7 aims for: one an SM of a 132-SM H100, as its weight cache
#: fills an SM's shared memory at the streamed Quantile's shape.
BINBLOCKED_CTAS = 132
#: Static shared memory of a kernel 7 CTA (its cluster's mask flag, as
#: ptxas reports it), beside the dynamic part ``BinBlocked.smem_bytes``.
BINBLOCKED_STATIC_SMEM = 16


class BinBlocked(NamedTuple):
    """Launch geometry of kernel 7 (csrc/fused_binblocked.cu).

    Grid: x = ranges · cluster CTAs (a cluster of ``cluster`` CTAs for
    each column range), y = blocks of ``rows`` rows of W.  CTA ``rank`` of
    the cluster of range ``i`` draws the weights of its rows on RNG
    n-tiles ``tiles(i, rank, nt)`` once, into its shared weight cache;
    after a cluster barrier it walks windows ``windows_of(rank)`` over the
    cluster's columns, reading its peer's cache through distributed
    shared memory."""
    width: int           # bins a window
    rows: int            # rows of W a CTA
    tiles_per_cta: int   # RNG n-tiles whose weights a CTA caches
    cluster: int         # CTAs a cluster
    ranges: int          # column ranges, one cluster each
    windows: int         # windows a row

    def tiles(self, i: int, rank: int, nt: int) -> Tuple[int, int]:
        t0 = min((i * self.cluster + rank) * self.tiles_per_cta, nt)
        return t0, min(t0 + self.tiles_per_cta, nt)

    def windows_of(self, rank: int) -> range:
        return range(rank, self.windows, self.cluster)

    def smem_bytes(self, bn: int) -> int:
        """Bins, then the weight cache (a 16-byte word of 4 rows for every
        4 columns), then two tile keys an n-tile."""
        return (_align16(4 * self.rows * self.width)
                + 16 * -(-self.tiles_per_cta * bn // 4)
                + 16 * self.tiles_per_cta)


def binblocked_geometry(Bp: int, np_: int, bn: int, total: int,
                        block_bins: int) -> BinBlocked:
    """Geometry of an output-tiled histogram pass (kernel 7) over ``total``
    bins a row, for a (Bp, np_) implicit W cut into RNG tiles bn columns
    wide.

    A window is ``block_bins`` bins wide, cut to the row and to what fits
    beside one n-tile's cache; a CTA keeps up to BINBLOCKED_ROWS rows of
    it.  Each weight is drawn once, by the one CTA whose cache holds its
    column; the cache limits the columns a cluster covers, so the ranges
    are the fewest the largest cluster allows, and the cluster the
    smallest that reaches them.  Only a grid below one CTA an SM takes
    more ranges.  Every range adds one flush of the row's bins into the
    output."""
    nt = np_ // bn
    tile = 16 + 16 * -(-bn // 4)
    free = SMEM_BYTES - BINBLOCKED_STATIC_SMEM
    room = free - 16 - tile
    width = max(1, min(int(block_bins), total, room // 4))
    rows = min(BINBLOCKED_ROWS, room // (4 * width))
    tpc_max = (free - _align16(4 * rows * width)) // tile
    windows = -(-total // width)
    sizes = [c for c in range(1, MAX_CLUSTER + 1)
             if c == 1 or c <= min(windows, nt)]
    fewest = -(-nt // (sizes[-1] * tpc_max))
    cluster = next(c for c in sizes if -(-nt // (c * tpc_max)) == fewest)
    rowblocks = -(-Bp // rows)
    ranges = max(fewest, min(nt // cluster,
                             BINBLOCKED_CTAS // (rowblocks * cluster)))
    tpc = -(-nt // (ranges * cluster))
    return BinBlocked(width, rows, tpc, cluster,
                      -(-nt // (cluster * tpc)), windows)


def dim_chunk(d: int) -> int:
    """Columns of x a CTA of a moments or slot kernel sums (dim_chunk in
    csrc/moments_tile.cuh): 1, 2 or 4."""
    return 1 if d <= 1 else 2 if d <= 2 else 4


class SlotPass(NamedTuple):
    """Launch geometry of a slot kernel (kernel 6 or 8).  Grid: x = blocks
    of ``rows`` rows of W, y = ``ranges`` column ranges of
    ``tiles_per_cta`` RNG n-tiles (pass_geometry's), z = ``chunks`` =
    ``key_chunks`` chunks of ``kc`` keys (clusters, for kernel 8) times
    chunks of ``dc`` columns of x.  A thread keeps ``rows`` rows of
    ``row_slots`` f32 slots in shared memory: ``per_key`` for each key of
    its chunk, and ``per_row`` of the row's own (kernel 8's inertia).  A
    CTA hashes the weights of the columns whose key its chunk holds, so a
    weight is drawn once per column chunk."""
    rows: int
    dc: int
    kc: int
    key_chunks: int
    chunks: int
    tiles_per_cta: int
    ranges: int
    per_key: int
    per_row: int

    @property
    def row_slots(self) -> int:
        return self.kc * self.per_key + self.per_row

    def keys_of(self, chunk: int, keys: int) -> range:
        """The keys of key chunk ``chunk`` (of ``keys`` keys)."""
        return range(chunk * self.kc, min((chunk + 1) * self.kc, keys))

    def smem_bytes(self) -> int:
        """Two tile keys an n-tile, then the slots."""
        return 16 * self.tiles_per_cta + 4 * THREADS * self.rows * \
            self.row_slots


def slot_geometry(Bp: int, np_: int, bn: int, keys: int, d: int,
                  per_key: int, per_row: int = 0) -> SlotPass:
    """Geometry of a slot pass over a (Bp, np_) implicit W cut into RNG
    tiles bn columns wide, ``keys`` keys of ``per_key`` slots each (a
    function of the column chunk ``dc``) and ``per_row`` slots of a row's
    own.

    A chunk takes as many keys as a row's SLOT_FLOATS hold (evened out
    over the chunks), then as many rows as leave room for SLOT_CTAS CTAs
    an SM (at least one), a power of two up to MAX_ROWS.  Rows and chunks
    change no sum: the ranges are pass_geometry's, and each thread folds
    its columns in order."""
    dc = dim_chunk(d)
    tpc, ranges = pass_geometry(Bp, np_, bn)
    kc = max(1, min(keys, (SLOT_FLOATS - per_row) // per_key))
    key_chunks = -(-keys // kc)
    kc = -(-keys // key_chunks)
    row = kc * per_key + per_row
    room = SM_SMEM_BYTES // SLOT_CTAS - 1024 - 16 * tpc
    rows = max(1, min(MAX_ROWS, room // (4 * THREADS * row)))
    rows = 1 << (rows.bit_length() - 1)
    geo = SlotPass(rows, dc, kc, key_chunks, key_chunks * -(-d // dc), tpc,
                   ranges, per_key, per_row)
    if geo.smem_bytes() > SMEM_BYTES - STATIC_SMEM:
        raise NotImplementedError(
            f"a slot pass needs {geo.smem_bytes()} bytes of shared memory, "
            "more than a Hopper SM holds")
    return geo


def grouped_geometry(Bp: int, np_: int, bn: int, G: int,
                     d: int) -> SlotPass:
    """Kernel 6: a key's slots are w, and s1 and s2 of DC columns."""
    dc = dim_chunk(d)
    return slot_geometry(Bp, np_, bn, G, d, 2 * dc + 1)


def kmeans_geometry(Bp: int, np_: int, bn: int, k: int,
                    d: int) -> SlotPass:
    """Kernel 8: a cluster's slots are the sums of DC columns and the
    count; a row's own, its inertia."""
    dc = dim_chunk(d)
    return slot_geometry(Bp, np_, bn, k, d, dc + 1, 1)


#: Kernel 12's backward on the tensor cores (bf16 up to head dim
#: BWD_TC_MAX_D; csrc/flash_attention_bwd.cu, kTcMaxD): keys (the dK/dV
#: pass) or query rows (the dQ pass) a CTA owns, two warpgroups of
#: BWD_TC_WG (kTcBlock); the lse₂/Δ scratch gives each query head Sq
#: rounded up to BWD_TC_BLOCK rows (padded_rows).
BWD_TC_MAX_D = 128
BWD_TC_BLOCK = 128
BWD_TC_WG = 64


class AttentionBwdWalk(NamedTuple):
    """The tile walks of kernel 12's backward on the tensor cores, for one
    (batch, KV head): ``dkdv`` lists (key block, query head of the group,
    first row of a BQ-row query tile, (masked, masked) of the two
    warpgroups) in each CTA's order, the key blocks in grid order;
    ``dq`` lists (query block, first key of a BN-key tile, (masked,
    masked)), the last query blocks first.  A tile a warpgroup does not
    mask is one whose every pair with a row before Sq is visible; rows
    past Sq get P = 0 from the scratch's lse₂ = +inf.  ``rows``: Sq_pad."""
    bq: int
    bn: int
    rows: int
    dkdv: tuple
    dq: tuple


def attention_bwd_tiles(d: int) -> Tuple[int, int]:
    """(BQ, BN): the dK/dV pass's query tile and the dQ pass's key tile at
    head dim d (launch_tc's choice)."""
    return (128, 64) if d <= 64 else (64, 64)


def attention_bwd_geometry(hq: int, hkv: int, sq: int, skv: int, d: int,
                           causal: bool, window, kv_offset: int
                           ) -> AttentionBwdWalk:
    """Mirror of attention_bwd_dkdv_tc's and attention_bwd_dq_tc's walks
    (window None or 0: none), the same integer arithmetic."""
    bq, bn = attention_bwd_tiles(d)
    blk, wgr = BWD_TC_BLOCK, BWD_TC_WG
    w = window or 0
    g_size = hq // hkv
    dkdv = []
    for kb in range(-(-skv // blk)):
        k0 = kb * blk
        key_last = min(k0 + blk, skv) - 1
        r_beg = max(0, k0 - kv_offset) if causal else 0
        r_end = min(sq, key_last + w - kv_offset) if w > 0 else sq
        t_first = r_beg // bq
        n_t = -(-r_end // bq) - t_first if r_end > r_beg else 0
        for j in range(g_size * n_t):
            row0 = (t_first + j % n_t) * bq
            masked = tuple(
                not (wk0 + wgr <= skv
                     and (not causal or wk0 + wgr - 1 <= row0 + kv_offset)
                     and (w <= 0 or wk0 > row0 + bq - 1 + kv_offset - w))
                for wk0 in (k0, k0 + wgr))
            dkdv.append((kb, j // n_t, row0, masked))
    dq = []
    nqb = -(-sq // blk)
    for qb in range(nqb - 1, -1, -1):
        q0 = qb * blk
        last = min(q0 + blk, sq) - 1 + kv_offset
        k_end = min(skv, last + 1) if causal else skv
        k_beg = max(0, q0 + kv_offset - w + 1) if w > 0 else 0
        t_first = k_beg // bn
        n_tiles = -(-k_end // bn) - t_first if k_end > k_beg else 0
        for j in range(n_tiles):
            t0 = (t_first + j) * bn
            masked = tuple(
                not (t0 + bn <= skv
                     and (not causal or t0 + bn - 1 <= first)
                     and (w <= 0 or t0 > first + wgr - 1 - w))
                for first in (q0 + kv_offset, q0 + wgr + kv_offset))
            dq.append((qb, t0, masked))
    return AttentionBwdWalk(bq, bn, nqb * blk, tuple(dkdv), tuple(dq))


def check_cuda_f32(name: str, t: torch.Tensor) -> None:
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
