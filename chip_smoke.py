#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; it imports nothing of JAX or
of the JAX package.  Phases, each of which raises (exit code 1) on
failure:

1. build the thirteen CUDA kernels from kernels/csrc (poisson_counts.cu,
   fused_pass.cu, which holds the three fused ones, kmeans_assign.cu,
   fused_kmeans.cu, fused_grouped.cu, which holds the two GROUP BY ones,
   weighted_moments.cu, weighted_hist.cu, fused_stream.cu,
   fused_binblocked.cu and flash_attention.cu; one nvcc per source, all at
   once) and print the build seconds and ptxas's registers and spills;
   kernel 12's tensor-core instances and kernels 7 and 10 must spill 0
   bytes;
2. print the card's name and power limit (nvidia-smi);
3. hold every kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at B=256, n=2^20+37, with and without a
   validity mask, and on the binning's edge values: weights, w_tot and
   histogram and k-means counts bitwise; s1 and k-means sums within
   1e-5·Σw|x|, s2 within 1e-5·Σw·x² and k-means inertia within
   1e-5·Σw·min-d² per entry; the k-means kernels also at k=16, d=8 (past
   the fused kernel's register chunk) and on exact ties; group members
   bitwise equal to the dedicated kernels, a KMeansStep member included;
   the GROUP BY kernels at G=8, d in {1, 4}, with a key that has no rows
   and at G·(2d+1) > 128, and every keyed slot (moments, histogram,
   k-means) bitwise equal to the dedicated kernel masked to its key; the
   explicit-weight kernels (weighted_moments at B in {1, 7, 256}, n in
   {1, 1000, 2^20+37}, d in {1, 3, 8}; weighted_histogram at R in
   {1, 256}, d in {1, 4}, nbins in {256, 2048}, with NaN, +-inf, values
   past the edges and zero weights) under whole-number and fractional
   weights, R = 256 rows bitwise 256 one-row launches, every value in one
   bin (R in {1, 256}, and unit weights), n = 1, 2, 3 (mod 4) with W a
   row slice 0, 4 or 12 bytes off a 16-byte boundary, and repeat launches
   of whole-number weights bitwise; the output-tiled histogram (kernel
   7, block_bins in {128, 512, 2048}, d in {1, 4, 64} at nbins = 2048,
   ragged n, NaN, +-inf and values past the edges, with and without a
   mask) bitwise equal to the plain version and to the one-window kernel
   where that fits, keyed at G = 8, d = 4 (65,536 bins a row, past the
   keyed histogram's limit), over several column ranges (n = 2^20+37, d
   = 64) and one, with n_valid, and at B = 100; the streamed
   moments (kernel 5, B in {8, 256}, n in {300, 65,536, 2^20+37}, d in
   {1, 3, 64}, aligned and misaligned x, with and without a mask) bitwise
   equal to kernel 2 and within 1e-5·Σw|x| of the plain version; flash
   attention (kernel 12: bf16 on the tensor cores, f32 on the CUDA
   cores) at tests/test_kernels.py's sweep, the unaligned Sq = 67 at
   head_dim 120 and GQA 4, a decode-offset case (kv_offset = 4096, window
   4096), head dims 20 and 128, Sq and Skv of 200 and 513, and a query
   block that sees no key (all zeros), each in f32 (atol 2e-5, rtol
   1e-4) and bf16 (one bf16 rounding, 1e-3 + 2^-7·|want|, plus the
   rounding of P to bf16 before P·V, 2^-8·(Σ p·|v|)/l from the plain
   version on |v|), and at the full-width prefill shape (4 x 32 query
   heads on 8 KV heads, 8192 tokens, head_dim 120, window 4096) in bf16,
   where two launches must give the same bits, and in f32;
4. the quickstart path, with every launch count set to 0 first and the
   geometry of every launch logged: the quickstart session
   (N = 2,000,000, StatisticGroup(Mean, Quantile(0.5), Std)), a Mean()
   and a Median() session, a bootstrap of a user statistic without a
   fused path (the materialized poisson_counts route), and the one-shot
   bootstrap of the group at B=256, n=2^24-1000, all matrix-free
   (backend="fused_rng"); the quickstart session is run again on the CPU
   and must agree;
5. the k-means path (examples/analytics_kmeans.py, paper §6.3), again
   from zeroed counts with its geometries logged: Lloyd over N = 400,000
   rows (k=5, d=2, 8 iterations) and over a 2% PreMapSampler sample, the
   bootstrap certificate over KMeansStep at B=24, and one bootstrap at
   B=256 over n=2^22 rows whose peak memory must stay below an (n, k)
   f32 tensor; the example is run again on the CPU and must agree;
6. the GROUP BY path (README "GROUP BY"), from zeroed counts with its
   geometries logged: keyed Mean and median sessions over a
   StratifiedSampler of N = 2,000,000 rows [value, key] (G = 8, key g
   with frequency ∝ 2^-g), each run again on the CPU, which must agree,
   and a keyed Mean bootstrap at B=256, n=2^24-1000 whose peak memory
   must stay below an (n, G) f32 tensor; the earlier kernels' launches
   on phases 4 to 6 must equal EARLIER_LAUNCHES (and kernel 10's, and
   those of kernels 5 and 7, EARLIER_LATER_LAUNCHES);
7. the materialized path (the JAX package's default backend=None), from
   zeroed counts with its geometries logged: the quickstart group's
   session with no backend, on the card and the CPU, which must agree;
   bootstraps at B=256, n=2^20 over a 1 GiB weight matrix (Mean with
   kernel 11 against the cuBLAS product, within 1e-5·Σw|x|/Σw; Median
   through kernel 10 at R=256) with the Knuth draw's own time and peak;
   fig10's delta extends (B=32, 1.6M rows) and its multinomial baseline
   (B=16, 30,000 + 30,000 rows; the same resamples and counts on the
   CPU); fig3's shared-base bootstrap (B=64, 4,000 rows); the chunked
   bootstrap with both backends at n=2^22;
10. (run after phase 7) the streaming path, from zeroed counts with its
   geometries logged: examples/fault_tolerance.py parts 1 to 3 on the card
   (100,000 x 4 rows, B = 64, chunk 8,192: a kill after checkpoint 6 and
   its resume, transient faults under a RetryPolicy, a split lost for good
   under FailurePolicy(on_exhausted="degrade"), each bitwise its oracle),
   the same walk's Mean and Count on the CPU (w_tot bitwise, Mean within
   1e-5·Σw|x|/Σw); then a host store of 2^22 x 64 f32 rows (1 GiB, B =
   256, chunk 65,536): a streamed Mean (kernel 2 each chunk) and
   Quantile(block_bins=2048) (kernel 7 each chunk), each bitwise
   bootstrap_chunked over store.read_all() on the card, a kill and resume
   of the Quantile at checkpoint_every=8, one more Quantile run under
   torch.profiler (kernel 7's summed card time beside the wall and the
   stage: which sets the pace), kernel 5's entry point over the
   same chunks (bitwise the streamed Mean's state), and both runs again
   at 2^20 rows: the peak device memory above the resident state must not
   grow with n;
11. (run after phase 10) the serving path, from zeroed counts with its
   geometries logged: h2o-danube-3-4b at full width (24 layers, d_model
   3840, 32/8 heads of 120, d_ff 10240, vocab 32000 padded to 32768,
   window 4096; 3.84e9 f32 parameters from a seeded generator) serves 4
   requests of 8192-token synthetic_tokens prompts: prefill with room for
   32 greedy decode steps (kernel 12 exactly 24 times a prefill, never in
   decode), the prefill wall and decode tokens/s, a peak below one layer's
   (4, 32, 8192, 8192) f32 score tensor above the params; a few more
   decode steps on the host's clock and one under torch.profiler (the
   card's busy time and the casts' share) and the weight casts a step
   makes timed alone; decode equals
   teacher forcing (one forward over the prompts and decoded tokens)
   within 2e-2 of the largest logit; the model cut to one layer on the
   card and the CPU (1 x 256 tokens, 8 steps) gives logits within that
   tolerance and the same greedy tokens; EarlEval over 20,000 documents
   of 513 tokens (eval_batch 32, sigma 0.01) certifies from under half
   of them, and again at sigma 1.5e-4, below the pilot's cv, where it must
   grow the sample past its pilot, still certify from under half, give
   the plain mean of the losses its forwards returned, and take the B,
   rows and iterations of an EarlSession on the CPU fed those losses;
   then the repaired routing: a group (Mean,
   GroupedStatistic(Mean, 8), a custom statistic) at B = 256, n = 2^20 is
   bitwise its members' dedicated runs (the custom member's tiled scan
   also against its CPU run), and a keyed custom statistic at B = 256,
   n = 2^24 - 1000 peaks below one (B, n) f32 matrix;
8. replay every distinct launch geometry that phases 4 to 7, 10 and 11
   logged on fresh data and hold it against the plain version as in
   phase 3;
9. time each kernel (CUDA events) beside its plain version, its bound
   and, for the explicit-weight kernels, one PyTorch call computing the
   same function; the sessions' wall times and the example's walls over a
   few warm runs, and the grouped moments kernel against G masked
   moments launches; kernel 5 beside kernel 2 and kernel 7 at the streamed
   Quantile's chunk shape, with kernel 7's cost terms (weights hashed and
   draws a weight, shared adds, bin_index evaluations, flush operations,
   bytes of x, of counts and of distributed shared memory); kernels 5, 7,
   10 and 11 also alone (launches back to back inside one wrapper call),
   and kernel 10 at the point estimate (R = 1, unit weights); kernel 12 at the serving prefill's shape
   beside its plain version, its bound (4·D operations a visible
   query-key pair at the bf16 tensor-core rate, or q, k, v and o once
   over the memory rate), scaled_dot_product_attention with the boolean
   causal-window mask and its own f32 route; then print the kernels line,
   then the contract's last line.

Every plain version that a kernel is held against or timed beside runs
under a check that it launches no kernel.

Exit code 2: no card, or no port beside this script.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM rates (NVIDIA data sheet, 700 W): HBM3 bytes/s, and
# 32-bit integer operations/s: the 67 TFLOP/s f32 rate counts an FMA as two
# operations on 128 lanes per SM; an SM has 64 INT32 lanes, so a quarter.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# 32-bit integer operations per implicit weight; the count and its
# breakdown are in src/repro_torch/kernels/csrc/poisson_tile.cuh.
OPS_PER_WEIGHT = 73
# Published H100 SXM f32 rate outside the tensor cores (an FMA is two).
F32_FLOPS_PER_S = 67e12

REPLACES = {
    "poisson_counts": "src/repro/kernels/poisson_counts/kernel.py:63",
    "fused_poisson_moments": "src/repro/kernels/weighted_stats/kernel.py:173",
    "fused_poisson_hist": "src/repro/kernels/weighted_hist/kernel.py:253",
    "fused_poisson_multi": "src/repro/kernels/fused_multi/kernel.py:107",
    "kmeans_assign": "src/repro/kernels/kmeans_assign/kernel.py:93",
    "fused_poisson_kmeans": "src/repro/kernels/kmeans_assign/kernel.py:170",
    "fused_poisson_moments_grouped":
        "src/repro/kernels/weighted_stats/kernel.py:275",
    # no TPU kernel: the reference's keyed sketch is its scan lowering
    "fused_poisson_hist_grouped": "src/repro/kernels/weighted_hist/ops.py:107",
    "weighted_moments": "src/repro/kernels/weighted_stats/kernel.py:67",
    "weighted_histogram": "src/repro/kernels/weighted_hist/kernel.py:73",
    "fused_poisson_moments_stream":
        "src/repro/kernels/weighted_stats/kernel.py:406",
    "fused_poisson_hist_binblocked":
        "src/repro/kernels/weighted_hist/kernel.py:195",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:81",
}
SOURCES = {
    "poisson_counts": "src/repro_torch/kernels/csrc/poisson_counts.cu",
    "fused_poisson_moments": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_hist": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_multi": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "kmeans_assign": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
    "fused_poisson_kmeans": "src/repro_torch/kernels/csrc/fused_kmeans.cu",
    "fused_poisson_moments_grouped":
        "src/repro_torch/kernels/csrc/fused_grouped.cu",
    "fused_poisson_hist_grouped":
        "src/repro_torch/kernels/csrc/fused_grouped.cu",
    "weighted_moments": "src/repro_torch/kernels/csrc/weighted_moments.cu",
    "weighted_histogram": "src/repro_torch/kernels/csrc/weighted_hist.cu",
    "fused_poisson_moments_stream":
        "src/repro_torch/kernels/csrc/fused_stream.cu",
    "fused_poisson_hist_binblocked":
        "src/repro_torch/kernels/csrc/fused_binblocked.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
#: the kernels each main path must launch
QUICKSTART_KERNELS = ("poisson_counts", "fused_poisson_moments",
                      "fused_poisson_hist", "fused_poisson_multi")
KMEANS_KERNELS = ("kmeans_assign", "fused_poisson_kmeans")
GROUPBY_KERNELS = ("fused_poisson_moments_grouped",
                   "fused_poisson_hist_grouped")
MATERIALIZED_KERNELS = ("weighted_moments", "weighted_histogram")
STREAM_KERNELS = ("fused_poisson_moments", "fused_poisson_hist_binblocked",
                  "fused_poisson_moments_stream", "weighted_histogram")
#: the serving path's kernel, and the repaired routing's (a group with a
#: keyed and a custom member; a keyed custom statistic's tiled scan)
SERVE_KERNELS = ("flash_attention",)
ROUTING_KERNELS = ("poisson_counts", "fused_poisson_multi",
                   "fused_poisson_moments_grouped")
#: launches of the earlier kernels on the quickstart, k-means and GROUP BY
#: paths together in the run that ported the GROUP BY slice: a call that
#: lost its explicit backend="fused_rng" would change them
EARLIER_LAUNCHES = {"poisson_counts": 1, "fused_poisson_moments": 7,
                    "fused_poisson_hist": 7, "fused_poisson_multi": 8,
                    "kmeans_assign": 18, "fused_poisson_kmeans": 2,
                    "fused_poisson_moments_grouped": 8,
                    "fused_poisson_hist_grouped": 7}
#: the other kernels' launches on those three paths, and the materialized
#: path's launches, in the run that ported the materialized engines
EARLIER_LATER_LAUNCHES = {"weighted_moments": 0, "weighted_histogram": 111,
                          "fused_poisson_moments_stream": 0,
                          "fused_poisson_hist_binblocked": 0}
MATERIALIZED_LAUNCHES = {"fused_poisson_multi": 64, "weighted_moments": 1,
                         "weighted_histogram": 295}
NBINS, LO, HI = 2048, 0.0, 25.0
QUICKSTART_N = 2_000_000
BIG_B, BIG_N = 256, (1 << 20) + 37
BOOT_N = (1 << 24) - 1000
SESSION_REPS = 5
# examples/analytics_kmeans.py: N rows of k 2-d blobs, ITERS Lloyd steps,
# a 2% sample and B resamples; the wide (k, d) takes the fused kernel past
# one register chunk (16 entries of k·(d+1)+1).
KM_N, KM_K, KM_ITERS, KM_B = 400_000, 5, 8, 24
KM_SAMPLE = KM_N // 50
KM_WIDE = (16, 8)
KM_BOOT_N = 1 << 22
# the GROUP BY path: N rows [value, key] over G keys; the grouped kernel
# against G masked launches at the reference benchmark's shape
GB_N, GB_G = 2_000_000, 8
GB_RATIO_SHAPE = dict(B=256, n=65_536, d=4)
# the materialized path: bootstraps over a (B, n) weight matrix of 1 GiB;
# fig10's delta extends (B = 32, 1.6M rows) and its multinomial baseline
# (B = 16, 30,000 + 30,000 rows); fig3's shared-base bootstrap (B = 64,
# 4,000 rows); the chunked bootstrap at n = 2^22
MAT_B, MAT_N = 256, 1 << 20
FIG10_B, FIG10_N = 32, 1_600_000
MDB_B, MDB_ROWS = 16, 30_000
SB_B, SB_N = 64, 4_000
CHUNK_B, CHUNK_N, CHUNK = 64, 1 << 22, 65_536
# the streaming path: examples/fault_tolerance.py's store (100,000 x 4
# rows, splits of 4,096, B = 64, chunks of 8,192), then the README's
# 64-column store at 2^22 rows (1 GiB of f32 on the host) and at 2^20, B =
# 256, chunks of 65,536, a median of each column over 2,048 bins in
# windows of 2,048 (kernel 7)
FT_N, FT_D, FT_SPLIT, FT_B, FT_CHUNK = 100_000, 4, 4096, 64, 8192
ST_NS, ST_D, ST_SPLIT, ST_B, ST_CHUNK = (1 << 22, 1 << 20), 64, 65_536, \
    256, 65_536
ST_LO, ST_HI, ST_CKPT_EVERY, ST_KILL_AFTER = -6.0, 6.0, 8, 3
# kernel 7's parity: n for d = 64 (the others run at BIG_N) and the keyed
# case's G, d (65,536 bins a row)
K7_WIDE_N, K7_G, K7_GD = (1 << 16) + 37, 8, 4
# the serving path (phase 11): h2o-danube-3-4b at full width, 4 requests
# of 8192-token prompts (two windows) and 32 greedy decode steps; card ==
# CPU on the model cut to one layer (1 x 256 tokens, 8 steps); EarlEval
# over 20,000 documents of 513 tokens in batches of 32 at sigma 0.01
SERVE_ARCH, SERVE_SEED = "h2o-danube-3-4b", 16
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 8192, 32
CPU_PROMPT, CPU_GEN = 256, 8
EVAL_DOCS, EVAL_DOC_LEN, EVAL_BATCH, EVAL_SIGMA, EVAL_TAU = \
    20_000, 513, 32, 0.01, 0.05
# a second EarlEval below the pilot's cv (about 4.7e-4 at these random
# weights), so the session grows the sample past its pilot
EVAL_SIGMA_GROW = 1.5e-4
# decode steps timed on the host's clock before the profiled one
PROFILE_STEPS = 4
# kernel 12's timing shape: the serving prefill's (B·Hq, S, D), Hkv, W
FA_B, FA_HQ, FA_HKV, FA_S, FA_D, FA_W = 4, 32, 8, 8192, 120, 4096
# dense bf16 tensor-core rate of the H100 SXM (NVIDIA data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12
# the repaired routing: a keyed custom statistic's tiled scan at the
# one-shot bootstrap's size, and a group with keyed and custom members
ROUTE_G, ROUTE_GROUP_N = 8, 1 << 20


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA
    events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Parity:
    """Largest kernel-versus-plain error seen per kernel."""

    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.fa_share = {}

    def bitwise(self, name, a, b, what):
        check(a.shape == b.shape and bool((a == b).all()),
              f"{name} {what} not bitwise equal to the plain version")

    def moments(self, name, got, want, bound1, bound2, what):
        """got/want = (w_tot, s1, s2); bound1 = Σw|x|, bound2 = Σw·x²."""
        self.bitwise(name, got[0], want[0], f"w_tot {what}")
        for i, bound in ((1, bound1), (2, bound2)):
            self.within(name, got[i], want[i], bound, f"s{i} {what}")

    def within(self, name, got, want, bound, what):
        diff = (got - want).abs()
        self.err[name] = max(self.err[name], float(diff.max()))
        check(bool((diff <= 1e-5 * bound).all()),
              f"{name} {what}: max |err| {float(diff.max())} over its "
              f"1e-5 bound")

    def attention(self, got, want, what, pv_abs=None):
        """Kernel 12 against its plain version: f32 within atol 2e-5 and
        rtol 1e-4 (tests/test_kernels.py's tolerance); bf16, compared in
        f32, within one bf16 rounding of the output, 1e-3 + 2^-7·|want|,
        plus the kernel's rounding of P to bf16 before P·V, 2^-8·(Σ
        p·|v|)/l an output: ``pv_abs``, the plain version run on |v|
        (attention_pv_abs).  Records the largest error and the largest
        share of the bound used, per dtype."""
        diff = (got.float() - want.float()).abs()
        self.err["flash_attention"] = max(self.err["flash_attention"],
                                          float(diff.max()))
        if want.element_size() == 4:
            tol = 2e-5 + 1e-4 * want.float().abs()
        else:
            tol = 1e-3 + 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * pv_abs
        key = str(want.dtype).replace("torch.", "")
        share = float((diff / tol).max())
        self.fa_share[key] = max(self.fa_share.get(key, 0.0), share)
        check(got.dtype == want.dtype and bool((diff <= tol).all()),
              f"flash_attention {what}: max |err| {float(diff.max())}")
        return float(diff.max()), share

    def kmeans(self, name, got, want, bound_sums, what):
        """got/want = (sums, counts, inertia); bound_sums = Σw|x| per dim
        (broadcast over clusters); inertia is held to 1e-5 of itself."""
        self.bitwise(name, got[1], want[1], f"counts {what}")
        self.within(name, got[0], want[0], bound_sums, f"sums {what}")
        self.within(name, got[2], want[2], want[2].abs(), f"inertia {what}")


def wrappers():
    """Each kernel's name and the function that counts its launches in
    ``launches``: the wrapper, or for the GROUP BY kernels and kernels 5
    and 7 the card path of the wrapper's keyed, streamed or block_bins
    call."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.weighted_hist.ops import (binblocked_cuda,
                                                       fused_poisson_hist,
                                                       grouped_hist_cuda,
                                                       weighted_histogram)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_cuda, moments_stream_cuda,
        weighted_moments)
    return {"poisson_counts": poisson_counts,
            "fused_poisson_moments": fused_poisson_moments,
            "fused_poisson_hist": fused_poisson_hist,
            "fused_poisson_multi": fused_poisson_multi,
            "kmeans_assign": kmeans_assign,
            "fused_poisson_kmeans": fused_poisson_kmeans,
            "fused_poisson_moments_grouped": grouped_moments_cuda,
            "fused_poisson_hist_grouped": grouped_hist_cuda,
            "weighted_moments": weighted_moments,
            "weighted_histogram": weighted_histogram,
            "fused_poisson_moments_stream": moments_stream_cuda,
            "fused_poisson_hist_binblocked": binblocked_cuda,
            "flash_attention": flash_attention}


def zero_counts() -> None:
    for f in wrappers().values():
        f.launches = 0


def geometry(lib: str, args: tuple) -> tuple:
    """What a launch's result depends on besides its data, as sorted
    (field, value) pairs, from the arguments of ``earl_<lib>``."""
    if lib == "poisson_counts":
        _, Bp, np_, bb, bn, t0, _, _ = args
        fields = dict(Bp=Bp, np_=np_, bb=bb, bn=bn, offset=t0 > 0)
    elif lib == "flash_attention":
        (dtype, BHq, Hq, Hkv, Sq, Skv, D, _, causal, window, kv_offset,
         *_) = args
        fields = dict(dtype=dtype, BHq=BHq, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
                      D=D, causal=causal, window=window, kv_offset=kv_offset)
    elif lib == "kmeans_assign":
        n, d, k, _, _, _, cols, ranges, threads, _, _, _ = args
        fields = dict(n=n, d=d, k=k, cols=cols, ranges=ranges,
                      threads=threads)
    elif lib == "fused_kmeans":
        (_, n_valid, Bp, np_, bb, bn, d, k, _, mask, _, tpc, ranges,
         _, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      k=k, masked=mask is not None, tpc=tpc, ranges=ranges)
    elif lib == "weighted_moments":
        B, n, d, _, _, rows, cols, ranges = args[:8]
        fields = dict(B=B, n=n, d=d, rows=rows, cols=cols, ranges=ranges)
    elif lib == "weighted_hist":
        (R, n, d, nbins, _, w, _, _, dc, rows, groups, ranges, copies,
         whole, _, _) = args
        fields = dict(R=R, n=n, d=d, nbins=nbins, unit=w is None, dc=dc,
                      rows=rows, groups=groups, ranges=ranges, copies=copies,
                      whole=whole)
    elif lib == "fused_stream":
        (_, n_valid, Bp, np_, bb, bn, d, _, mask, rows, tpc, ranges,
         *_) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      masked=mask is not None, rows=rows, tpc=tpc,
                      ranges=ranges)
    elif lib == "fused_binblocked":
        (_, n_valid, Bp, np_, bb, bn, d, G, _, mask, keys, nbins, _, _,
         width, rows, tpc, cluster, ranges, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      G=G, masked=mask is not None, keyed=keys is not None,
                      nbins=nbins, width=width, rows=rows, tpc=tpc,
                      cluster=cluster, ranges=ranges)
    elif lib == "fused_grouped":
        (_, n_valid, Bp, np_, bb, bn, d, G, _, mask, _, dc, kg, rows, tpc,
         ranges, part_w, _, _, _, _, _, nbins, _, _, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      G=G, masked=mask is not None, dc=dc, kg=kg, rows=rows,
                      tpc=tpc, ranges=ranges, moments=part_w is not None,
                      nbins=nbins)
    else:
        (_, n_valid, Bp, np_, bb, bn, d, _, mask, rows, tpc, ranges, part_w,
         _, _, _, _, _, n_hist, _, _, _, hist_total, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      masked=mask is not None, rows=rows, tpc=tpc,
                      ranges=ranges, moments=part_w is not None,
                      n_hist=n_hist, hist_total=hist_total)
    return tuple(sorted(fields.items()))


class LaunchLog:
    """Logs the geometry of every kernel launch while it is entered.

    Every wrapper launches through ``_build.launch``, so the log wraps that
    one call; the wrapper that launched is the one whose count went up
    since the launch before.  ``geometries`` maps (wrapper name, geometry)
    to the number of launches."""

    def __init__(self):
        from repro_torch.kernels import _build
        self.build = _build
        self.geometries = {}

    @staticmethod
    def counts():
        return {name: f.launches for name, f in wrappers().items()}

    def __enter__(self):
        self.orig, self.before = self.build.launch, self.counts()
        self.build.launch = self.launch
        return self

    def __exit__(self, *exc):
        self.build.launch = self.orig

    def launch(self, lib, *args):
        now = self.counts()
        who = [k for k in now if now[k] != self.before[k]]
        self.before = now
        check(len(who) == 1, f"a launch of {lib} not made by exactly one "
              f"wrapper: {who}")
        key = (who[0], geometry(lib, args))
        self.geometries[key] = self.geometries.get(key, 0) + 1
        return self.orig(lib, *args)


class NoLaunch:
    """Fails on any kernel launch while it is entered: a plain version
    that a kernel is held against, or timed beside, computes without one."""

    def __init__(self, fn):
        from repro_torch.kernels import _build
        self.build, self.fn = _build, fn

    def __enter__(self):
        self.orig = self.build.launch
        self.build.launch = self.launch
        return self

    def __exit__(self, *exc):
        self.build.launch = self.orig

    def launch(self, lib, *args):
        check(False, f"the plain version {self.fn.__name__} launched the "
              f"{lib} kernel")


def plain(fn, *args, **kw):
    """``fn(*args, **kw)``, a plain version, checked to launch nothing."""
    with NoLaunch(fn):
        return fn(*args, **kw)


def phase_parity(torch, parity: Parity) -> None:
    from repro_torch.core.reduce_api import Mean, Quantile, StatisticGroup, Std
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.poisson_counts.ref import poisson_weights_plain
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    gen = torch.Generator().manual_seed(11)
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    cases = [(4, 300), (8, 8192), (100, 300), (100, 8192), (BIG_B, BIG_N)]
    for B, n in cases:
        for masked in (False, True):
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            x = (torch.randn(n, 1, generator=gen) * 2.0 + 10.0).cuda()
            n_valid = n - 17 if masked else n
            mask = None
            if masked:
                mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
            what = f"B={B} n={n}{' masked' if masked else ''}"

            pr = prepare(x, B, n_valid=n_valid, valid_mask=mask)
            w_k = poisson_counts(seed, B, n, device="cuda")
            w_p = plain(poisson_weights_plain, seed, pr.Bp, pr.np_, pr.bb,
                        pr.bn, device="cuda")[:B, :n]
            parity.bitwise("poisson_counts", w_k, w_p, f"weights {what}")

            mom_k = fused_poisson_moments(seed, x, B, n_valid=n_valid,
                                          valid_mask=mask)
            mom_p = [t[:B] for t in plain(moments_plain, pr, seed)]
            abs_p = [t[:B] for t in plain(
                moments_plain, prepare(x.abs(), B, n_valid=n_valid,
                                       valid_mask=mask), seed)]
            parity.moments("fused_poisson_moments", mom_k, mom_p, abs_p[1],
                           mom_p[2], what)

            lo = torch.full((1,), LO, device="cuda")
            hi = torch.full((1,), HI, device="cuda")
            h_k = fused_poisson_hist(seed, x, LO, HI, NBINS, B,
                                     n_valid=n_valid, valid_mask=mask)
            h_p = plain(hist_plain, pr, seed, lo, hi, NBINS)[:B]
            parity.bitwise("fused_poisson_hist", h_k, h_p, f"counts {what}")

            g_k = fused_poisson_multi(group, seed, x, B, n_valid=n_valid,
                                      valid_mask=mask)
            g_p = plain(_multi_scan, group.slots, seed, pr)
            g_p = (tuple(t[:B] for t in (g_p[0].w, g_p[0].s1, g_p[0].s2)),
                   g_p[1].counts[:B])
            parity.moments("fused_poisson_multi",
                           (g_k[0].w, g_k[0].s1, g_k[0].s2), g_p[0],
                           abs_p[1], mom_p[2], what)
            parity.bitwise("fused_poisson_multi", g_k[1].counts, g_p[1],
                           f"counts {what}")
            # members against the dedicated kernels, bitwise
            for a, b, f in ((g_k[0].w, mom_k[0], "w_tot"),
                            (g_k[0].s1, mom_k[1], "s1"),
                            (g_k[0].s2, mom_k[2], "s2"),
                            (g_k[1].counts, h_k, "counts")):
                check(bool((a == b).all()),
                      f"group {f} differs from the dedicated kernel, {what}")
    # the binning edge cases: NaN mass dropped, +-inf and x == hi clipped
    x = torch.tensor([[float("nan")], [float("inf")], [-float("inf")],
                      [HI], [LO], [HI * 2], [12.5]] * 60).cuda()
    seed = 12345
    pr = prepare(x, 8)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    parity.bitwise("fused_poisson_hist",
                   fused_poisson_hist(seed, x, LO, HI, NBINS, 8),
                   plain(hist_plain, pr, seed, lo, hi, NBINS)[:8],
                   "edge values")
    torch.cuda.synchronize()
    print(f"parity: all kernels match their plain versions; max |err| "
          f"{json.dumps(parity.err)}")


def km_data(torch, n: int, k: int, d: int, seed: int):
    """k Gaussian blobs (n, d) on the card, and centroids near their
    centers."""
    import numpy as np
    from repro_torch.data import synthetic_clusters
    x, centers = synthetic_clusters(n, k=k, dim=d, seed=seed)
    cent = centers + np.random.default_rng(seed).normal(0, 0.1, centers.shape)
    return (torch.from_numpy(x).cuda(),
            torch.from_numpy(cent.astype(np.float32)).cuda())


def hold_fused_kmeans(parity, seed, x, cent, B, what, **kw) -> None:
    """The fused k-means kernel against its plain version on one input;
    ``kw`` are n_valid / valid_mask."""
    from repro_torch.kernels.kmeans_assign.ops import (fused_kmeans_plain,
                                                       fused_poisson_kmeans)
    from repro_torch.kernels.weighted_stats.ops import moments_plain, prepare
    got = fused_poisson_kmeans(seed, x, cent, B, **kw)
    want = [t[:B] for t in plain(fused_kmeans_plain, prepare(x, B, **kw),
                                 seed, cent)]
    bound = plain(moments_plain, prepare(x.abs(), B, **kw), seed)[1][:B]
    parity.kmeans("fused_poisson_kmeans", got, want, bound[:, None, :],
                  what)


def hold_kmeans_assign(parity, x, w, cent, what) -> None:
    """kmeans_assign against its plain version under weights ``w``."""
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       kmeans_assign)
    parity.kmeans("kmeans_assign", kmeans_assign(x, w, cent),
                  plain(assign_plain, x, w, cent),
                  (w.double() @ x.abs().double()).float(), what)


def int_weights(torch, n: int, gen):
    """Whole weights 0..3 on the card."""
    return torch.randint(0, 4, (n,), generator=gen).float().cuda()


def phase_parity_kmeans(torch, parity: Parity) -> None:
    from repro_torch.core.reduce_api import (KMeansStep, Mean, Quantile,
                                             StatisticGroup)
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    gen = torch.Generator().manual_seed(17)
    cases = [(KM_B, KM_SAMPLE), (4, KM_N), (BIG_B, BIG_N)]
    for B, n in cases:
        for k, d in ((KM_K, 2), KM_WIDE):
            x, cent = km_data(torch, n, k, d, seed=n + k)
            for masked in (False, True):
                seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
                mask = None
                if masked:
                    mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
                what = (f"k-means B={B} n={n} k={k} d={d}"
                        f"{' masked' if masked else ''}")
                n_valid = n - 17 if masked else n
                hold_fused_kmeans(parity, seed, x, cent, B, what,
                                  n_valid=n_valid, valid_mask=mask)
                w = int_weights(torch, n, gen)
                if masked:
                    w = w * mask
                    w[n_valid:] = 0.0
                hold_kmeans_assign(parity, x, w, cent, what)
    # exact ties: (0, y) is as far from (-1, 0) as from (1, 0); the lower
    # cluster takes it, in the kernels as in the plain versions
    y = torch.linspace(-1.0, 1.0, 300)
    x = torch.stack([torch.zeros_like(y), y], dim=1).cuda()
    cent = torch.tensor([[-1.0, 0.0], [1.0, 0.0], [0.0, 3.0]]).cuda()
    hold_fused_kmeans(parity, 99, x, cent, 8, "exact ties")
    hold_kmeans_assign(parity, x, int_weights(torch, 300, gen), cent,
                       "exact ties")
    counts = kmeans_assign(x, None, cent)[1]
    check(counts.tolist() == [300.0, 0.0, 0.0],
          f"tied points not all in cluster 0: {counts.tolist()}")
    # a group with a KMeansStep member: each slot bitwise its dedicated
    # kernel (the k-means slot runs the k-means kernel with the same seed)
    x, cent = km_data(torch, KM_SAMPLE, KM_K, 2, seed=3)
    group = StatisticGroup((Mean(), KMeansStep(cent),
                            Quantile(0.5, nbins=256, lo=-8.0, hi=8.0)))
    for mask in (None, (torch.rand(KM_SAMPLE, generator=gen) > 0.3).float()
                 .cuda()):
        g = fused_poisson_multi(group, 7, x, KM_B, valid_mask=mask)
        ded_k = fused_poisson_kmeans(7, x, cent, KM_B, valid_mask=mask)
        ded_m = fused_poisson_moments(7, x, KM_B, valid_mask=mask)
        for a, b in zip((g[0].w, g[0].s1, g[0].s2, g[1].sums, g[1].counts,
                         g[1].inertia), (*ded_m, *ded_k)):
            check(bool((a == b).all()), "a group member differs from its "
                  "dedicated kernel (KMeansStep group)")
    torch.cuda.synchronize()
    print(f"parity (k-means): both kernels match their plain versions; "
          f"max |err| kmeans_assign {parity.err['kmeans_assign']}, "
          f"fused_poisson_kmeans {parity.err['fused_poisson_kmeans']}")


def keyed_rows(n: int, d: int = 1, G: int = 8, seed: int = 8, absent=None):
    """Rows [x (d columns), key], numpy f32: key g with frequency ∝ 2^-g
    (none for the key ``absent``; at n = 2,000,000 and G = 8 the rarest key
    has about 7,800 rows), x Normal(10 + key, 2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = 2.0 ** -np.arange(G)
    if absent is not None:
        p[absent] = 0.0
    keys = rng.choice(G, size=n, p=p / p.sum())
    x = rng.normal(10.0 + keys[:, None], 2.0, size=(n, d))
    return np.concatenate([x, keys[:, None]], axis=1).astype(np.float32)


def hold_grouped(torch, parity, seed, x, keys, G, B, nbins, what,
                 mask=None, kmeans_plain=False) -> None:
    """Both GROUP BY kernels against their plain versions on one input,
    and every keyed slot (moments, histogram, k-means) against the
    dedicated kernel masked to its key, bitwise."""
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       grouped_kmeans_plain)
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)
    kw = dict(valid_mask=mask, group_ids=keys, num_groups=G)
    pr = prepare(x, B, **kw)
    d = x.shape[1]
    got = fused_poisson_moments(seed, x, B, **kw)
    want = [t[:B] for t in plain(grouped_moments_plain, pr, seed)]
    bound = plain(grouped_moments_plain, prepare(x.abs(), B, **kw),
                  seed)[1][:B]
    parity.moments("fused_poisson_moments_grouped", got, want, bound,
                   want[2], what)
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    h = fused_poisson_hist(seed, x, LO, HI, nbins, B, **kw)
    parity.bitwise("fused_poisson_hist_grouped", h,
                   plain(grouped_hist_plain, pr, seed, lo, hi, nbins)[:B],
                   f"counts {what}")
    cent = x[:KM_K].contiguous()
    km = fused_poisson_kmeans(seed, x, cent, B, **kw)
    if kmeans_plain:
        wk = [t[:B] for t in plain(grouped_kmeans_plain, pr, seed, cent)]
        parity.kmeans("fused_poisson_kmeans", km, wk, bound[:, :, None, :],
                      f"keyed {what}")
    for g in range(G):
        m = (keys == g).float() if mask is None else mask * (keys == g)
        ded = fused_poisson_moments(seed, x, B, valid_mask=m)
        for a, b, f in zip(got, ded, ("w_tot", "s1", "s2")):
            check(torch.equal(a[:, g], b), f"grouped moments slot {g} {f} "
                  f"differs from the masked kernel, {what}")
        check(torch.equal(h[:, g], fused_poisson_hist(
            seed, x, LO, HI, nbins, B, valid_mask=m)),
            f"keyed hist slot {g} differs from the masked kernel, {what}")
        ded = fused_poisson_kmeans(seed, x, cent, B, valid_mask=m)
        for a, b, f in zip(km, ded, ("sums", "counts", "inertia")):
            check(torch.equal(a[:, g], b), f"keyed k-means slot {g} {f} "
                  f"differs from the masked kernel, {what}")


def phase_parity_grouped(torch, parity: Parity) -> None:
    from repro_torch.kernels._pass import grouped_geometry

    gen = torch.Generator().manual_seed(19)
    # (B, n, d, G, nbins, absent key): the main shapes, a key with no rows,
    # and G·(2d+1) = 144 > 128, which takes two z chunks of 8 keys
    cases = [(BIG_B, BIG_N, 1, GB_G, NBINS, None),
             (BIG_B, BIG_N, 4, GB_G, 256, None),
             (100, 8192, 1, GB_G + 1, NBINS, GB_G),
             (64, (1 << 16) + 37, 4, 16, 64, 15)]
    check(grouped_geometry(16, 4)[3] == 2, "G=16, d=4 is not chunked")
    for B, n, d, G, nbins, absent in cases:
        xk = torch.from_numpy(keyed_rows(n, d, G, seed=n + d + G,
                                           absent=absent)).cuda()
        x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
        for masked in (False, True):
            if absent is not None and masked:
                continue
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            mask = None
            if masked:
                mask = (torch.rand(n, generator=gen) > 0.3).float().cuda()
            what = (f"grouped B={B} n={n} d={d} G={G}"
                    f"{' masked' if masked else ''}")
            hold_grouped(torch, parity, seed, x, keys, G, B, nbins, what,
                         mask=mask, kmeans_plain=n < BIG_N)
            if absent is not None:
                from repro_torch.kernels.weighted_stats.ops import \
                    fused_poisson_moments
                w = fused_poisson_moments(seed, x, B, group_ids=keys,
                                          num_groups=G)[0]
                check(float(w[:, absent].abs().sum()) == 0.0,
                      f"the key without rows has weight, {what}")
    torch.cuda.synchronize()
    print(f"parity (GROUP BY): both kernels match their plain versions and "
          f"every keyed slot its masked dedicated kernel; max |err| "
          f"grouped moments {parity.err['fused_poisson_moments_grouped']}")


def phase_main_path(torch):
    """Runs the main path from zeroed launch counts; returns the counts,
    the logged launch geometries and the quickstart session (a function
    of the device) for the timing phase."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import (EarlSession, Mean, Median, Quantile,
                                  StatisticGroup, Std, bootstrap)
    from repro_torch.core.reduce_api import MomentState, Statistic
    from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi

    class RMS(Statistic):
        def init_state(self, dim, device="cpu"):
            z = torch.zeros(dim, device=device)
            return MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

        def update(self, state, values, weights=None):
            x = values.reshape(values.shape[0], -1)
            w = (torch.ones(x.shape[0], device=x.device) if weights is None
                 else weights)
            return MomentState(w=state.w + w.sum(), s1=state.s1,
                               s2=state.s2 + w @ (x * x))

        def finalize(self, state):
            return torch.sqrt(state.s2 / (state.w.unsqueeze(-1) + 1e-12))

    data = synthetic_numeric(QUICKSTART_N, mean=10.0, std=2.0, seed=0)
    exact = (float(data.mean()), float(np.median(data)), float(data.std()))

    def quickstart(device):
        store = ShardedStore.from_array(data, split_size=65_536)
        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        session = EarlSession(PreMapSampler(store, seed=1, device=device),
                              group, sigma=0.05, backend="fused_rng",
                              device=device)
        return session.run(trandom.PRNGKey(0))

    def single(stat):
        store = ShardedStore.from_array(data, split_size=65_536)
        return EarlSession(PreMapSampler(store, seed=1), stat, sigma=0.05,
                           backend="fused_rng").run(trandom.PRNGKey(0))

    xs = torch.from_numpy(data[:65_536]).cuda()
    xb = torch.from_numpy(synthetic_numeric(BOOT_N, seed=7)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        t0 = time.perf_counter()
        out = quickstart(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        quick_launches = fused_poisson_multi.launches
        mean_out = single(Mean())
        median_out = single(Median(lo=LO, hi=HI))
        rms = bootstrap(xs, RMS(), 64, trandom.PRNGKey(3), backend="fused_rng")

        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        key = trandom.PRNGKey(5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, group, BIG_B, key, backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()

    # ---- checks of what came out -------------------------------------
    print(f"main path launches: {json.dumps(launches)} (quickstart session: "
          f"fused_poisson_multi x{quick_launches})")
    check(quick_launches > 0, "the quickstart session launched no "
          "fused_poisson_multi kernel")
    check(all(launches[k] > 0 for k in QUICKSTART_KERNELS),
          f"a kernel of the quickstart path was not launched: {launches}")
    names = ("mean", "median", "std")
    summary = dict(B=out.B, iterations=out.iterations, n_used=out.n_used,
                   worst_cv=out.cv, wall_s=wall, members={})
    for name, res, rep, ex in zip(names, out.result, out.reports, exact):
        est = float(torch.as_tensor(res).reshape(-1)[0])
        rel = abs(est - ex) / abs(ex)
        summary["members"][name] = dict(
            estimate=est, exact=ex, rel_err=rel, cv=rep.cv,
            ci=[float(rep.ci_lo.reshape(-1)[0]),
                float(rep.ci_hi.reshape(-1)[0])])
        check(math.isfinite(est) and rel < 0.02,
              f"quickstart {name}: estimate {est} vs exact {ex}")
    print("quickstart (cuda): " + json.dumps(summary))

    cpu = quickstart("cpu")
    check((cpu.B, cpu.n_used, cpu.iterations)
          == (out.B, out.n_used, out.iterations),
          f"cpu session took (B, n_used, iterations) = "
          f"{(cpu.B, cpu.n_used, cpu.iterations)}, cuda "
          f"{(out.B, out.n_used, out.iterations)}")
    # moments agree to f32 rounding (1e-5); Std = sqrt(E[x²] - E[x]²)
    # scales that by E[x²] / Var[x] = 26 for this data; the median comes
    # from histogram counts and is bitwise.
    for name, a, b in zip(names, out.result, cpu.result):
        a, b = float(a.reshape(-1)[0]), float(b.reshape(-1)[0])
        if name == "median":
            check(a == b, f"median cuda {a} != cpu {b}")
        rtol = 26e-5 if name == "std" else 1e-5
        check(abs(a - b) <= rtol * abs(b), f"{name} cuda {a} vs cpu {b}")
    print(f"quickstart (cpu): B={cpu.B} iterations={cpu.iterations} "
          f"n_used={cpu.n_used}: agrees with the card")

    for label, o, ex in (("Mean()", mean_out, exact[0]),
                         ("Median()", median_out, exact[1])):
        est = float(torch.as_tensor(o.result).reshape(-1)[0])
        check(abs(est - ex) / abs(ex) < 0.02, f"{label} session {est} vs {ex}")
        print(f"{label} session: B={o.B} iterations={o.iterations} "
              f"n_used={o.n_used} estimate={est} cv={o.cv}")
    rms_mean = float(rms.thetas.mean())
    rms_exact = float(np.sqrt(np.mean(data[:65_536].astype(np.float64) ** 2)))
    check(abs(rms_mean - rms_exact) / rms_exact < 1e-2,
          f"RMS bootstrap {rms_mean} vs {rms_exact}")

    thetas = big.thetas
    check(all(t.shape == (BIG_B, 1) or t.shape == (BIG_B,) for t in thetas)
          and all(bool(torch.isfinite(t).all()) for t in thetas),
          "bootstrap thetas not finite or of the wrong shape")
    bn_bytes = BIG_B * BOOT_N * 4
    check(peak < bn_bytes // 4, f"bootstrap peak {peak} B suggests a (B, n) "
          f"tensor ({bn_bytes} B)")
    boot = dict(B=BIG_B, n=BOOT_N, ms=boot_ms, peak_bytes=peak,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                weight_draws=BIG_B * BOOT_N, cv=big.report.cvs,
                estimate=[float(torch.as_tensor(e).reshape(-1)[0])
                          for e in big.estimate])
    print("bootstrap (cuda): " + json.dumps(boot))
    return launches, log.geometries, quickstart


def kmeans_example(torch, device):
    """examples/analytics_kmeans.py on ``device``: Lloyd over the full data
    and over a 2% sample, then the bootstrap certificate over KMeansStep.
    Returns the two fits' centroids, the bootstrap and the walls."""
    from repro_torch import random as trandom
    from repro_torch.core import KMeansStep, bootstrap, kmeans_fit
    from repro_torch.data import (PreMapSampler, ShardedStore,
                                  synthetic_clusters)

    x_np, _ = synthetic_clusters(KM_N, k=KM_K, dim=2, seed=5)
    sampler = PreMapSampler(ShardedStore.from_array(x_np, 65_536), seed=6,
                            device=device)
    xs = sampler.take(0, KM_SAMPLE)
    init = xs[:KM_K]
    x_full = torch.from_numpy(x_np).to(sampler.device)

    def sync():
        if sampler.device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    full, _ = kmeans_fit(x_full, KM_K, KM_ITERS, trandom.PRNGKey(0),
                         init=init, device=device)
    sync()
    t1 = time.perf_counter()
    earl, _ = kmeans_fit(xs, KM_K, KM_ITERS, trandom.PRNGKey(0), init=init,
                         device=device)
    boot = bootstrap(xs, KMeansStep(earl), KM_B, trandom.PRNGKey(0),
                     backend="fused_rng", device=device)
    sync()
    t2 = time.perf_counter()
    return dict(x=x_np, full=full.cpu(), earl=earl.cpu(), boot=boot,
                fit_full_s=t1 - t0, earl_s=t2 - t1)


def mean_min_d2(x, cents) -> float:
    """The example's inertia: mean squared distance to the nearest
    centroid, in float64 numpy."""
    import numpy as np
    d2 = ((x[:, None, :].astype(np.float64)
           - np.asarray(cents, np.float64)[None]) ** 2).sum(-1)
    return float(d2.min(axis=1).mean())


def phase_kmeans_path(torch):
    """The k-means path from zeroed launch counts: the example, then a
    B=256 bootstrap over 2^22 rows.  Returns the counts and the logged
    geometries."""
    from repro_torch import random as trandom
    from repro_torch.core import KMeansStep, bootstrap

    xb, cb = km_data(torch, KM_BOOT_N, KM_K, 2, seed=7)
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        ex = kmeans_example(torch, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, KMeansStep(cb), BIG_B, trandom.PRNGKey(11),
                        backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()
    print(f"k-means path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in KMEANS_KERNELS),
          f"a kernel of the k-means path was not launched: {launches}")

    # ---- checks of what came out -------------------------------------
    x = ex["x"]
    i_full, i_earl = mean_min_d2(x, ex["full"]), mean_min_d2(x, ex["earl"])
    gap = (i_earl - i_full) / i_full
    thetas = ex["boot"].thetas
    summary = dict(inertia_full=i_full, inertia_earl=i_earl, gap=gap,
                   centroid_cv=ex["boot"].cv, fit_full_s=ex["fit_full_s"],
                   earl_s=ex["earl_s"], rows=f"{KM_SAMPLE}/{KM_N}")
    print("k-means example (cuda): " + json.dumps(summary))
    check(thetas.shape == (KM_B, KM_K, 2)
          and bool(torch.isfinite(thetas).all()), "example thetas")
    check(math.isfinite(i_full) and gap < 0.05,
          f"EARL inertia gap {gap} (the paper validates < 5%)")

    # The CPU run: f32 sums in another order move a centroid by ~1e-6; a
    # point within that of a boundary may then change cluster, which moves
    # its centroid by |x - c| / count, under 1e-3 at the sample's ~1600
    # rows a cluster.  So centroids and thetas agree within 1e-3 (data
    # of scale 5), the example's inertia within 1e-4 of itself, and the
    # cv (a spread of ~1e-2 over 24 thetas) within 5% of itself.
    cpu = kmeans_example(torch, "cpu")
    for name in ("full", "earl"):
        diff = float((ex[name] - cpu[name]).abs().max())
        check(diff <= 1e-3, f"{name} fit: cuda and cpu centroids differ "
              f"by {diff}")
    tdiff = float((thetas.cpu() - cpu["boot"].thetas).abs().max())
    check(tdiff <= 1e-3, f"bootstrap thetas differ by {tdiff}")
    ci_full = mean_min_d2(x, cpu["full"])
    check(abs(ci_full - i_full) <= 1e-4 * i_full,
          f"full-fit inertia cuda {i_full} vs cpu {ci_full}")
    check(abs(cpu["boot"].cv - ex["boot"].cv) <= 0.05 * cpu["boot"].cv,
          f"centroid cv cuda {ex['boot'].cv} vs cpu {cpu['boot'].cv}")
    print(f"k-means example (cpu): agrees with the card; max |centroid "
          f"diff| full {float((ex['full'] - cpu['full']).abs().max())} "
          f"earl {float((ex['earl'] - cpu['earl']).abs().max())}, thetas "
          f"{tdiff}; cv {cpu['boot'].cv}; walls fit_full "
          f"{cpu['fit_full_s']:.2f} s, earl {cpu['earl_s']:.2f} s")

    check(big.thetas.shape == (BIG_B, KM_K, 2)
          and bool(torch.isfinite(big.thetas).all()),
          "B=256 k-means bootstrap thetas not finite or of the wrong shape")
    nk_bytes = KM_BOOT_N * KM_K * 4
    check(peak < nk_bytes, f"k-means bootstrap peak {peak} B suggests an "
          f"(n, k) tensor ({nk_bytes} B) or a (B, n) one "
          f"({BIG_B * KM_BOOT_N * 4} B)")
    print("k-means bootstrap (cuda): " + json.dumps(dict(
        B=BIG_B, n=KM_BOOT_N, k=KM_K, d=2, ms=boot_ms, peak_bytes=peak,
        nk_bytes=nk_bytes, Bn_bytes=BIG_B * KM_BOOT_N * 4, cv=big.cv,
        weight_draws=BIG_B * KM_BOOT_N)))
    return launches, log.geometries


def groupby_session(data, name, device):
    """The README's keyed session of the inner ``GB_INNERS[name]`` over a
    StratifiedSampler on ``device``; returns (result, session, wall of
    run() in s)."""
    import torch
    from repro_torch import core
    from repro_torch import random as trandom
    from repro_torch.data import ShardedStore, StratifiedSampler
    sampler = StratifiedSampler(ShardedStore.from_array(data, 65_536), GB_G,
                                seed=1, device=device)
    session = core.EarlSession(
        sampler, core.GroupedStatistic(GB_INNERS[name](core), GB_G),
        sigma=0.05, backend="fused_rng", device=device)
    t0 = time.perf_counter()
    out = session.run(trandom.PRNGKey(0))
    if sampler.device.type == "cuda":
        torch.cuda.synchronize()
    return out, session, time.perf_counter() - t0


#: the inner statistics of the GROUP BY path's sessions
GB_INNERS = {"mean": lambda core: core.Mean(),
             "median": lambda core: core.Quantile(0.5, lo=LO, hi=HI)}


def keyed_summary(out, session):
    from repro_torch.core import KeyedAccuracyReport
    return dict(B=out.B, n_used=out.n_used, iterations=out.iterations,
                fell_back=out.fell_back,
                worst_key=KeyedAccuracyReport(out.reports).worst_key,
                p_keys=session._p_keys(out.n_used).tolist())


def phase_groupby_path(torch):
    """The GROUP BY path from zeroed launch counts: the keyed Mean and
    median sessions, then a keyed Mean bootstrap at B=256, n=2^24-1000.
    Returns the counts, the logged geometries and the sessions' cold
    walls."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import GroupedStatistic, Mean, bootstrap

    data = keyed_rows(GB_N, G=GB_G)
    xb = torch.from_numpy(keyed_rows(BOOT_N, G=GB_G, seed=9)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    outs = {}
    with LaunchLog() as log:
        for name in GB_INNERS:
            outs[name] = groupby_session(data, name, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, GroupedStatistic(Mean(), GB_G), BIG_B,
                        trandom.PRNGKey(13), backend="fused_rng")
        end.record()
        end.synchronize()
        boot_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() - base
    launches = log.counts()
    print(f"GROUP BY path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in GROUPBY_KERNELS),
          f"a kernel of the GROUP BY path was not launched: {launches}")

    # ---- checks of what came out -------------------------------------
    vals, keys = data[:, 0].astype(np.float64), data[:, 1]
    exact = {"mean": [float(vals[keys == g].mean()) for g in range(GB_G)],
             "median": [float(np.median(vals[keys == g]))
                        for g in range(GB_G)]}
    walls = {}
    for name in GB_INNERS:
        out, session, wall = outs[name]
        walls[name] = wall
        est = out.result.reshape(GB_G).cpu()
        summary = keyed_summary(out, session)
        check(not out.fell_back and len(out.reports) == GB_G,
              f"keyed {name} session fell back or has no per-key reports")
        check(bool(torch.isfinite(est).all()), f"keyed {name}: {est}")
        rel = [abs(float(est[g]) - exact[name][g]) / exact[name][g]
               for g in range(GB_G)]
        check(max(rel) < 0.02, f"keyed {name} vs exact per key: rel {rel}")
        summary.update(wall_s=wall, worst_cv=out.cv, max_rel_err=max(rel),
                       cvs=[r.cv for r in out.reports])
        print(f"keyed {name} session (cuda): " + json.dumps(summary))
        cpu, cpu_session, cpu_wall = groupby_session(data, name, "cpu")
        cpu_summary = keyed_summary(cpu, cpu_session)
        same = {k: summary[k] for k in cpu_summary}
        check(cpu_summary == same, f"keyed {name}: cpu {cpu_summary} vs "
              f"cuda {same}")
        # moments agree to f32 rounding; the median comes from histogram
        # counts and is bitwise
        got, want = est, cpu.result.reshape(GB_G)
        if name == "median":
            check(torch.equal(got, want), f"keyed median cuda {got} != "
                  f"cpu {want}")
        check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
              f"keyed {name} cuda {got} vs cpu {want}")
        print(f"keyed {name} session (cpu): agrees with the card "
              f"({json.dumps(cpu_summary)}); wall {cpu_wall:.2f} s")

    check(big.thetas.shape == (BIG_B, GB_G, 1)
          and bool(torch.isfinite(big.thetas).all()),
          "keyed bootstrap thetas not finite or of the wrong shape")
    ng_bytes = BOOT_N * GB_G * 4
    check(peak < ng_bytes, f"keyed bootstrap peak {peak} B suggests an "
          f"(n, G) tensor ({ng_bytes} B)")
    print("keyed bootstrap (cuda): " + json.dumps(dict(
        B=BIG_B, n=BOOT_N, G=GB_G, ms=boot_ms, peak_bytes=peak,
        nG_bytes=ng_bytes, weight_draws=BIG_B * BOOT_N,
        cvs=big.report.cvs, worst_key=big.report.worst_key)))
    return launches, log.geometries, walls


def hold_weighted_moments(torch, parity, w, x, what) -> None:
    """Kernel 11 against its plain version under (B, n) weights ``w``:
    w_tot bitwise for whole-number weights (else within 1e-6·Σw), s1 and
    s2 within 1e-5·Σw|x| and 1e-5·Σw·x²."""
    from repro_torch.kernels.weighted_stats.ops import weighted_moments
    from repro_torch.kernels.weighted_stats.ref import weighted_moments_ref
    name = "weighted_moments"
    got, want = weighted_moments(w, x), plain(weighted_moments_ref, w, x)
    wd, xd = w.double(), x.double()
    b1, b2 = wd @ xd.abs(), wd @ (xd * xd)
    if bool((w == w.round()).all()):
        parity.moments(name, got, want, b1, b2, what)
    else:
        parity.within(name, got[0], want[0], 0.1 * wd.sum(1), f"w_tot {what}")
        parity.within(name, got[1], want[1], b1, f"s1 {what}")
        parity.within(name, got[2], want[2], b2, f"s2 {what}")


def hold_weighted_hist(torch, parity, x, w, nbins, what) -> None:
    """Kernel 10 against its plain version: counts bitwise for
    whole-number weights (``w`` None: unit weights), else within
    1e-6·Σ|w| of the row a bin."""
    from repro_torch.kernels.weighted_hist.ops import (weighted_hist_plain,
                                                       weighted_histogram)
    d = x.shape[1]
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    got = weighted_histogram(x, w, LO, HI, nbins)
    want = plain(weighted_hist_plain, x, None if w is None else w.reshape(
        -1, x.shape[0]), lo, hi, nbins).reshape(got.shape)
    if w is None or bool((w == w.round()).all()):
        parity.bitwise("weighted_histogram", got, want, what)
    else:
        bound = 0.1 * w.double().abs().sum(-1)
        parity.within("weighted_histogram", got, want,
                      bound.reshape(*bound.shape, 1, 1), what)


def phase_parity_materialized(torch, parity: Parity) -> None:
    """Kernels 11 and 10 against their plain versions: B in {1, 7, 256},
    n in {1, 1000, 2^20+37}, d in {1, 3, 8} for kernel 11, and R in
    {1, 256}, d in {1, 4}, nbins in {256, 2048} for kernel 10, with
    whole-number and fractional weights; R = 256 also against 256 one-row
    launches; kernel 10 also with every value in one bin (R in {1, 256}
    and unit weights), at n = 1, 2, 3 (mod 4) and with W a row slice off a
    16-byte boundary, repeat launches bitwise."""
    from repro_torch.kernels.weighted_hist.ops import weighted_histogram
    from repro_torch.kernels.weighted_stats.ops import weighted_moments

    gen = torch.Generator(device="cuda").manual_seed(23)
    for B in (1, 7, BIG_B):
        for n in (1, 1000, BIG_N):
            for d in (1, 3, 8):
                x = torch.randn(n, d, device="cuda", generator=gen) * 2 + 3
                whole = torch.randint(0, 5, (B, n), device="cuda",
                                      generator=gen).float()
                frac = torch.rand(B, n, device="cuda", generator=gen)
                for w, kind in ((whole, "whole"), (frac, "fractional")):
                    hold_weighted_moments(torch, parity, w, x,
                                          f"B={B} n={n} d={d} {kind}")
    again = [weighted_moments(frac, x) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*again)),
          "weighted_moments repeat runs differ (fractional weights)")
    frac_repeat = []
    for R in (1, BIG_B):
        for d in (1, 4):
            for nbins in (256, NBINS):
                n = BIG_N
                x = torch.randn(n, d, device="cuda", generator=gen) * 6 + 12
                # NaN, +-inf, the bin edges and values past them
                x[:7, 0] = torch.tensor([float("nan"), float("inf"),
                                         -float("inf"), LO, HI, 10 * HI, -HI])
                w = torch.randint(0, 5, (R, n), device="cuda",
                                  generator=gen).float()
                w[:, 100:200] = 0.0
                what = f"R={R} n={n} d={d} nbins={nbins}"
                hold_weighted_hist(torch, parity, x, w, nbins, what)
                hold_weighted_hist(torch, parity, x, w[0], nbins,
                                   f"{what} (n,) weights")
                frac = torch.rand(R, n, device="cuda", generator=gen)
                hold_weighted_hist(torch, parity, x, frac, nbins,
                                   f"{what} fractional")
                frac_repeat.append(torch.equal(
                    weighted_histogram(x, frac, LO, HI, nbins),
                    weighted_histogram(x, frac, LO, HI, nbins)))
                if R == 1:
                    hold_weighted_hist(torch, parity, x, None, nbins,
                                       f"{what} unit weights")
                else:
                    rows = torch.stack([weighted_histogram(
                        x, w[r], LO, HI, nbins) for r in range(R)])
                    check(torch.equal(rows, weighted_histogram(
                        x, w, LO, HI, nbins)), f"R={R} is not {R} one-row "
                        f"launches, {what}")
    # every value in one bin (the most contended adds), n = 1, 2, 3 (mod
    # 4), and W a row slice whose base is off a 16-byte boundary
    whole_repeat = []
    for R in (1, BIG_B):
        x = torch.full((BIG_N, 1), 0.5 * (LO + HI), device="cuda")
        w = torch.randint(0, 5, (R, BIG_N), device="cuda",
                          generator=gen).float()
        hold_weighted_hist(torch, parity, x, w, NBINS,
                           f"R={R} every value in one bin")
        hold_weighted_hist(torch, parity, x, None, NBINS,
                           "unit weights, every value in one bin")
    for n in (BIG_N, BIG_N + 1, BIG_N + 2):
        x = torch.randn(n, 1, device="cuda", generator=gen) * 6 + 12
        big = torch.randint(0, 5, (BIG_B * n + 3,), device="cuda",
                            generator=gen).float()
        for off in (0, 1, 3):
            w = big[off:off + BIG_B * n].reshape(BIG_B, n)
            what = (f"R={BIG_B} n={n} (n mod 4 = {n % 4}), W base "
                    f"{w.data_ptr() % 16} bytes off 16")
            hold_weighted_hist(torch, parity, x, w, NBINS, what)
            whole_repeat.append(torch.equal(
                weighted_histogram(x, w, LO, HI, NBINS),
                weighted_histogram(x, w, LO, HI, NBINS)))
    check(all(whole_repeat), "kernel 10 repeat launches of whole-number "
          "weights differ")
    torch.cuda.synchronize()
    print(f"parity (materialized): both kernels match their plain versions; "
          f"max |err| weighted_moments {parity.err['weighted_moments']}, "
          f"weighted_histogram (fractional) "
          f"{parity.err['weighted_histogram']}; repeat runs bitwise: "
          f"weighted_moments True (fractional), weighted_histogram whole "
          f"True, fractional {frac_repeat}")


def phase_parity_stream(torch, parity: Parity) -> None:
    """Kernel 7 (block_bins) against hist_plain and, where its one window
    fits, against kernel 3, at d in {1, 4, 64}, nbins = 2048 and
    block_bins in {128, 512, 2048}, with the binning's edge values; keyed
    at G = 8, d = 4 against the plain keyed version; at n = 2^20 + 37, d =
    64 (several column ranges), with n_valid, and at B = 100.  Kernel 5
    (stream=True) against kernel 2, bitwise, and the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    name = "fused_poisson_hist_binblocked"
    gen = torch.Generator().manual_seed(29)
    for d, n in ((1, BIG_N), (4, BIG_N), (64, K7_WIDE_N)):
        x = torch.randn(n, d, generator=gen) * 6.0 + 12.0
        x[:6, 0] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 HI, 10 * HI, -HI])
        x = x.cuda()
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        for masked in (False, True):
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
            mask = ((torch.rand(n, generator=gen) > 0.3).float().cuda()
                    if masked else None)
            want = plain(hist_plain, prepare(x, BIG_B, valid_mask=mask),
                         seed, lo, hi, NBINS)[:BIG_B]
            one = (fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                      valid_mask=mask) if d <= 4 else None)
            for bb in (128, 512, NBINS):
                what = (f"counts d={d} n={n} block_bins={bb}"
                        f"{' masked' if masked else ''}")
                got = fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                         valid_mask=mask, block_bins=bb)
                parity.bitwise(name, got, want, what)
                check(one is None or torch.equal(got, one),
                      f"kernel 7 differs from kernel 3, {what}")
    # keyed: G·d·nbins = 65,536 bins a row, past the keyed histogram's
    # shared memory (it raises there and names block_bins)
    xk = torch.from_numpy(keyed_rows(K7_WIDE_N, K7_GD, K7_G, seed=3)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    kw = dict(group_ids=keys, num_groups=K7_G)
    try:
        fused_poisson_hist(1, x, LO, HI, NBINS, BIG_B, **kw)
        check(False, "the keyed histogram ran past its shared memory")
    except NotImplementedError:
        pass
    lo = torch.full((K7_GD,), LO, device="cuda")
    hi = torch.full((K7_GD,), HI, device="cuda")
    for masked in (False, True):
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        mask = ((torch.rand(K7_WIDE_N, generator=gen) > 0.3).float().cuda()
                if masked else None)
        got = fused_poisson_hist(seed, x, LO, HI, NBINS, BIG_B,
                                 valid_mask=mask, block_bins=NBINS, **kw)
        want = plain(grouped_hist_plain, prepare(x, BIG_B, valid_mask=mask,
                                                 **kw), seed, lo, hi, NBINS)
        parity.bitwise(name, got, want[:BIG_B],
                       f"keyed G={K7_G} d={K7_GD}"
                       f"{' masked' if masked else ''}")

    # several column ranges (global-atomic flush) beside one range (plain
    # stores), n_valid, and B = 100 (a row block past the last whole 4)
    from repro_torch.kernels._pass import binblocked_geometry
    ranges_seen = set()
    for B, d, n, n_valid in ((BIG_B, 64, BIG_N, None),
                             (BIG_B, 64, K7_WIDE_N, None),
                             (BIG_B, 4, BIG_N, BIG_N - 1000),
                             (100, 4, 20_000, None)):
        x = (torch.randn(n, d, generator=gen) * 6.0 + 12.0).cuda()
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        pr = prepare(x, B, n_valid=n_valid)
        geo = binblocked_geometry(pr.Bp, pr.np_, pr.bn, d * NBINS, NBINS)
        ranges_seen.add(geo.ranges > 1)
        got = fused_poisson_hist(seed, x, LO, HI, NBINS, B, n_valid=n_valid,
                                 block_bins=NBINS)
        parity.bitwise(name, got, plain(hist_plain, pr, seed, lo, hi,
                                        NBINS)[:B],
                       f"counts B={B} d={d} n={n} n_valid={n_valid} "
                       f"({geo.ranges} ranges, cluster {geo.cluster})")
    check(ranges_seen == {False, True}, "kernel 7's parity did not cover "
          "one column range and several")

    name = "fused_poisson_moments_stream"
    for B in (8, BIG_B):
        for n in (300, 65_536, BIG_N):
            for d in (1, 3, 64):
                xfull = (torch.randn(n + 1, d, generator=gen) * 2.0
                         + 3.0).cuda()
                for masked in (False, True):
                    # masked runs read x at a 4-byte offset: tiles that do
                    # not start on a 16-byte boundary
                    x = xfull[1:] if masked else xfull[:n]
                    seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                             generator=gen))
                    mask = ((torch.rand(n, generator=gen) > 0.3).float()
                            .cuda() if masked else None)
                    what = (f"B={B} n={n} d={d}"
                            f"{' masked, misaligned' if masked else ''}")
                    k2 = fused_poisson_moments(seed, x, B, valid_mask=mask)
                    k5 = fused_poisson_moments(seed, x, B, valid_mask=mask,
                                               stream=True)
                    for a, b, f in zip(k5, k2, ("w_tot", "s1", "s2")):
                        check(torch.equal(a, b), f"kernel 5 {f} differs "
                              f"from kernel 2, {what}")
                    want = [t[:B] for t in plain(
                        moments_plain, prepare(x, B, valid_mask=mask), seed)]
                    bound = plain(moments_plain, prepare(
                        x.abs(), B, valid_mask=mask), seed)[1][:B]
                    parity.moments(name, k5, want, bound, want[2], what)
    torch.cuda.synchronize()
    print(f"parity (streaming slice): kernel 7 matches the plain version "
          f"(and kernel 3 where one window fits), keyed too, over one and "
          f"several column ranges, with n_valid and B = 100; kernel 5 is "
          f"bitwise kernel 2; max |err| kernel 5 "
          f"{parity.err['fused_poisson_moments_stream']}")


class _Die(Exception):
    """The fault-tolerance walk's simulated crash."""


def dying_manager(root: str, after: int):
    """A CheckpointManager that raises _Die right after its ``after``-th
    committed save (examples/fault_tolerance.py's _DyingManager)."""
    from repro_torch.checkpoint import CheckpointManager

    class Dying(CheckpointManager):
        saves = 0

        def save(self, *a, **kw):
            super().save(*a, **kw)
            self.saves += 1
            if self.saves >= after:
                raise _Die

    return Dying(root, async_save=False)


def masked_fold(torch, data, lost, stat, B, key, chunk, device):
    """The degraded run's oracle: bootstrap_chunked's chunk update over
    ``data`` with the ``lost`` row ranges zeroed and masked out; returns
    (thetas, estimate, valid rows)."""
    import numpy as np
    from repro_torch.core.bootstrap import (fused_resample_states,
                                            offset_seed, seed_from_key)
    data = np.array(data, np.float32)
    for lo, hi in lost:
        data[lo:hi] = 0.0
    n, d = data.shape
    states, est = stat.init_batch(d, B, device), stat.init_state(d, device)
    base, valid = seed_from_key(key), 0
    for i in range(-(-n // chunk)):
        rows = data[i * chunk:(i + 1) * chunk]
        xb = np.zeros((chunk, d), np.float32)
        xb[:len(rows)] = rows
        mask = np.zeros(chunk, np.float32)
        mask[:len(rows)] = 1.0
        for lo, hi in lost:
            mask[max(lo - i * chunk, 0):max(min(hi, i * chunk + len(rows))
                                            - i * chunk, 0)] = 0.0
        valid += int(mask.sum())
        x = torch.from_numpy(xb).to(device)
        m = torch.from_numpy(mask).to(device)
        est = stat.update(est, x, m)
        states = stat.merge(states, fused_resample_states(
            stat, offset_seed(base, i), x, B, valid_mask=m))
    p_eff = valid / n
    return (stat.correct(stat.finalize_batch(states), p_eff),
            stat.correct(stat.finalize(est), p_eff), valid)


def report_dict(sr) -> dict:
    """A StreamReport's fields, JSON-ready."""
    out = {k: v for k, v in vars(sr).items() if k != "faults"}
    out["lost_splits"] = list(sr.lost_splits)
    if sr.faults is not None:
        out["faults"] = dict(vars(sr.faults))
    return out


def counted(fn):
    """(fn(), the launches it made per kernel)."""
    before = LaunchLog.counts()
    out = fn()
    after = LaunchLog.counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def fault_tolerance_walk(torch):
    """examples/fault_tolerance.py parts 1 to 3 on the card, each held
    bitwise against its oracle, then the walk's Mean and Count on the
    CPU."""
    import tempfile

    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (Count, Mean, StatisticGroup,
                                  bootstrap_streaming)
    from repro_torch.data import ShardedStore
    from repro_torch.ft import FailurePolicy, Fault, FaultyStore, RetryPolicy

    key = trandom.PRNGKey(0)
    data = np.random.default_rng(1).normal(10.0, 2.0, size=(FT_N, FT_D))
    store = ShardedStore.from_array(data, split_size=FT_SPLIT,
                                    interleave=False)

    def run(s, stat=None, device=None, **kw):
        return bootstrap_streaming(s, stat or Mean(), FT_B, key,
                                   chunk=FT_CHUNK, device=device, **kw)

    def same(a, b, what):
        check(torch.equal(a.thetas, b.thetas)
              and torch.equal(a.estimate, b.estimate),
              f"fault-tolerance walk: {what} not bitwise its oracle")

    reference = run(store)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run(store, checkpoint=dying_manager(tmp, 6), checkpoint_every=1)
            check(False, "the dying checkpoint manager did not die")
        except _Die:
            pass
        resumed = run(store, resume=True, checkpoint=CheckpointManager(tmp))
    check(resumed.stream.resumed_from_chunk == 6, "resume did not pick up "
          f"at chunk 6: {resumed.stream.resumed_from_chunk}")
    same(resumed, reference, "the resumed run")
    flaky = FaultyStore(store, [
        Fault(split=1, kind="io", attempts=2),
        Fault(split=4, kind="corrupt", attempts=1),
        Fault(split=7, kind="latency", attempts=1, latency_s=0.2)])
    transient = run(flaky, retry=RetryPolicy(max_attempts=4,
                                             base_delay=0.01, timeout=0.05))
    same(transient, reference, "the transient-fault run")
    f = transient.stream.faults
    check((f.io_errors, f.checksum_failures) == (2, 1)
          and f.deadline_misses >= 1, f"fault counters {vars(f)}")
    dead = FaultyStore(store, [Fault(split=3, kind="io", permanent=True)])
    degraded = run(dead, policy=FailurePolicy(
        retry=RetryPolicy(max_attempts=3, base_delay=0.0),
        on_exhausted="degrade"))
    lost = [(int(store.offsets[3]), int(store.offsets[4]))]
    thetas, est, valid = masked_fold(torch, store.read_all(), lost, Mean(),
                                     FT_B, key, FT_CHUNK, "cuda")
    check(degraded.stream.lost_splits == (3,)
          and degraded.stream.valid_rows == valid == FT_N - FT_SPLIT,
          f"degraded run lost {degraded.stream.lost_splits}, "
          f"{degraded.stream.valid_rows} valid rows")
    check(torch.equal(degraded.thetas, thetas)
          and torch.equal(degraded.estimate, est),
          "the degraded run is not bitwise its masked oracle")
    p_eff = degraded.stream.valid_rows / FT_N
    # the walk's Mean and Count (w_tot) on the card and the CPU
    group = StatisticGroup((Mean(), Count()))
    card, cpu = run(store, group), run(store, group, device="cpu")
    bound = 1e-5 * run(ShardedStore.from_array(np.abs(data), FT_SPLIT,
                                               interleave=False),
                       device="cpu").thetas
    check(torch.equal(card.thetas[0], reference.thetas),
          "the group's Mean member differs from the dedicated run")
    check(torch.equal(card.thetas[1].cpu(), cpu.thetas[1]),
          "w_tot of the walk differs between the card and the CPU")
    diff = (card.thetas[0].cpu() - cpu.thetas[0]).abs()
    check(bool((diff <= bound).all()), f"Mean thetas card vs CPU differ by "
          f"{float(diff.max())}")
    summary = dict(
        rows=FT_N, d=FT_D, B=FT_B, chunk=FT_CHUNK,
        estimate=float(reference.estimate.reshape(-1)[0]),
        kill_resume=dict(resumed_from_chunk=resumed.stream.resumed_from_chunk,
                         bitwise=True),
        transient=dict(faults=dict(vars(f)), bitwise=True),
        degraded=dict(lost_splits=list(degraded.stream.lost_splits),
                      valid_rows=degraded.stream.valid_rows, p_eff=p_eff,
                      cv=degraded.report.cv, cv_full=reference.report.cv,
                      bitwise_masked_oracle=True),
        cpu=dict(w_tot_bitwise=True, mean_max_abs_diff=float(diff.max())))
    print("fault-tolerance walk (cuda, cpu): " + json.dumps(summary))


def state_bytes(stat, dim: int, B: int) -> int:
    """Bytes of B resample states and the estimate of ``stat``."""
    from repro_torch.checkpoint.manager import _leaves
    return sum(t.numel() * t.element_size() for _, t in _leaves(
        (stat.init_batch(dim, B, "cpu"), stat.init_state(dim, "cpu"))))


def stream_real_size(torch):
    """The README's 64-column streaming store at 2^22 rows (1 GiB) and
    2^20: a streamed Mean (kernel 2 each chunk) and Quantile(block_bins)
    (kernel 7 each chunk), bitwise bootstrap_chunked over store.read_all()
    on the card, a kill and resume of the Quantile at 2^22 and a rerun of
    it under torch.profiler (kernel 7's summed card time beside the wall
    and the stage), kernel 5 over the Mean's chunks, and the peak device
    memory above the resident state at both sizes."""
    import tempfile

    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (Mean, Quantile, bootstrap_chunked,
                                  bootstrap_streaming, offset_seed,
                                  seed_from_key)
    from repro_torch.data import ShardedStore
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    data = np.random.default_rng(42).standard_normal(
        (max(ST_NS), ST_D), dtype=np.float32)
    key = trandom.PRNGKey(7)
    stats = {"Mean": (Mean(), "fused_poisson_moments"),
             "Quantile": (Quantile(0.5, NBINS, ST_LO, ST_HI,
                                   block_bins=NBINS),
                          "fused_poisson_hist_binblocked")}
    peaks = {}
    for n in ST_NS:
        store = ShardedStore.from_array(data[:n], split_size=ST_SPLIT,
                                        interleave=False)
        xdev = torch.from_numpy(store.read_all()).cuda()
        for name, (stat, kernel) in stats.items():
            def stream(**kw):
                return bootstrap_streaming(store, stat, ST_B, key,
                                           chunk=ST_CHUNK, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res, launches = counted(stream)
            peak = torch.cuda.max_memory_allocated() - base
            resident = state_bytes(stat, ST_D, ST_B)
            peaks[(name, n)] = peak - resident
            n_chunks = res.stream.n_chunks
            check(launches.get(kernel) == n_chunks, f"streamed {name} at "
                  f"n={n} launched {launches}, not {kernel} once per chunk "
                  f"({n_chunks})")
            want = bootstrap_chunked(xdev, stat, ST_B, key, chunk=ST_CHUNK,
                                     backend="fused_rng")
            check(torch.equal(res.thetas, want.thetas)
                  and torch.equal(res.estimate, want.estimate),
                  f"streamed {name} at n={n} is not bitwise "
                  f"bootstrap_chunked")
            check(bool(torch.isfinite(res.thetas).all())
                  and res.thetas.shape == (ST_B, ST_D),
                  f"streamed {name} thetas")
            rec = dict(name=name, n=n, d=ST_D, B=ST_B, chunk=ST_CHUNK,
                       report=report_dict(res.stream), launches=launches,
                       peak_above_state_bytes=peak - resident,
                       state_bytes=resident, nd_bytes=n * ST_D * 4,
                       cv=res.report.cv, bitwise_chunked=True)
            if name == "Mean":
                # kernel 5's entry point over the same chunks: its folded
                # moments are the streamed Mean's state, so its thetas
                seed = seed_from_key(key)
                ones = torch.ones(ST_CHUNK, device="cuda")
                acc = [torch.zeros(ST_B, device="cuda"),
                       torch.zeros(ST_B, ST_D, device="cuda"),
                       torch.zeros(ST_B, ST_D, device="cuda")]
                for i in range(n // ST_CHUNK):
                    part = fused_poisson_moments(
                        offset_seed(seed, i),
                        xdev[i * ST_CHUNK:(i + 1) * ST_CHUNK], ST_B,
                        valid_mask=ones, stream=True)
                    acc = [a + b for a, b in zip(acc, part)]
                check(torch.equal(stat.finalize_batch(stat.from_moments(
                    *acc)), res.thetas), "kernel 5 over the chunks is not "
                    "the streamed Mean")
            if name == "Quantile" and n == max(ST_NS):
                with tempfile.TemporaryDirectory() as tmp:
                    try:
                        stream(checkpoint=dying_manager(tmp, ST_KILL_AFTER),
                               checkpoint_every=ST_CKPT_EVERY)
                        check(False, "the dying manager did not die")
                    except _Die:
                        pass
                    resumed = stream(resume=True,
                                     checkpoint_every=ST_CKPT_EVERY,
                                     checkpoint=CheckpointManager(tmp))
                check(resumed.stream.resumed_from_chunk
                      == ST_KILL_AFTER * ST_CKPT_EVERY
                      and torch.equal(resumed.thetas, res.thetas)
                      and torch.equal(resumed.estimate, res.estimate),
                      "the resumed Quantile stream is not bitwise the "
                      "uninterrupted one")
                rec["kill_resume"] = report_dict(resumed.stream)
                rec["pace"] = stream_pace(torch, stream, res.stream)
            print("streamed bootstrap (cuda): " + json.dumps(rec))
        del xdev, store
    for name in stats:
        big, small = (peaks[(name, n)] for n in ST_NS)
        check(abs(big - small) <= 0.05 * max(big, small),
              f"streamed {name}: peak above the state {big} B at "
              f"n={ST_NS[0]} vs {small} B at n={ST_NS[1]}")
        check(big < ST_NS[0] * ST_D * 4 / 2, f"streamed {name}: peak "
              f"{big} B is not far below the store ({ST_NS[0] * ST_D * 4})")


def stream_pace(torch, stream, measured) -> dict:
    """What sets the streamed Quantile's pace: the summed card time of
    kernel 7 over its chunks (and of every kernel and copy, their union)
    in one more streamed run under torch.profiler, beside the wall and the
    stage (the pinned host copies) of that run and of the measured one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = stream()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    k7 = [b - a for a, b, name in spans if "binblocked_kernel" in name]
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    # the profiler may drop kernel records: scale its mean launch to the
    # chunks, and say how many it saw
    check(len(k7) > 0, "the profiler saw no launch of kernel 7")
    out = dict(kernel7_launches_seen=len(k7),
               kernel7_card_s=sum(k7) / len(k7) * res.stream.n_chunks * 1e-6,
               card_busy_s=busy_us * 1e-6,
               profiled_wall_s=res.stream.wall_s,
               profiled_stage_s=res.stream.stage_s,
               measured_wall_s=measured.wall_s,
               measured_stage_s=measured.stage_s)
    lead = max(("kernel 7", out["kernel7_card_s"]),
               ("the card", out["card_busy_s"]),
               ("the staging", out["measured_stage_s"]), key=lambda t: t[1])
    print(f"streamed Quantile's pace: kernel 7 {out['kernel7_card_s']:.4f} s "
          f"of card time over {res.stream.n_chunks} chunks ({len(k7)} "
          f"launches seen by the profiler), the card busy "
          f"{out['card_busy_s']:.4f} s; wall {measured.wall_s:.4f} s and "
          f"stage {measured.stage_s:.4f} s (profiled run: "
          f"{res.stream.wall_s:.4f} s, {res.stream.stage_s:.4f} s): "
          f"{lead[0]} sets the pace")
    return out


def phase_stream_path(torch):
    """The streaming path from zeroed launch counts with its geometries
    logged; returns the counts and the geometries."""
    torch.cuda.synchronize()
    zero_counts()
    with LaunchLog() as log:
        fault_tolerance_walk(torch)
        stream_real_size(torch)
    launches = log.counts()
    print(f"streaming path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in STREAM_KERNELS),
          f"a kernel of the streaming path was not launched: {launches}")
    return launches, log.geometries


def materialized_session(data, device):
    """The quickstart group's EarlSession with the JAX package's default
    backend (None: materialized Poisson weights) on ``device``."""
    from repro_torch import random as trandom
    from repro_torch.core import (EarlSession, Mean, Quantile,
                                  StatisticGroup, Std)
    from repro_torch.data import PreMapSampler, ShardedStore
    store = ShardedStore.from_array(data, split_size=65_536)
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    return EarlSession(PreMapSampler(store, seed=1, device=device), group,
                       sigma=0.05, device=device).run(trandom.PRNGKey(0))


def timed(torch, fn):
    """(result, wall s, peak bytes above what was allocated before) of
    ``fn()`` on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def mdb_run(stat, rows, device):
    """fig10's multinomial delta baseline: B = 16, two extends."""
    from repro_torch.core import MultinomialDeltaBootstrap
    m = MultinomialDeltaBootstrap(stat, MDB_B, seed=11, device=device)
    m.extend(rows[:MDB_ROWS])
    m.extend(rows[MDB_ROWS:])
    return m, m.result()


def phase_materialized_path(torch):
    """The materialized path (the JAX package's default backend=None),
    from zeroed launch counts with its geometries logged: the default
    quickstart session, bootstraps over a 1 GiB weight matrix (Mean with
    and without kernel 11, Median through kernel 10 at R = 256), fig10's
    delta extends and multinomial baseline, fig3's shared-base bootstrap
    and the chunked bootstrap with both backends.  Returns the counts and
    the logged geometries."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import (Mean, Median, Quantile, StatisticGroup,
                                  Std, bootstrap, bootstrap_chunked,
                                  poisson_delta_extend, poisson_delta_init,
                                  poisson_delta_result, poisson_weights,
                                  shared_base_bootstrap)
    from repro_torch.data import synthetic_numeric
    from repro_torch.kernels.weighted_hist.ops import weighted_histogram
    from repro_torch.kernels.weighted_stats.ops import weighted_moments

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matmuls are not IEEE on the materialized path")
    data = synthetic_numeric(QUICKSTART_N, mean=10.0, std=2.0, seed=0)
    exact = (float(data.mean()), float(np.median(data)), float(data.std()))
    xm = torch.from_numpy(synthetic_numeric(MAT_N, seed=21)).cuda()
    x10 = torch.from_numpy(synthetic_numeric(FIG10_N, 10.0, 2.0,
                                             seed=9)).cuda()
    mdb_rows = synthetic_numeric(2 * MDB_ROWS, 10.0, 2.0, seed=10)
    x3 = synthetic_numeric(SB_N, 10.0, 2.0, seed=1)
    xc = torch.from_numpy(synthetic_numeric(CHUNK_N, seed=22)).cuda()
    med = Median(lo=LO, hi=HI)
    key = trandom.PRNGKey(31)
    torch.cuda.synchronize()
    zero_counts()
    boots = {}
    with LaunchLog() as log:
        out, wall, _ = timed(torch, lambda: materialized_session(data, None))
        session_hist = weighted_histogram.launches
        for label, stat, uk in (("Mean use_kernel", Mean(), True),
                                ("Mean", Mean(), False),
                                ("Median", med, False)):
            boots[label] = timed(torch, lambda: bootstrap(
                xm, stat, MAT_B, key, use_kernel=uk))
        half = FIG10_N // 2

        def fig10():
            pd = poisson_delta_init(Mean(), FIG10_B, 1, trandom.PRNGKey(6))
            pd = poisson_delta_extend(pd, x10[:half])
            return poisson_delta_result(poisson_delta_extend(pd, x10[half:]))
        f10, f10_wall, f10_peak = timed(torch, fig10)
        mdbs = {name: mdb_run(stat, mdb_rows, None)
                for name, stat in (("mean", Mean()), ("median", med))}
        sb, sb_wall, _ = timed(torch, lambda: shared_base_bootstrap(
            x3, med, SB_B, trandom.PRNGKey(4)))
        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        chunked = {be: timed(torch, lambda be=be: bootstrap_chunked(
            xc, group, CHUNK_B, trandom.PRNGKey(33), chunk=CHUNK,
            backend=be)) for be in (None, "fused_rng")}
    launches = log.counts()
    print(f"materialized path launches: {json.dumps(launches)} (default "
          f"session: weighted_histogram x{session_hist})")
    check(all(launches[k] > 0 for k in MATERIALIZED_KERNELS),
          f"a kernel of the materialized path was not launched: {launches}")

    # ---- the default session, on the card and the CPU -----------------
    names = ("mean", "median", "std")
    summary = dict(B=out.B, iterations=out.iterations, n_used=out.n_used,
                   worst_cv=out.cv, wall_s=wall, fell_back=out.fell_back,
                   weighted_histogram_launches=session_hist, members={})
    for name, res, ex in zip(names, out.result, exact):
        est = float(torch.as_tensor(res).reshape(-1)[0])
        rel = abs(est - ex) / abs(ex)
        summary["members"][name] = dict(estimate=est, exact=ex, rel_err=rel)
        check(math.isfinite(est) and rel < 0.02,
              f"default session {name}: estimate {est} vs exact {ex}")
    check(session_hist > 0, "the default session launched no "
          "weighted_histogram kernel")
    print("default session (cuda): " + json.dumps(summary))
    cpu = materialized_session(data, "cpu")
    check((cpu.B, cpu.n_used, cpu.iterations)
          == (out.B, out.n_used, out.iterations),
          f"default session: cpu took (B, n_used, iterations) = "
          f"{(cpu.B, cpu.n_used, cpu.iterations)}, cuda "
          f"{(out.B, out.n_used, out.iterations)}")
    for name, a, b in zip(names, out.result, cpu.result):
        a, b = float(a.reshape(-1)[0]), float(b.reshape(-1)[0])
        if name == "median":
            check(a == b, f"default session median cuda {a} != cpu {b}")
        rtol = 26e-5 if name == "std" else 1e-5
        check(abs(a - b) <= rtol * abs(b),
              f"default session {name} cuda {a} vs cpu {b}")
    print(f"default session (cpu): B={cpu.B} iterations={cpu.iterations} "
          f"n_used={cpu.n_used}: agrees with the card")

    # ---- the B = 256 bootstraps over a 1 GiB weight matrix --------------
    # the Knuth draw alone: its own time and peak; its weights are the
    # bootstraps' (same key), for the bound of the use_kernel comparison
    w, draw_wall, draw_peak = timed(torch, lambda: poisson_weights(
        key, MAT_B, MAT_N, device="cuda"))
    x2 = xm.reshape(MAT_N, -1)
    # the card's logf against the CPU's log: the share of equal weights
    shape = (64, 1 << 16)
    w_cpu = poisson_weights(key, *shape, device="cpu")
    unequal = int((poisson_weights(key, *shape, device="cuda").cpu()
                   != w_cpu).sum())
    check(unequal <= 1e-4 * w_cpu.numel(), f"{unequal} Poisson weights "
          f"differ between the card and the CPU")
    print(f"Poisson(1) weights, card against CPU: {unequal} of "
          f"{w_cpu.numel()} differ (share equal "
          f"{1 - unequal / w_cpu.numel()})")
    k11_ms = time_ms(torch, lambda: weighted_moments(w, x2), 5)
    k10_ms = time_ms(torch, lambda: weighted_histogram(x2, w, LO, HI, NBINS),
                     5)
    wd = w.double()
    theta_bound = 1e-5 * (wd @ x2.double().abs())[:, 0] / wd.sum(1)
    tk, tp = (boots[k][0].thetas[:, 0] for k in ("Mean use_kernel", "Mean"))
    diff = (tk.double() - tp.double()).abs()
    check(bool((diff <= theta_bound).all()), f"Mean thetas with and without "
          f"kernel 11 differ by up to {float(diff.max())}")
    w_bytes = MAT_B * MAT_N * 4
    for label, (res, bwall, peak) in boots.items():
        th = res.thetas
        check(th.shape[0] == MAT_B and bool(torch.isfinite(th).all()),
              f"{label} bootstrap thetas")
        check(peak < 4 * w_bytes, f"{label} bootstrap peak {peak} B, over "
              f"four (B, n) weight matrices")
        print(f"materialized bootstrap {label} (cuda): " + json.dumps(dict(
            B=MAT_B, n=MAT_N, wall_s=bwall, peak_bytes=peak,
            weight_bytes=w_bytes, cv=res.cv,
            kernel="weighted_moments" if label == "Mean use_kernel" else
            "weighted_histogram" if label == "Median" else "cuBLAS W @ x",
            kernel_ms=k11_ms if label == "Mean use_kernel" else
            k10_ms if label == "Median" else None)))
    print("Knuth Poisson(1) draw (cuda): " + json.dumps(dict(
        B=MAT_B, n=MAT_N, wall_s=draw_wall, peak_bytes=draw_peak,
        weight_bytes=w_bytes, mean=float(w.mean()), var=float(w.var()),
        max_abs_theta_diff_kernel_vs_matmul=float(diff.max()))))
    del w, wd

    # ---- fig10 and fig3 shapes -----------------------------------------
    est = float(f10.estimate.reshape(-1)[0])
    ex10 = float(x10.double().mean())
    check(bool(torch.isfinite(f10.thetas).all())
          and abs(est - ex10) <= 1e-5 * abs(ex10),
          f"fig10 delta estimate {est} vs {ex10}")
    print("fig10 materialized delta (cuda): " + json.dumps(dict(
        B=FIG10_B, n=FIG10_N, extends=2, wall_s=f10_wall,
        peak_bytes=f10_peak, cv=f10.cv)))
    for name, stat in (("mean", Mean()), ("median", med)):
        m, res = mdbs[name]
        mc, rc = mdb_run(stat, mdb_rows, "cpu")
        check((m.disk_accesses, m.items_moved, m.n)
              == (mc.disk_accesses, mc.items_moved, mc.n)
              and all(np.array_equal(a, b)
                      for a, b in zip(m.resamples, mc.resamples)),
              f"multinomial delta {name}: resamples or counts differ "
              f"between the card and the CPU")
        got, want = res.thetas.cpu(), rc.thetas
        if name == "median":
            check(torch.equal(got, want), "multinomial delta median thetas "
                  "differ between the card and the CPU")
        check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
              f"multinomial delta {name} thetas cuda vs cpu")
        print(f"fig10 multinomial delta {name}: " + json.dumps(dict(
            B=MDB_B, rows=2 * MDB_ROWS, disk_accesses=m.disk_accesses,
            items_moved=m.items_moved, cv=res.cv,
            cpu_agrees=True)))
    sb_cpu = shared_base_bootstrap(x3, med, SB_B, trandom.PRNGKey(4),
                                   device="cpu")
    check(torch.equal(sb.thetas.cpu(), sb_cpu.thetas),
          "shared-base median thetas differ between the card and the CPU")
    print("fig3 shared-base bootstrap (cuda): " + json.dumps(dict(
        B=SB_B, n=SB_N, wall_s=sb_wall, cv=sb.cv, cpu_agrees=True)))
    (cn, cn_wall, cn_peak), (cf, cf_wall, cf_peak) = (
        chunked[None], chunked["fused_rng"])
    for a, b in zip(cn.estimate, cf.estimate):
        check(torch.equal(a, b), "chunked estimates differ between backends")
    for t in cn.thetas + cf.thetas:
        check(bool(torch.isfinite(t).all()), "chunked thetas not finite")
    ratios = [a / b for a, b in zip(cn.report.cvs, cf.report.cvs)]
    check(all(0.5 < r < 2.0 for r in ratios),
          f"chunked cvs of the two backends differ: {ratios}")
    print("bootstrap_chunked (cuda): " + json.dumps(dict(
        B=CHUNK_B, n=CHUNK_N, chunk=CHUNK, none=dict(
            wall_s=cn_wall, peak_bytes=cn_peak, cvs=cn.report.cvs),
        fused_rng=dict(wall_s=cf_wall, peak_bytes=cf_peak,
                       cvs=cf.report.cvs))))
    return launches, log.geometries


def replay_materialized(torch, parity, gen, name, fields, what) -> None:
    """One launch geometry of kernel 10 or 11 on fresh data (whole-number
    weights) against the plain version."""
    g = dict(fields)
    rows = g["B"] if name == "weighted_moments" else g["R"]
    x = (torch.rand(g["n"], g["d"], generator=gen) * (HI - LO) + LO).cuda()
    w = torch.randint(0, 5, (rows, g["n"]), generator=gen).float().cuda()
    with LaunchLog() as log:
        if name == "weighted_moments":
            hold_weighted_moments(torch, parity, w, x, what)
        else:
            hold_weighted_hist(torch, parity, x, None if g["unit"] else
                               w[0] if rows == 1 else w, g["nbins"], what)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")


def phase_replay(torch, geometries, parity: Parity) -> None:
    """Holds every kernel against its plain version at each launch
    geometry of the main path, on fresh data: x is uniform on [LO, HI), so
    x >= 0 and the plain s1 is Σw|x|."""
    from repro_torch.core.reduce_api import (Mean, MomentState, Quantile,
                                             StatisticGroup, Std)
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import (poisson_counts,
                                                        poisson_tiles)
    from repro_torch.kernels.poisson_counts.ref import (poisson_weights_plain,
                                                        weight_block)
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    gen = torch.Generator().manual_seed(13)
    gen_cuda = torch.Generator(device="cuda").manual_seed(13)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    shapes = {}
    for (name, fields), count in sorted(geometries.items(), key=str):
        g = dict(fields)
        Bp, np_ = g.get("Bp"), g.get("np_")
        what = f"replay of {count} main-path launch(es) at {g}"
        if name in MATERIALIZED_KERNELS:
            shapes.setdefault(name, []).append((g.get("B", g.get("R")),
                                                g["n"]))
            replay_materialized(torch, parity, gen, name, fields, what)
            continue
        if name == "flash_attention":
            shapes.setdefault(name, []).append((g["BHq"], g["Sq"], g["Skv"],
                                                g["D"]))
            replay_attention(torch, parity, gen_cuda, fields, what)
            continue
        if name in ("fused_poisson_moments_stream",
                    "fused_poisson_hist_binblocked"):
            shapes.setdefault(name, []).append((Bp, np_))
            replay_stream(torch, parity, gen, name, fields, what)
            continue
        shapes.setdefault(name, []).append(
            (g["n"], g["k"], g["d"]) if name == "kmeans_assign"
            else (Bp, np_))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        if name in GROUPBY_KERNELS:
            replay_grouped(torch, parity, gen, seed, name, fields, what)
            continue
        if name in KMEANS_KERNELS:
            # the plain versions launch nothing, so the log sees only the
            # kernel's launch
            x, cent = km_data(torch, g.get("n", np_), g["k"], g["d"], seed)
            with LaunchLog() as log:
                if name == "kmeans_assign":
                    hold_kmeans_assign(parity, x,
                                       int_weights(torch, g["n"], gen),
                                       cent, what)
                else:
                    mask = None
                    if g["masked"]:
                        mask = (torch.rand(np_, generator=gen) > 0.3
                                ).float().cuda()
                    hold_fused_kmeans(parity, seed, x, cent, Bp, what,
                                      n_valid=g["n_valid"], valid_mask=mask)
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            continue
        if name == "poisson_counts" and g["offset"]:
            # a chunk of the tiled scan: n-tiles from an offset
            t0, t1 = 5, 5 + np_ // g["bn"]
            with LaunchLog() as log:
                w_k = poisson_tiles(seed, np_ * 4, Bp, g["bb"], g["bn"], t0,
                                    t1, device="cuda")
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            parity.bitwise(name, w_k, plain(
                weight_block, seed, np_ * 4, Bp, g["bb"], g["bn"], t0, t1,
                device="cuda"), what)
            continue
        if name == "poisson_counts":
            with LaunchLog() as log:
                w_k = poisson_counts(seed, Bp, np_, device="cuda")
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            parity.bitwise(name, w_k, plain(
                poisson_weights_plain, seed, Bp, np_, g["bb"], g["bn"],
                device="cuda"), what)
            continue
        d = g["d"]
        x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
        mask = None
        if g["masked"]:
            mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
        kw = dict(n_valid=g["n_valid"], valid_mask=mask)
        pr = prepare(x, Bp, **kw)
        check(g["n_hist"] <= 1 and g["hist_total"] % d == 0,
              f"{what}: the replay covers at most one histogram slot")
        nbins = g["hist_total"] // d
        stats = []
        if g["moments"]:
            stats += [Mean(), Std()]
        if g["n_hist"]:
            stats.insert(1, Quantile(0.5, nbins=nbins, lo=LO, hi=HI))
        group = StatisticGroup(tuple(stats))
        with LaunchLog() as log:
            if g["moments"]:
                mom_k = fused_poisson_moments(seed, x, Bp, **kw)
            if g["n_hist"]:
                h_k = fused_poisson_hist(seed, x, LO, HI, nbins, Bp, **kw)
            if name == "fused_poisson_multi":
                g_k = fused_poisson_multi(group, seed, x, Bp, **kw)
        check((name, fields) in log.geometries, f"{what}: launched "
              f"{list(log.geometries)}")
        if name == "fused_poisson_moments":
            want = plain(moments_plain, pr, seed)
            parity.moments(name, mom_k, want, want[1], want[2], what)
        elif name == "fused_poisson_hist":
            parity.bitwise(name, h_k,
                           plain(hist_plain, pr, seed, lo, hi, nbins), what)
        else:
            for sk, sp in zip(g_k, plain(_multi_scan, group.slots, seed, pr)):
                if isinstance(sk, MomentState):
                    parity.moments(name, (sk.w, sk.s1, sk.s2),
                                   (sp.w, sp.s1, sp.s2), sp.s1, sp.s2, what)
                    ded, got = mom_k, (sk.w, sk.s1, sk.s2)
                else:
                    parity.bitwise(name, sk.counts, sp.counts, what)
                    ded, got = (h_k,), (sk.counts,)
                for a, b in zip(got, ded):
                    check(bool((a == b).all()), f"{what}: a group member "
                          "differs from the dedicated kernel")
    torch.cuda.synchronize()
    print(f"replay: {sum(len(v) for v in shapes.values())} main-path launch "
          f"geometries match their plain versions; (Bp, np), (n, k, d) "
          f"for kmeans_assign, (rows, n) for the explicit-weight kernels, "
          f"or (B·Hq, Sq, Skv, D) for flash_attention, per kernel "
          f"{json.dumps(shapes)}")


def replay_grouped(torch, parity, gen, seed, name, fields, what) -> None:
    """One GROUP BY launch geometry on fresh data (x uniform on [LO, HI),
    so the plain s1 is Σw|x|) against the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)
    g = dict(fields)
    Bp, np_, d, G = g["Bp"], g["np_"], g["d"], g["G"]
    x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
    keys = torch.randint(0, G, (np_,), generator=gen).float().cuda()
    mask = None
    if g["masked"]:
        mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
    kw = dict(n_valid=g["n_valid"], valid_mask=mask, group_ids=keys,
              num_groups=G)
    pr = prepare(x, Bp, **kw)
    with LaunchLog() as log:
        if g["moments"]:
            got = fused_poisson_moments(seed, x, Bp, **kw)
        else:
            got = fused_poisson_hist(seed, x, LO, HI, g["nbins"], Bp, **kw)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")
    if g["moments"]:
        want = plain(grouped_moments_plain, pr, seed)
        parity.moments(name, got, want, want[1], want[2], what)
    else:
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        parity.bitwise(name, got, plain(grouped_hist_plain, pr, seed, lo,
                                        hi, g["nbins"]), what)


def replay_stream(torch, parity, gen, name, fields, what) -> None:
    """One launch geometry of kernel 5 or 7 on fresh data (x uniform on
    [LO, HI), so the plain s1 is Σw|x|) against the plain version."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)
    g = dict(fields)
    Bp, np_, d = g["Bp"], g["np_"], g["d"]
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    x = (torch.rand(np_, d, generator=gen) * (HI - LO) + LO).cuda()
    mask = None
    if g["masked"]:
        mask = (torch.rand(np_, generator=gen) > 0.3).float().cuda()
    kw = dict(n_valid=g["n_valid"], valid_mask=mask)
    if g.get("keyed"):
        kw.update(group_ids=torch.randint(0, g["G"], (np_,), generator=gen)
                  .float().cuda(), num_groups=g["G"])
    pr = prepare(x, Bp, **kw)
    with LaunchLog() as log:
        if name == "fused_poisson_moments_stream":
            got = fused_poisson_moments(seed, x, Bp, stream=True, **kw)
        else:
            got = fused_poisson_hist(seed, x, LO, HI, g["nbins"], Bp,
                                     block_bins=g["width"], **kw)
    check((name, fields) in log.geometries, f"{what}: launched "
          f"{list(log.geometries)}")
    if name == "fused_poisson_moments_stream":
        want = plain(moments_plain, pr, seed)
        parity.moments(name, got, want, want[1], want[2], what)
    else:
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        run = grouped_hist_plain if g.get("keyed") else hist_plain
        parity.bitwise(name, got, plain(run, pr, seed, lo, hi, g["nbins"]),
                       what)


def stream_rows(torch, launches, parity: Parity):
    """Kernel rows of kernels 5 and 7: kernel 5 beside kernel 2 at B = 256,
    n = 2^20 + 37, d = 1; kernel 7 at the streamed Quantile's chunk (B =
    256, n = 65,536, d = 64, nbins = block_bins = 2048).  Both are bound by
    the hash, one a weight; kernel 7 draws each weight once (the design
    before drew it once per window its column lands in, 64 here), and its
    cost terms beside the hash are printed."""
    import numpy as np
    from repro_torch.kernels._pass import binblocked_geometry
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    B, n, seed = BIG_B, BIG_N, 2027
    x = (torch.randn(n, 1, generator=torch.Generator().manual_seed(3))
         * 2.0 + 10.0).cuda()
    pr = prepare(x, B)
    xq = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (ST_CHUNK, ST_D), dtype=np.float32)).cuda()
    prq = prepare(xq, B)
    lo = torch.full((ST_D,), ST_LO, device="cuda")
    hi = torch.full((ST_D,), ST_HI, device="cuda")
    geo = binblocked_geometry(prq.Bp, prq.np_, prq.bn, ST_D * NBINS, NBINS)
    windows = geo.windows
    rowblocks = -(-prq.Bp // geo.rows)
    terms = dict(
        geometry=geo._asdict(), ctas=rowblocks * geo.ranges * geo.cluster,
        smem_bytes=geo.smem_bytes(prq.bn), weights_hashed=B * ST_CHUNK,
        draws_a_weight=1, draws_a_weight_before=windows,
        shared_adds_expected=round((1 - math.exp(-1)) * B * ST_CHUNK * ST_D),
        bin_index_evaluations=rowblocks * geo.ranges * ST_CHUNK * ST_D,
        flush_operations=geo.ranges * prq.Bp * ST_D * NBINS,
        flush="plain stores" if geo.ranges == 1 else "global atomics",
        x_bytes_read=ST_CHUNK * ST_D * 4,
        counts_bytes_written=prq.Bp * ST_D * NBINS * 4,
        dsmem_bytes_read=rowblocks * geo.ranges * geo.cluster * len(
            geo.windows_of(0)) * (geo.cluster - 1) * 16 * -(
                -geo.tiles_per_cta * prq.bn // 4))
    print(f"kernel 7 cost terms at the streamed chunk: {json.dumps(terms)}")
    runs = {
        "fused_poisson_moments_stream": (
            lambda: fused_poisson_moments(seed, x, B, stream=True),
            lambda: plain(moments_plain, pr, seed), n * 4 + 3 * B * 4,
            B * n, dict(B=B, n=n, d=1)),
        "fused_poisson_hist_binblocked": (
            lambda: fused_poisson_hist(seed, xq, ST_LO, ST_HI, NBINS, B,
                                       block_bins=NBINS),
            lambda: plain(hist_plain, prq, seed, lo, hi, NBINS),
            ST_CHUNK * ST_D * 4 + B * ST_D * NBINS * 4, B * ST_CHUNK,
            dict(B=B, n=ST_CHUNK, d=ST_D, nbins=NBINS, block_bins=NBINS,
                 windows=windows, draws_a_weight=1)),
    }
    rows = []
    libs = {"fused_poisson_moments_stream": "fused_stream",
            "fused_poisson_hist_binblocked": "fused_binblocked"}
    for name, (kernel, plain_fn, nbytes, weights, shape) in runs.items():
        ms = time_ms(torch, kernel, 5)
        alone_ms = launch_ms(torch, kernel, libs[name], 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, launch_ms=alone_ms, shape=shape))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms by {rows[-1]['bound_by']}) at "
              f"{shape}")
    # kernel 2 beside kernel 5, in turns, in this call
    turns = [time_ms(torch, lambda s=s: fused_poisson_moments(
        seed, x, B, stream=s), 5) for s in (False, True, True, False)]
    print(f"timing kernel 2 vs kernel 5 (B={B}, n={n}, d=1), in turns "
          f"k2, k5, k5, k2 (ms): {json.dumps(turns)}")
    ms2 = time_ms(torch, lambda: fused_poisson_moments(seed, xq, B), 5)
    ms5 = time_ms(torch, lambda: fused_poisson_moments(seed, xq, B,
                                                       stream=True), 5)
    print(f"timing at the streamed chunk (B={B}, n={ST_CHUNK}, d={ST_D}): "
          f"kernel 2 {ms2:.4f} ms, kernel 5 {ms5:.4f} ms; kernel 7 walks "
          f"{windows} windows over one draw of each weight (the design "
          f"before drew it {windows} times)")
    return rows


def kmeans_rows(torch, launches, parity: Parity):
    """Kernel rows of the two k-means kernels, at the shapes their main
    path gives them: kmeans_assign at the example's full fit (n = 400,000,
    k = 5, d = 2, unit weights), the fused kernel at the B = 256,
    n = 2^22 bootstrap."""
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       fused_kmeans_plain,
                                                       fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.weighted_stats.ops import prepare

    k, d, B, seed = KM_K, 2, BIG_B, 2025
    entries = k * (d + 1) + 1
    x, cent = km_data(torch, KM_N, k, d, seed=5)
    w = torch.ones(KM_N, device="cuda")
    xb, cb = km_data(torch, KM_BOOT_N, k, d, seed=7)
    pr = prepare(xb, B)
    # kmeans_assign: f32 operations a point, an FMA counted as two: xx
    # (2d-1), per centroid x·c (2d-1) and d² (3), and the accumulation of
    # d+1 sums and the inertia (2(d+2)); bytes: x and w read once, the
    # centroids read and the state written once.
    flops_pt = 2 * d - 1 + k * (2 * d + 2) + 2 * (d + 2)
    a_bytes = KM_N * (d + 1) * 4 + (k * d + entries) * 4
    a_flops = KM_N * flops_pt
    # fused: 73 integer operations a weight (the hash) and one FMA into
    # each of its row's k·(d+1)+1 entries; bytes: x read once, the states
    # written once.
    f_bytes = KM_BOOT_N * d * 4 + (k * d + B * entries) * 4
    runs = {
        "kmeans_assign": (
            lambda: kmeans_assign(x, w, cent),
            lambda: plain(assign_plain, x, w, cent),
            a_bytes / HBM_BYTES_PER_S,
            a_flops / F32_FLOPS_PER_S, dict(n=KM_N, k=k, d=d)),
        "fused_poisson_kmeans": (
            lambda: fused_poisson_kmeans(seed, xb, cb, B),
            lambda: plain(fused_kmeans_plain, pr, seed, cb),
            f_bytes / HBM_BYTES_PER_S,
            max(B * KM_BOOT_N * OPS_PER_WEIGHT / INT32_OPS_PER_S,
                B * KM_BOOT_N * entries * 2 / F32_FLOPS_PER_S),
            dict(B=B, n=KM_BOOT_N, k=k, d=d)),
    }
    rows = []
    for name, (kernel, plain_fn, t_bytes, t_ops, shape) in runs.items():
        ms = time_ms(torch, kernel, 20 if name == "kmeans_assign" else 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        bound = max(t_bytes, t_ops) * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, shape=shape))
        print(f"timing {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
              f"{bound:.4f} ms by {rows[-1]['bound_by']}) at {shape}")
    # the example's shapes of the fused kernel, for the record
    xs, cs = km_data(torch, KM_SAMPLE, k, d, seed=6)
    ms = time_ms(torch, lambda: fused_poisson_kmeans(seed, xs, cs, KM_B), 20)
    print(f"timing fused_poisson_kmeans at the example's B={KM_B}, "
          f"n={KM_SAMPLE}: {ms:.4f} ms")
    return rows


def groupby_rows(torch, launches, parity: Parity, walls):
    """Kernel rows of the two GROUP BY kernels at B = 256, n = 2^20 + 37,
    G = 8, d = 1 (nbins = 2048), the sessions' warm walls, and the grouped
    kernel against G masked moments launches at the reference benchmark's
    shape."""
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_plain, prepare)

    B, n, G, d, seed = BIG_B, BIG_N, GB_G, 1, 2026
    xk = torch.from_numpy(keyed_rows(n, d, G, seed=4)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    kw = dict(group_ids=keys, num_groups=G)
    pr = prepare(x, B, **kw)
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    weights = B * n
    t_hash = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S
    # moments: one f32 FMA per weight and accumulator, G·(2d+1) of them;
    # bytes: x and the keys read once, w_tot, s1, s2 written once
    t_fma = weights * G * (2 * d + 1) * 2 / F32_FLOPS_PER_S
    in_bytes = n * (d + 1) * 4
    runs = {
        "fused_poisson_moments_grouped": (
            lambda: fused_poisson_moments(seed, x, B, **kw),
            lambda: plain(grouped_moments_plain, pr, seed),
            in_bytes + B * G * (2 * d + 1) * 4, max(t_hash, t_fma)),
        "fused_poisson_hist_grouped": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B, **kw),
            lambda: plain(grouped_hist_plain, pr, seed, lo, hi, NBINS),
            in_bytes + B * G * d * NBINS * 4, t_hash),
    }
    rows = []
    for name, (kernel, plain_fn, nbytes, t_ops) in runs.items():
        ms = time_ms(torch, kernel, 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, shape=dict(B=B, n=n, d=d, G=G, nbins=NBINS)))
        print(f"timing {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
              f"{bound:.4f} ms by {rows[-1]['bound_by']})")

    # the grouped kernel against G masked launches of the moments kernel
    sh = GB_RATIO_SHAPE
    xk = torch.from_numpy(keyed_rows(sh["n"], sh["d"], G, seed=5)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    masks = [(keys == g).float() for g in range(G)]
    grouped_ms = time_ms(torch, lambda: fused_poisson_moments(
        seed, x, sh["B"], group_ids=keys, num_groups=G), 20)
    masked_ms = time_ms(torch, lambda: [fused_poisson_moments(
        seed, x, sh["B"], valid_mask=m) for m in masks], 20)
    print("grouped vs masked moments: " + json.dumps(dict(
        shape=dict(sh, G=G), grouped_ms=grouped_ms, masked_ms=masked_ms,
        masked_over_grouped=masked_ms / grouped_ms)))

    data = keyed_rows(GB_N, G=GB_G)
    for name in GB_INNERS:
        warm = [groupby_session(data, name, None)[2]
                for _ in range(SESSION_REPS)]
        print(f"keyed {name} session wall (s): cold {walls[name]}, "
              f"{SESSION_REPS} warm {json.dumps(warm)}; median "
              f"{sorted(warm)[SESSION_REPS // 2]}")
    return rows


def materialized_rows(torch, launches, parity: Parity):
    """Kernel rows of kernels 11 and 10 at B = 256, n = 2^20 + 37, d = 1
    under Poisson(1) weights (nbins = 2048), and kernel 10 at the point
    estimate of the one-shot bootstraps (unit weights, n = 2^24 - 1000)."""
    from repro_torch.core import poisson_weights
    from repro_torch.data import synthetic_numeric
    from repro_torch.kernels.weighted_hist.ops import (weighted_hist_plain,
                                                       weighted_histogram)
    from repro_torch.kernels.weighted_hist.ref import _bin_indices
    from repro_torch import random as trandom
    from repro_torch.kernels.weighted_stats.ops import weighted_moments
    from repro_torch.kernels.weighted_stats.ref import weighted_moments_ref

    B, n, d = BIG_B, BIG_N, 1
    x = (torch.randn(n, d, generator=torch.Generator().manual_seed(5))
         * 2.0 + 10.0).cuda()
    w = poisson_weights(trandom.PRNGKey(41), B, n, device="cuda")
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    x3 = torch.cat([torch.ones_like(x), x, x * x], dim=1)
    flat = (torch.arange(B, device="cuda")[:, None] * (d * NBINS)
            + _bin_indices(x, lo, hi, NBINS)[:, 0][None, :]).reshape(-1)
    w_bytes, x_bytes = B * n * 4, n * d * 4
    runs = {
        # bytes: W and x read once, w_tot, s1, s2 written once; operations:
        # an f32 add and 2d FMAs a weight
        "weighted_moments": (
            lambda: weighted_moments(w, x),
            lambda: plain(weighted_moments_ref, w, x),
            lambda: torch.matmul(w, x3),
            w_bytes + x_bytes + B * (2 * d + 1) * 4,
            B * n * (2 * d + 1) * 2),
        # bytes: W and x read once, the counts written once; operations:
        # one add a weight (the binning, per value, is n·d of them)
        "weighted_histogram": (
            lambda: weighted_histogram(x, w, LO, HI, NBINS),
            lambda: plain(weighted_hist_plain, x, w, lo, hi, NBINS),
            lambda: torch.bincount(flat, weights=w.reshape(-1),
                                   minlength=B * d * NBINS),
            w_bytes + x_bytes + B * d * NBINS * 4, B * n),
    }
    rows = []
    libs = {"weighted_moments": "weighted_moments",
            "weighted_histogram": "weighted_hist"}
    for name, (kernel, plain_fn, library, nbytes, flops) in runs.items():
        ms = time_ms(torch, kernel, 10)
        alone_ms = launch_ms(torch, kernel, libs[name], 10)
        plain_ms = time_ms(torch, plain_fn, 2)
        library_ms = time_ms(torch, library, 5)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms, launch_ms=alone_ms,
            shape=dict(B=B, n=n, d=d,
                       nbins=NBINS if "hist" in name else None)))
        print(f"timing {name}: {ms:.4f} ms (the kernel alone {alone_ms:.4f} "
              f"ms; plain {plain_ms:.2f} ms, library "
              f"{library_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms by "
              f"{rows[-1]['bound_by']})")
    del w, flat
    xb = torch.from_numpy(synthetic_numeric(BOOT_N, seed=7)).cuda().reshape(
        BOOT_N, 1)
    def point():
        return weighted_histogram(xb, None, LO, HI, NBINS)
    ms = time_ms(torch, point, 20)
    alone_ms = launch_ms(torch, point, "weighted_hist", 20)
    bound = (BOOT_N * 4 + NBINS * 4) / HBM_BYTES_PER_S * 1e3
    rows[-1]["point_estimate"] = dict(n=BOOT_N, ms=ms, launch_ms=alone_ms,
                                      bound_ms=bound)
    print(f"timing weighted_histogram at the point estimate (unit weights, "
          f"n={BOOT_N}, nbins={NBINS}): {ms:.4f} ms a call on CUDA events, "
          f"the kernel alone {alone_ms:.4f} ms (launches back to back; the "
          f"rest is the wrapper's host time between calls) (bound "
          f"{bound:.4f} ms by bytes)")
    return rows


def launch_ms(torch, fn, lib: str, reps: int) -> float:
    """Mean ms of one launch of ``earl_<lib>``, alone: ``fn`` runs once,
    and inside its own launch (its temporaries alive) the kernel is
    launched ``reps`` more times back to back between CUDA events, after
    one warm-up.  No wrapper work runs between them, and the extra
    launches add nothing to any count."""
    from repro_torch.kernels import _build
    orig, times = _build.launch, []

    def launch(name, *args):
        orig(name, *args)
        if name != lib:
            return
        orig(name, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            orig(name, *args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    _build.launch = launch
    try:
        fn()
    finally:
        _build.launch = orig
    check(len(times) == 1, f"{lib} launched {len(times)} times in one call")
    return times[0]


def phase_timing(torch, launches, parity: Parity, quickstart):
    from repro_torch.core.reduce_api import Mean, Quantile, StatisticGroup, Std
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.poisson_counts.ref import poisson_weights_plain
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    B, n, seed = BIG_B, BIG_N, 2024
    x = (torch.randn(n, 1, generator=torch.Generator().manual_seed(3))
         * 2.0 + 10.0).cuda()
    pr = prepare(x, B)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
    weights = B * n
    x_bytes = n * 4
    runs = {
        "poisson_counts": (
            lambda: poisson_counts(seed, B, n, device="cuda"),
            lambda: plain(poisson_weights_plain, seed, pr.Bp, pr.np_, pr.bb,
                          pr.bn, device="cuda"),
            B * n * 4),
        "fused_poisson_moments": (
            lambda: fused_poisson_moments(seed, x, B),
            lambda: plain(moments_plain, pr, seed), x_bytes + 3 * B * 4),
        "fused_poisson_hist": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B),
            lambda: plain(hist_plain, pr, seed, lo, hi, NBINS),
            x_bytes + B * NBINS * 4),
        "fused_poisson_multi": (
            lambda: fused_poisson_multi(group, seed, x, B),
            lambda: plain(_multi_scan, group.slots, seed, pr),
            x_bytes + 3 * B * 4 + B * NBINS * 4),
    }
    rows = []
    for name, (kernel, plain_fn, out_bytes) in runs.items():
        ms = time_ms(torch, kernel, 5)
        plain_ms = time_ms(torch, plain_fn, 1)
        t_bytes = out_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = weights * OPS_PER_WEIGHT / INT32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=parity.err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, shape=dict(B=B, n=n, d=1, nbins=NBINS)))
        print(f"timing {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms)")
    # the session is host work around microsecond kernels: its wall time
    # varies run to run, so it is timed again, warm, a few times
    walls = []
    for _ in range(SESSION_REPS):
        t0 = time.perf_counter()
        quickstart(None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"quickstart session wall, {SESSION_REPS} warm runs (s): "
          f"{json.dumps(walls)}; median {sorted(walls)[SESSION_REPS // 2]}")
    rows += kmeans_rows(torch, launches, parity)
    walls = [kmeans_example(torch, None) for _ in range(SESSION_REPS)]
    for key in ("fit_full_s", "earl_s"):
        v = [w[key] for w in walls]
        print(f"k-means example {key}, {SESSION_REPS} warm runs (s): "
              f"{json.dumps(v)}; median {sorted(v)[SESSION_REPS // 2]}")
    return rows


# ---------------------------------------------------------------------------
# the serving path: kernel 12 and the model stack (phase 11)
# ---------------------------------------------------------------------------
#: (b, hq, hkv, sq, skv, d), kwargs: tests/test_kernels.py's sweep, the
#: unaligned Sq = 67 at head_dim 120 and GQA 4, a decode-offset case, head
#: dims 20 (padded to 24 for TMA) and 128, Sq and Skv off the 128-row
#: tiles (200, 513), and a query block that sees no key at all
FA_NO_KEY_OFFSET = 100
FA_CASES = [
    ((2, 4, 2, 64, 64, 32), dict(causal=True)),
    ((1, 4, 4, 128, 128, 32), dict(causal=True, window=32)),
    ((2, 8, 2, 96, 96, 16), dict(causal=False)),
    ((1, 2, 1, 64, 192, 32), dict(causal=True, kv_offset=128)),
    ((1, 8, 1, 80, 80, 64), dict(causal=True)),
    ((1, 32, 8, 67, 67, 120), dict(causal=True)),
    ((4, 32, 8, 64, 4160, 120), dict(causal=True, window=4096,
                                     kv_offset=4096)),
    ((2, 4, 1, 200, 200, 20), dict(causal=True, window=50)),
    ((1, 8, 1, 513, 513, 128), dict(causal=True)),
    ((1, 4, 4, 200, 513, 64), dict(causal=False)),
    ((1, 2, 1, 64, 32, 16), dict(causal=True, window=16,
                                 kv_offset=FA_NO_KEY_OFFSET)),
]


def fa_inputs(torch, shape, dtype, gen):
    b, hq, hkv, sq, skv, d = shape
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def attention_pv_abs(q, k, v, kw):
    """The plain version on |v| with the same q, k and masks, in f32:
    (Σ p·|v|)/l an output, which bounds the P-rounding term of kernel
    12's bf16 tolerance (Parity.attention)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    return plain(flash_attention_plain, q.float(), k.float(), v.float().abs(),
                 **kw)


def hold_attention(parity, got, q, k, v, kw, what):
    """Kernel 12's output ``got`` against the plain version on q, k, v;
    returns the max |err| and the share of the bound it used."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    want = plain(flash_attention_plain, q, k, v, **kw)
    pv_abs = attention_pv_abs(q, k, v, kw) if q.element_size() == 2 else None
    return parity.attention(got, want, what, pv_abs)


def phase_parity_attention(torch, parity: Parity) -> None:
    """Kernel 12 against its plain version at the sweep (f32 and bf16)
    and at the full-width prefill shape (bf16, and f32 to hold the window's
    tile skip tightly where Sq passes the window); two bf16 launches at
    that shape must give the same bits."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(s, kw, dt) for s, kw in FA_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((FA_B, FA_HQ, FA_HKV, FA_S, FA_S, FA_D),
               dict(causal=True, window=FA_W), dt)
              for dt in (torch.bfloat16, torch.float32)]
    for shape, kw, dt in cases:
        q, k, v = fa_inputs(torch, shape, dt, gen)
        got = flash_attention(q, k, v, **kw)
        err, share = hold_attention(parity, got, q, k, v, kw,
                                    f"{shape} {kw} {dt}")
        if shape[3] == FA_S:
            print(f"parity: flash_attention at the full-width prefill "
                  f"shape in {dt}: max |err| {err}, largest share of the "
                  f"bound {share}")
        if kw.get("kv_offset") == FA_NO_KEY_OFFSET:
            check(bool((got == 0).all()), f"flash_attention {shape} {kw} "
                  f"{dt}: rows that see no key are not 0")
        if dt == torch.bfloat16 and shape[3] == FA_S:
            check(torch.equal(got, flash_attention(q, k, v, **kw)),
                  f"flash_attention {shape} {kw}: two bf16 launches differ")
    torch.cuda.synchronize()
    print(f"parity: flash_attention matches its plain version at "
          f"{len(cases)} cases; max |err| "
          f"{parity.err['flash_attention']}, largest share of the bound "
          f"{json.dumps(parity.fa_share)}; two bf16 launches at the "
          f"full-width shape bitwise equal")


def logits_tolerance(want) -> float:
    """bf16 tolerance of a logit: 2e-2 of the largest |logit| (bf16 keeps
    8 bits; roundings in another order move a logit by a few of them)."""
    return 2e-2 * float(want.abs().max())


def serve(torch, cfg, params, prompts, gen_steps, cache_len):
    """prefill (with room for the decode steps) and greedy decode steps;
    returns (logits per step, decoded tokens, prefill seconds, decode
    seconds, flash_attention launches of the prefill and of the decode,
    the cache after the last step)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import prefill
    from repro_torch.train import make_decode_step
    decode_step = make_decode_step(cfg)

    def sync():
        if prompts.is_cuda:
            torch.cuda.synchronize()
    sync()
    n0 = flash_attention.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, cache_len=cache_len)
    sync()
    t_prefill = time.perf_counter() - t0
    n_prefill = flash_attention.launches - n0
    steps, toks = [logits], []
    t0 = time.perf_counter()
    for t in range(gen_steps):
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok,
                                    prompts.shape[1] + t)
        steps.append(logits)
    sync()
    t_decode = time.perf_counter() - t0
    return (steps, torch.cat(toks, dim=1), t_prefill, t_decode, n_prefill,
            flash_attention.launches - n0 - n_prefill, cache)


def _weight_leaves(tree, name=""):
    """The parameter tensors a forward casts to the compute dtype: every
    one but the norm scales (which the norms read in f32)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weight_leaves(v, k)
    elif not name.endswith("norm"):
        yield tree


def profile_decode(torch, cfg, params, cache, tok, pos) -> dict:
    """Where a decode step's time goes: PROFILE_STEPS steps on the host's
    clock (when the host returned from each, and when the card was done),
    one step under torch.profiler (the card's busy time, the union of its
    kernels' intervals, and the device time of the casts,
    aten::_to_copy), and the casts of the f32 weights to the compute
    dtype that a step makes, timed alone with CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import dtype_of
    from repro_torch.train import make_decode_step
    step = make_decode_step(cfg)
    host, wall = [], []
    for i in range(PROFILE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, cache, tok, pos + i)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, cache, tok, pos + PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    cast_us = sum(r.device_time_total for r in prof.key_averages()
                  if r.key == "aten::_to_copy")
    # the host's calls into the CUDA runtime: launches, and any wait on
    # the card inside the step (the profiled step ends in one
    # cudaDeviceSynchronize of its own)
    calls = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu")):
            calls[e.name] = calls.get(e.name, 0) + 1
    leaves = list(_weight_leaves(params))
    cd = dtype_of(cfg.compute_dtype)

    def cast_all():
        for t in leaves:
            t.to(cd)
    cast_ms = time_ms(torch, cast_all, 3)
    cast_bytes = sum(t.numel() * (t.element_size() + cd.itemsize)
                     for t in leaves)
    out = dict(decode_step_host_return_s=host, decode_step_wall_s=wall,
               profiled_step_wall_s=prof_wall,
               profiled_device_kernels=len(spans),
               profiled_device_busy_s=(busy_us * 1e-6 if spans else None),
               profiled_cast_device_s=(cast_us * 1e-6 if spans else None),
               weight_cast_ms=cast_ms, weight_cast_bytes=cast_bytes,
               profiled_runtime_calls=calls)
    busy = ("not measured (the profiler saw no device kernel)" if not spans
            else f"{busy_us * 1e-3:.3f} ms busy on the card in "
                 f"{len(spans)} kernels and copies, casts "
                 f"{cast_us * 1e-3:.3f} ms of it")
    print(f"decode step (cuda): host returned after {host} s, card done "
          f"after {wall} s ({PROFILE_STEPS} steps); one step profiled: wall "
          f"{prof_wall * 1e3:.3f} ms, {busy}; the weight casts alone "
          f"{cast_ms:.3f} ms for {cast_bytes} bytes; runtime calls "
          f"{json.dumps(calls)}")
    return out


def routing_on_the_card(torch):
    """The repaired routing: a group with a keyed and a custom member,
    each bitwise its dedicated run, and a keyed custom statistic over
    B = 256, n = 2^24 - 1000 rows whose peak stays below one (B, n) f32
    weight matrix."""
    from repro_torch.core import (GroupedStatistic, Mean, MomentState,
                                  Statistic, StatisticGroup)
    from repro_torch.core.bootstrap import fused_resample_states
    from repro_torch.kernels.fused_multi.ops import (fused_poisson_multi,
                                                     fused_poisson_tiled)
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    class AbsSum(Statistic):
        """A user statistic with its own tile math: Σw and Σw|x|."""

        def init_state(self, dim, device="cpu"):
            z = torch.zeros(dim, device=device)
            return MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

        def update(self, state, values, weights=None):
            x = values.to(torch.float32)
            w = (torch.ones(x.shape[0], device=x.device) if weights is None
                 else weights)
            return MomentState(w=state.w + w.sum(), s1=state.s1 + w @ x.abs(),
                               s2=state.s2)

        def tile_update(self, states, x_tile, w_tile):
            return MomentState(w=states.w + w_tile.sum(dim=1),
                               s1=states.s1 + w_tile @ x_tile.abs(),
                               s2=states.s2)

        def finalize(self, state):
            return state.s1 / torch.clamp_min(state.w.unsqueeze(-1), 1.0)

    def keyed_rows(n, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(n, 1, generator=gen, device="cuda") * 2.0 + 10.0
        keys = torch.randint(0, ROUTE_G, (n, 1), generator=gen,
                             device="cuda").float()
        return torch.cat([x, keys], dim=1)

    vals = keyed_rows(ROUTE_GROUP_N, 1)
    keyed, custom = GroupedStatistic(Mean(), ROUTE_G), AbsSum()
    got = fused_poisson_multi(StatisticGroup((Mean(), keyed, custom)), 77,
                              vals, BIG_B)
    want = (fused_poisson_moments(77, vals, BIG_B),
            keyed.fused_poisson_states(77, vals, BIG_B),
            fused_poisson_tiled(custom, 77, vals, BIG_B))
    pairs = [(got[0].w, want[0][0]), (got[0].s1, want[0][1]),
             (got[0].s2, want[0][2]), (got[1].w, want[1].w),
             (got[1].s1, want[1].s1), (got[1].s2, want[1].s2),
             (got[2].w, want[2].w), (got[2].s1, want[2].s1)]
    check(all(bool((a == b).all()) for a, b in pairs),
          "a group member differs from its dedicated run")
    # the CPU's tiled scan (on the first 2^16 rows: the plain draw is
    # slow): weights bitwise, so w_tot; Σw|x| within 1e-5 of itself
    head = vals[:1 << 16]
    card = fused_poisson_tiled(custom, 77, head, BIG_B)
    cpu = fused_poisson_tiled(custom, 77, head.cpu(), BIG_B)
    check(bool((cpu.w == card.w.cpu()).all()),
          "the tiled scan's w_tot differs from its CPU run")
    check(bool(((cpu.s1 - card.s1.cpu()).abs() <= 1e-5 * cpu.s1).all()),
          "the tiled scan's Σw|x| is off its CPU run by more than 1e-5")
    del vals, got, want, head, card, cpu
    vals = keyed_rows(BOOT_N, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = fused_resample_states(GroupedStatistic(AbsSum(), ROUTE_G), 99, vals,
                               BIG_B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    bn_bytes = BIG_B * BOOT_N * 4
    check(st.w.shape == (BIG_B, ROUTE_G) and peak < bn_bytes,
          f"keyed custom statistic: peak {peak} B against a (B, n) matrix "
          f"of {bn_bytes} B")
    print(f"routing (cuda): a group (Mean, GroupedStatistic(Mean, "
          f"{ROUTE_G}), custom) at B={BIG_B}, n={ROUTE_GROUP_N} is bitwise "
          f"its members' dedicated runs; a keyed custom statistic at "
          f"B={BIG_B}, n={BOOT_N}: {wall:.3f} s, peak {peak} B above the "
          f"data (a (B, n) f32 matrix is {bn_bytes} B)")
    return dict(keyed_custom_s=wall, keyed_custom_peak_bytes=peak)


def phase_serve_path(torch):
    """Phase 11: h2o-danube-3-4b at full width on the card, from zeroed
    launch counts with its geometries logged."""
    import dataclasses
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.data.pipeline import EvalSamplePipeline
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import (forward_hidden, init_params,
                                    logits_from_hidden, num_params)
    from repro_torch.train import EarlEval, make_eval_step

    cfg = get_config(SERVE_ARCH)
    zero_counts()
    info = {}
    with LaunchLog() as log:
        torch.cuda.synchronize()
        free0 = torch.cuda.memory_allocated()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SERVE_SEED), device="cuda")
        torch.cuda.synchronize()
        count, nbytes = num_params(params)
        check(count == cfg.num_params(), f"params {count} != the config's "
              f"{cfg.num_params()}")
        param_bytes = torch.cuda.memory_allocated() - free0
        print(f"serve: {cfg.name}: {count} parameters, {nbytes} bytes in "
              f"{cfg.param_dtype}; {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
              f"(padded {cfg.padded_vocab}), window {cfg.window}")
        docs = synthetic_tokens(SERVE_B, SERVE_PROMPT, cfg.vocab,
                                seed=SERVE_SEED)
        prompts = torch.from_numpy(docs).cuda()
        torch.cuda.reset_peak_memory_stats()
        steps, toks, t_pre, t_dec, n_pre, n_dec, cache = serve(
            torch, cfg, params, prompts, SERVE_GEN, SERVE_PROMPT + SERVE_GEN)
        peak = torch.cuda.max_memory_allocated() - param_bytes - free0
        scores = SERVE_B * cfg.n_heads * SERVE_PROMPT * SERVE_PROMPT * 4
        check(n_pre == cfg.n_layers and n_dec == 0,
              f"flash_attention launched {n_pre} times in the prefill and "
              f"{n_dec} in decode, expected {cfg.n_layers} and 0")
        check(peak < scores, f"serve peak {peak} B above the params, not "
              f"below one layer's score tensor ({scores} B)")
        check(all(bool(torch.isfinite(s[:, :cfg.vocab]).all())
                  for s in steps), "serve logits are not finite")
        info.update(prefill_s=t_pre, decode_s=t_dec,
                    decode_tokens_per_s=SERVE_B * SERVE_GEN / t_dec,
                    peak_above_params_bytes=peak, param_bytes=param_bytes)
        print(f"serve (cuda): {SERVE_B} x {SERVE_PROMPT} prompt tokens "
              f"prefilled in {t_pre:.3f} s ({n_pre} flash_attention "
              f"launches), {SERVE_GEN} greedy steps in {t_dec:.3f} s = "
              f"{SERVE_B * SERVE_GEN / t_dec:.1f} tokens/s; peak {peak} B "
              f"above the params (one layer's f32 scores: {scores} B)")
        info.update(profile_decode(torch, cfg, params, cache, toks[:, -1:],
                                   SERVE_PROMPT + SERVE_GEN))
        del cache

        # decode == teacher forcing: the prompt extended by the decoded
        # tokens, in one forward
        full = torch.cat([prompts, toks], dim=1)
        with torch.no_grad():
            h, _ = forward_hidden(cfg, params, full, mode="train")
            tf = logits_from_hidden(cfg, params,
                                    h[:, SERVE_PROMPT - 1:])[..., :cfg.vocab]
        del h
        dec = torch.stack([s[:, :cfg.vocab] for s in steps], dim=1)
        err = float((dec - tf).abs().max())
        tol = logits_tolerance(tf)
        check(err <= tol, f"decode vs teacher forcing: max |err| {err} over "
              f"{tol}")
        agree = float((dec.argmax(-1) == tf.argmax(-1)).float().mean())
        info.update(teacher_forcing_max_err=err, teacher_forcing_tol=tol,
                    teacher_forcing_argmax_agreement=agree)
        print(f"serve: decode == teacher forcing over {SERVE_GEN + 1} "
              f"positions: max |logit err| {err} (tolerance {tol}); "
              f"argmax agreement {agree}")
        del full, tf, dec, steps

        # card == CPU on the model cut to one layer
        one = dataclasses.replace(cfg, n_layers=1)
        p1 = {"embedding": params["embedding"],
              "final_norm": params["final_norm"],
              "groups": {"0": _tree_slice(params["groups"]["0"])}}
        p1_cpu = _tree_to(p1, "cpu")
        prompt1 = prompts[:1, :CPU_PROMPT]
        c_steps, c_toks, *_ = serve(torch, one, p1, prompt1, CPU_GEN,
                                    CPU_PROMPT + CPU_GEN)
        h_steps, h_toks, t_cpu, *_ = serve(
            torch, one, p1_cpu, prompt1.cpu(), CPU_GEN, CPU_PROMPT + CPU_GEN)
        c = torch.stack(c_steps).cpu()[..., :cfg.vocab]
        hh = torch.stack(h_steps)[..., :cfg.vocab]
        err = float((c - hh).abs().max())
        tol = logits_tolerance(hh)
        check(err <= tol, f"card vs CPU at one layer: max |err| {err} over "
              f"{tol}")
        check(torch.equal(c_toks.cpu(), h_toks), f"card vs CPU greedy "
              f"tokens differ: {c_toks.tolist()} vs {h_toks.tolist()}")
        info.update(card_vs_cpu_max_err=err, card_vs_cpu_tol=tol)
        print(f"serve: card == CPU at one layer (1 x {CPU_PROMPT} tokens, "
              f"{CPU_GEN} steps): max |logit err| {err} (tolerance {tol}), "
              f"greedy tokens equal {c_toks.tolist()}; CPU prefill "
              f"{t_cpu:.2f} s")
        del p1, p1_cpu

        # EarlEval at full width
        corpus = synthetic_tokens(EVAL_DOCS, EVAL_DOC_LEN, cfg.vocab,
                                  seed=SERVE_SEED + 1)
        pipe = EvalSamplePipeline(corpus, seq_len=EVAL_DOC_LEN - 1)
        n0 = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = EarlEval(make_eval_step(cfg), params, pipe, sigma=EVAL_SIGMA,
                       tau=EVAL_TAU, eval_batch=EVAL_BATCH).run(
            trandom.PRNGKey(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = res.history[-1]
        batches = -(-ev["model_forwards"] // EVAL_BATCH)
        check(ev["model_forwards"] < 0.5 * ev["full_pass_forwards"]
              and res.cv <= EVAL_SIGMA,
              f"EarlEval did not certify from under half the corpus: {ev}, "
              f"cv {res.cv}")
        check(flash_attention.launches - n0 == batches * cfg.n_layers,
              f"EarlEval launched flash_attention "
              f"{flash_attention.launches - n0} times for {batches} batches")
        est = float(torch.as_tensor(res.result).reshape(-1)[0])
        info.update(eval_forwards=ev["model_forwards"],
                    eval_full_pass=ev["full_pass_forwards"], eval_cv=res.cv,
                    eval_wall_s=wall, eval_estimate=est, eval_B=res.B,
                    eval_iterations=res.iterations)
        print(f"EarlEval (cuda): model_forwards={ev['model_forwards']} of "
              f"full_pass_forwards={ev['full_pass_forwards']}, B={res.B}, "
              f"iterations={res.iterations}, loss {est}, cv={res.cv}, wall "
              f"{wall:.2f} s")
        info.update(earl_eval_grows(torch, cfg, params, pipe, res.n_used))
        del params, pipe, res
        torch.cuda.empty_cache()

        info.update(routing_on_the_card(torch))
    launches = log.counts()
    for k in SERVE_KERNELS + ROUTING_KERNELS:
        check(launches[k] > 0, f"phase 11 launched no {k}")
    print(f"launches, the serving path: {json.dumps(launches)}")
    print("serve summary: " + json.dumps(info))
    return launches, log.geometries, info


class _LossRows:
    """A sampler over a vector of per-document losses: an EarlSession on
    the CPU fed the losses that the card's EarlEval computed."""

    def __init__(self, losses, N: int):
        self.losses, self.N = losses, N

    def take(self, start: int, stop: int):
        check(stop <= len(self.losses), f"the CPU session took rows up to "
              f"{stop}, past the {len(self.losses)} the card computed")
        return self.losses[start:stop]


def earl_eval_grows(torch, cfg, params, pipe, n_before: int) -> dict:
    """EarlEval at sigma EVAL_SIGMA_GROW, below the pilot's cv: the
    session must grow the sample past the n_before rows that the run at
    EVAL_SIGMA used (its pilot) and certify
    from under half the corpus; its estimate is held against the plain
    mean of the losses its forwards returned, and its B, rows, iterations
    and estimate against an EarlSession on the CPU fed those losses."""
    from repro_torch import random as trandom
    from repro_torch.core import EarlSession, Mean
    from repro_torch.train import EarlEval, make_eval_step
    eval_step = make_eval_step(cfg)
    recorded = []

    def recording_step(p, batch):
        out = eval_step(p, batch)
        recorded.append(out.to(torch.float32).cpu())
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = EarlEval(recording_step, params, pipe, sigma=EVAL_SIGMA_GROW,
                   tau=EVAL_TAU, eval_batch=EVAL_BATCH).run(
        trandom.PRNGKey(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = res.history[-1]
    losses = torch.cat(recorded)
    est = float(torch.as_tensor(res.result).reshape(-1)[0])
    check(not res.fell_back and res.n_used > n_before
          and res.cv <= EVAL_SIGMA_GROW
          and ev["model_forwards"] < 0.5 * ev["full_pass_forwards"],
          f"EarlEval at sigma {EVAL_SIGMA_GROW} did not grow past "
          f"{n_before} rows and certify from under half the "
          f"corpus: n_used {res.n_used}, {ev}, cv {res.cv}, fell back "
          f"{res.fell_back}")
    check(len(losses) == ev["model_forwards"] >= res.n_used,
          f"{len(losses)} losses recorded for {ev['model_forwards']} "
          f"forwards and {res.n_used} rows")
    x = losses[:res.n_used].double()
    plain = float(x.mean())
    tol = 1e-5 * float(x.abs().mean())
    check(abs(est - plain) <= tol, f"EarlEval's estimate {est} is not the "
          f"plain mean {plain} of its {res.n_used} losses (tolerance {tol})")
    cpu = EarlSession(_LossRows(losses, pipe.N), Mean(),
                      sigma=EVAL_SIGMA_GROW, tau=EVAL_TAU,
                      device="cpu").run(trandom.PRNGKey(0))
    cpu_est = float(torch.as_tensor(cpu.result).reshape(-1)[0])
    check((cpu.B, cpu.n_used, cpu.iterations, cpu.fell_back)
          == (res.B, res.n_used, res.iterations, res.fell_back)
          and abs(cpu_est - est) <= tol,
          f"the CPU session on the card's losses took B {cpu.B}, rows "
          f"{cpu.n_used}, {cpu.iterations} iterations, estimate {cpu_est}; "
          f"the card's EarlEval B {res.B}, rows {res.n_used}, "
          f"{res.iterations} iterations, estimate {est}")
    print(f"EarlEval (cuda, sigma {EVAL_SIGMA_GROW}): model_forwards="
          f"{ev['model_forwards']} of {ev['full_pass_forwards']}, B={res.B}, "
          f"n_used={res.n_used}, iterations={res.iterations}, loss {est} "
          f"(plain mean of its losses {plain}), cv={res.cv}, wall "
          f"{wall:.2f} s; the CPU session on the same losses agrees (B "
          f"{cpu.B}, n_used {cpu.n_used}, iterations {cpu.iterations}, "
          f"loss {cpu_est}, cv {cpu.cv})")
    return dict(grow_sigma=EVAL_SIGMA_GROW,
                grow_forwards=ev["model_forwards"], grow_n_used=res.n_used,
                grow_B=res.B, grow_iterations=res.iterations,
                grow_cv=res.cv, grow_estimate=est, grow_plain_mean=plain,
                grow_wall_s=wall, grow_history=res.history[:-1],
                grow_cpu_cv=cpu.cv)


def _tree_slice(tree):
    """Layer 0 of a stacked group of blocks, keeping the stacking axis."""
    if isinstance(tree, dict):
        return {k: _tree_slice(v) for k, v in tree.items()}
    return tree[:1]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def replay_attention(torch, parity, gen, fields, what) -> None:
    """One kernel 12 launch geometry on fresh data against the plain
    version."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = dict(fields)
    b = g["BHq"] // g["Hq"]
    dt = torch.float32 if g["dtype"] == 0 else torch.bfloat16
    q, k, v = fa_inputs(torch, (b, g["Hq"], g["Hkv"], g["Sq"], g["Skv"],
                                g["D"]), dt, gen)
    kw = dict(causal=bool(g["causal"]), window=g["window"] or None,
              kv_offset=g["kv_offset"], scale=1.0)
    with LaunchLog() as log:
        got = flash_attention(q, k, v, **kw)
    check(("flash_attention", fields) in log.geometries,
          f"{what}: launched {list(log.geometries)}")
    hold_attention(parity, got, q, k, v, kw, what)


def attention_pairs(S: int, W: int) -> int:
    """Visible (query, key) pairs of one head under the causal window."""
    W = min(W, S)
    return W * (W + 1) // 2 + (S - W) * W


def serve_rows(torch, launches, parity: Parity):
    """Kernel 12 at the serving prefill's shape: 4 x 32 query heads on 8
    KV heads, 8192 tokens, head_dim 120, window 4096, bf16."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = fa_inputs(torch, (FA_B, FA_HQ, FA_HKV, FA_S, FA_S, FA_D),
                        torch.bfloat16, gen)
    i = torch.arange(FA_S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - FA_W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(causal=True, window=FA_W, scale=FA_D ** -0.5)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, **kw), 5)
    plain_ms = time_ms(torch, lambda: plain(flash_attention_plain, q, k, v,
                                            **kw), 2)
    # the f32 route (CUDA cores, IEEE f32) at the same shape
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = time_ms(torch, lambda: flash_attention(q32, k32, v32, **kw), 2)
    del q32, k32, v32
    library_ms = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask,
                                             scale=FA_D ** -0.5,
                                             enable_gqa=True), 5)
    pairs = attention_pairs(FA_S, FA_W)
    # operations: QK^T and PV, 2·D each a visible pair; bytes: q, k, v and
    # o once each, in bf16
    flops = 4 * FA_D * pairs * FA_B * FA_HQ
    nbytes = 2 * (2 * FA_B * FA_HQ + 2 * FA_B * FA_HKV) * FA_S * FA_D
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    row = dict(name="flash_attention", route="cuda",
               source=SOURCES["flash_attention"],
               replaces=REPLACES["flash_attention"],
               launches=launches["flash_attention"],
               max_abs_err=parity.err["flash_attention"], ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms, f32_ms=f32_ms,
               shape=dict(B=FA_B, Hq=FA_HQ, Hkv=FA_HKV, S=FA_S, D=FA_D,
                          window=FA_W, dtype="bfloat16", pairs_per_head=pairs,
                          flops=flops, bytes=nbytes))
    print(f"flash_attention over phase 3 and the replay: max |err| "
          f"{parity.err['flash_attention']}, largest share of the bound "
          f"{json.dumps(parity.fa_share)}")
    print(f"timing flash_attention: {ms:.4f} ms in bf16 ({flops / ms / 1e9:.1f} "
          f"TFLOP/s of visible work; f32 route {f32_ms:.4f} ms; plain "
          f"{plain_ms:.2f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}: {pairs} visible "
          f"pairs a head, {flops} flops, {nbytes} bytes)")
    return [row]



def check_no_spills(log: str, kernel: str) -> None:
    """Every instance of ``kernel`` in a ptxas report spills 0 bytes (an
    empty report: the library was built before, nothing to read)."""
    entry, seen = None, 0
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.rsplit(" ", 1)[-1]
        elif "spill" in line and entry and kernel in entry:
            seen += 1
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"ptxas: {kernel} spills: {line.strip()}")
    check(seen > 0 or not log, f"ptxas reported no {kernel} instance")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    torch.manual_seed(0)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(REPLACES)} kernels from {len(_build.SIGNATURES)} "
          f"sources in {time.perf_counter() - t0:.1f} s")
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "wgmma")):
                print(f"ptxas {lib}: {line.split(':', 1)[-1].strip()}")
    check_no_spills(logs.get("flash_attention", ""), "attention_tc")
    check_no_spills(logs.get("fused_binblocked", ""), "binblocked_kernel")
    check_no_spills(logs.get("weighted_hist", ""), "hist_kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")

    def lap(phase):
        print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s")

    parity = Parity()
    phase_parity(torch, parity)
    phase_parity_kmeans(torch, parity)
    phase_parity_grouped(torch, parity)
    phase_parity_materialized(torch, parity)
    phase_parity_stream(torch, parity)
    phase_parity_attention(torch, parity)
    lap("3 (parity)")
    launches, geometries, quickstart = phase_main_path(torch)
    lap("4 (quickstart path)")
    km_launches, km_geometries = phase_kmeans_path(torch)
    lap("5 (k-means path)")
    gb_launches, gb_geometries, gb_walls = phase_groupby_path(torch)
    lap("6 (GROUP BY path)")
    earlier = {k: launches[k] + km_launches[k] + gb_launches[k]
               for k in launches}
    check(all(earlier[k] == v for k, v in EARLIER_LAUNCHES.items()),
          f"the earlier paths launched {earlier}, expected "
          f"{EARLIER_LAUNCHES}")
    check(all(earlier[k] == v for k, v in EARLIER_LATER_LAUNCHES.items()),
          f"the earlier paths launched {earlier}, expected "
          f"{EARLIER_LATER_LAUNCHES} of kernels 10, 11, 5 and 7")
    mat_launches, mat_geometries = phase_materialized_path(torch)
    lap("7 (materialized path)")
    check(all(mat_launches[k] == MATERIALIZED_LAUNCHES.get(k, 0)
              for k in mat_launches), f"the materialized path launched "
          f"{mat_launches}, expected {MATERIALIZED_LAUNCHES}")
    st_launches, st_geometries = phase_stream_path(torch)
    lap("10 (streaming path)")
    sv_launches, sv_geometries, _ = phase_serve_path(torch)
    lap("11 (serving path)")
    launches = {k: earlier[k] + mat_launches[k] + st_launches[k]
                + sv_launches[k] for k in launches}
    print(f"launches, the three earlier paths: {json.dumps(earlier)}; all "
          f"six: {json.dumps(launches)}")
    phase_replay(torch, {**geometries, **km_geometries, **gb_geometries,
                         **mat_geometries, **st_geometries,
                         **sv_geometries}, parity)
    lap("8 (replay)")
    rows = phase_timing(torch, launches, parity, quickstart)
    rows += groupby_rows(torch, launches, parity, gb_walls)
    rows += materialized_rows(torch, launches, parity)
    rows += stream_rows(torch, launches, parity)
    rows += serve_rows(torch, launches, parity)
    lap("9 (timing)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
