#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; it imports nothing of JAX or
of the JAX package.  Phases, each of which raises (exit code 1) on
failure:

1. build the eight CUDA kernels from kernels/csrc (poisson_counts.cu,
   fused_pass.cu, which holds the three fused ones, kmeans_assign.cu,
   fused_kmeans.cu and fused_grouped.cu, which holds the two GROUP BY
   ones; one nvcc per source, all at once) and print the build seconds;
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
   k-means) bitwise equal to the dedicated kernel masked to its key;
4. the quickstart path, with every launch count set to 0 first and the
   geometry of every launch logged: the quickstart session
   (N = 2,000,000, StatisticGroup(Mean, Quantile(0.5), Std)), a Mean()
   and a Median() session, a bootstrap of a user statistic without a
   fused path (the materialized poisson_counts route), and the one-shot
   bootstrap of the group at B=256, n=2^24-1000; the quickstart session is
   run again on the CPU and must agree;
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
   must stay below an (n, G) f32 tensor;
7. replay every distinct launch geometry that phases 4 to 6 logged on
   fresh data and hold it against the plain version as in phase 3;
8. time each kernel (CUDA events) beside its plain version and its bound,
   the sessions' wall times and the example's walls over a few warm runs,
   and the grouped moments kernel against G masked moments launches;
9. print the kernels line, then the contract's last line.

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
}
#: the kernels each main path must launch
QUICKSTART_KERNELS = ("poisson_counts", "fused_poisson_moments",
                      "fused_poisson_hist", "fused_poisson_multi")
KMEANS_KERNELS = ("kmeans_assign", "fused_poisson_kmeans")
GROUPBY_KERNELS = ("fused_poisson_moments_grouped",
                   "fused_poisson_hist_grouped")
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

    def kmeans(self, name, got, want, bound_sums, what):
        """got/want = (sums, counts, inertia); bound_sums = Σw|x| per dim
        (broadcast over clusters); inertia is held to 1e-5 of itself."""
        self.bitwise(name, got[1], want[1], f"counts {what}")
        self.within(name, got[0], want[0], bound_sums, f"sums {what}")
        self.within(name, got[2], want[2], want[2].abs(), f"inertia {what}")


def wrappers():
    """Each kernel's name and the function that counts its launches in
    ``launches``: the wrapper, or for the GROUP BY kernels the card path
    of the wrapper's keyed call."""
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.kmeans_assign.ops import (fused_poisson_kmeans,
                                                       kmeans_assign)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       grouped_hist_cuda)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, grouped_moments_cuda)
    return {"poisson_counts": poisson_counts,
            "fused_poisson_moments": fused_poisson_moments,
            "fused_poisson_hist": fused_poisson_hist,
            "fused_poisson_multi": fused_poisson_multi,
            "kmeans_assign": kmeans_assign,
            "fused_poisson_kmeans": fused_poisson_kmeans,
            "fused_poisson_moments_grouped": grouped_moments_cuda,
            "fused_poisson_hist_grouped": grouped_hist_cuda}


def zero_counts() -> None:
    for f in wrappers().values():
        f.launches = 0


def geometry(lib: str, args: tuple) -> tuple:
    """What a launch's result depends on besides its data, as sorted
    (field, value) pairs, from the arguments of ``earl_<lib>``."""
    if lib == "poisson_counts":
        _, Bp, np_, bb, bn, _, _ = args
        fields = dict(Bp=Bp, np_=np_, bb=bb, bn=bn)
    elif lib == "kmeans_assign":
        n, d, k, _, _, _, cols, ranges, threads, _, _, _ = args
        fields = dict(n=n, d=d, k=k, cols=cols, ranges=ranges,
                      threads=threads)
    elif lib == "fused_kmeans":
        (_, n_valid, Bp, np_, bb, bn, d, k, _, mask, _, tpc, ranges,
         _, _, _) = args
        fields = dict(n_valid=n_valid, Bp=Bp, np_=np_, bb=bb, bn=bn, d=d,
                      k=k, masked=mask is not None, tpc=tpc, ranges=ranges)
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
            w_p = poisson_weights_plain(seed, pr.Bp, pr.np_, pr.bb, pr.bn,
                                        device="cuda")[:B, :n]
            parity.bitwise("poisson_counts", w_k, w_p, f"weights {what}")

            mom_k = fused_poisson_moments(seed, x, B, n_valid=n_valid,
                                          valid_mask=mask)
            mom_p = [t[:B] for t in moments_plain(pr, seed)]
            abs_p = [t[:B] for t in moments_plain(
                prepare(x.abs(), B, n_valid=n_valid, valid_mask=mask), seed)]
            parity.moments("fused_poisson_moments", mom_k, mom_p, abs_p[1],
                           mom_p[2], what)

            lo = torch.full((1,), LO, device="cuda")
            hi = torch.full((1,), HI, device="cuda")
            h_k = fused_poisson_hist(seed, x, LO, HI, NBINS, B,
                                     n_valid=n_valid, valid_mask=mask)
            h_p = hist_plain(pr, seed, lo, hi, NBINS)[:B]
            parity.bitwise("fused_poisson_hist", h_k, h_p, f"counts {what}")

            g_k = fused_poisson_multi(group, seed, x, B, n_valid=n_valid,
                                      valid_mask=mask)
            g_p = _multi_scan(group.slots, seed, pr)
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
                   hist_plain(pr, seed, lo, hi, NBINS)[:8], "edge values")
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
    want = [t[:B] for t in fused_kmeans_plain(prepare(x, B, **kw), seed,
                                              cent)]
    bound = moments_plain(prepare(x.abs(), B, **kw), seed)[1][:B]
    parity.kmeans("fused_poisson_kmeans", got, want, bound[:, None, :],
                  what)


def hold_kmeans_assign(parity, x, w, cent, what) -> None:
    """kmeans_assign against its plain version under weights ``w``."""
    from repro_torch.kernels.kmeans_assign.ops import (assign_plain,
                                                       kmeans_assign)
    parity.kmeans("kmeans_assign", kmeans_assign(x, w, cent),
                  assign_plain(x, w, cent),
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
    want = [t[:B] for t in grouped_moments_plain(pr, seed)]
    bound = grouped_moments_plain(prepare(x.abs(), B, **kw), seed)[1][:B]
    parity.moments("fused_poisson_moments_grouped", got, want, bound,
                   want[2], what)
    lo = torch.full((d,), LO, device="cuda")
    hi = torch.full((d,), HI, device="cuda")
    h = fused_poisson_hist(seed, x, LO, HI, nbins, B, **kw)
    parity.bitwise("fused_poisson_hist_grouped", h,
                   grouped_hist_plain(pr, seed, lo, hi, nbins)[:B],
                   f"counts {what}")
    cent = x[:KM_K].contiguous()
    km = fused_poisson_kmeans(seed, x, cent, B, **kw)
    if kmeans_plain:
        wk = [t[:B] for t in grouped_kmeans_plain(pr, seed, cent)]
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
                              group, sigma=0.05, device=device)
        return session.run(trandom.PRNGKey(0))

    def single(stat):
        store = ShardedStore.from_array(data, split_size=65_536)
        return EarlSession(PreMapSampler(store, seed=1), stat,
                           sigma=0.05).run(trandom.PRNGKey(0))

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
        rms = bootstrap(xs, RMS(), 64, trandom.PRNGKey(3))

        group = StatisticGroup((Mean(), Quantile(0.5, lo=LO, hi=HI), Std()))
        key = trandom.PRNGKey(5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        big = bootstrap(xb, group, BIG_B, key)
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
                     device=device)
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
        big = bootstrap(xb, KMeansStep(cb), BIG_B, trandom.PRNGKey(11))
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
        sigma=0.05, device=device)
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
                        trandom.PRNGKey(13))
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


def phase_replay(torch, geometries, parity: Parity) -> None:
    """Holds every kernel against its plain version at each launch
    geometry of the main path, on fresh data: x is uniform on [LO, HI), so
    x >= 0 and the plain s1 is Σw|x|."""
    from repro_torch.core.reduce_api import (Mean, MomentState, Quantile,
                                             StatisticGroup, Std)
    from repro_torch.kernels.fused_multi.ops import (_multi_scan,
                                                     fused_poisson_multi)
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.poisson_counts.ref import poisson_weights_plain
    from repro_torch.kernels.weighted_hist.ops import (fused_poisson_hist,
                                                       hist_plain)
    from repro_torch.kernels.weighted_stats.ops import (
        fused_poisson_moments, moments_plain, prepare)

    gen = torch.Generator().manual_seed(13)
    lo = torch.full((1,), LO, device="cuda")
    hi = torch.full((1,), HI, device="cuda")
    shapes = {}
    for (name, fields), count in sorted(geometries.items(), key=str):
        g = dict(fields)
        Bp, np_ = g.get("Bp"), g.get("np_")
        what = f"replay of {count} main-path launch(es) at {g}"
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
        if name == "poisson_counts":
            with LaunchLog() as log:
                w_k = poisson_counts(seed, Bp, np_, device="cuda")
            check((name, fields) in log.geometries, f"{what}: launched "
                  f"{list(log.geometries)}")
            parity.bitwise(name, w_k, poisson_weights_plain(
                seed, Bp, np_, g["bb"], g["bn"], device="cuda"), what)
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
            want = moments_plain(pr, seed)
            parity.moments(name, mom_k, want, want[1], want[2], what)
        elif name == "fused_poisson_hist":
            parity.bitwise(name, h_k, hist_plain(pr, seed, lo, hi, nbins),
                           what)
        else:
            for sk, sp in zip(g_k, _multi_scan(group.slots, seed, pr)):
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
          f"geometries match their plain versions; (Bp, np), or (n, k, d) "
          f"for kmeans_assign, per kernel {json.dumps(shapes)}")


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
        want = grouped_moments_plain(pr, seed)
        parity.moments(name, got, want, want[1], want[2], what)
    else:
        lo = torch.full((d,), LO, device="cuda")
        hi = torch.full((d,), HI, device="cuda")
        parity.bitwise(name, got, grouped_hist_plain(pr, seed, lo, hi,
                                                     g["nbins"]), what)


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
            lambda: assign_plain(x, w, cent), a_bytes / HBM_BYTES_PER_S,
            a_flops / F32_FLOPS_PER_S, dict(n=KM_N, k=k, d=d)),
        "fused_poisson_kmeans": (
            lambda: fused_poisson_kmeans(seed, xb, cb, B),
            lambda: fused_kmeans_plain(pr, seed, cb),
            f_bytes / HBM_BYTES_PER_S,
            max(B * KM_BOOT_N * OPS_PER_WEIGHT / INT32_OPS_PER_S,
                B * KM_BOOT_N * entries * 2 / F32_FLOPS_PER_S),
            dict(B=B, n=KM_BOOT_N, k=k, d=d)),
    }
    rows = []
    for name, (kernel, plain, t_bytes, t_ops, shape) in runs.items():
        ms = time_ms(torch, kernel, 20 if name == "kmeans_assign" else 5)
        plain_ms = time_ms(torch, plain, 1)
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
            lambda: grouped_moments_plain(pr, seed),
            in_bytes + B * G * (2 * d + 1) * 4, max(t_hash, t_fma)),
        "fused_poisson_hist_grouped": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B, **kw),
            lambda: grouped_hist_plain(pr, seed, lo, hi, NBINS),
            in_bytes + B * G * d * NBINS * 4, t_hash),
    }
    rows = []
    for name, (kernel, plain, nbytes, t_ops) in runs.items():
        ms = time_ms(torch, kernel, 5)
        plain_ms = time_ms(torch, plain, 1)
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
            lambda: poisson_weights_plain(seed, pr.Bp, pr.np_, pr.bb, pr.bn,
                                          device="cuda"),
            B * n * 4),
        "fused_poisson_moments": (
            lambda: fused_poisson_moments(seed, x, B),
            lambda: moments_plain(pr, seed), x_bytes + 3 * B * 4),
        "fused_poisson_hist": (
            lambda: fused_poisson_hist(seed, x, LO, HI, NBINS, B),
            lambda: hist_plain(pr, seed, lo, hi, NBINS),
            x_bytes + B * NBINS * 4),
        "fused_poisson_multi": (
            lambda: fused_poisson_multi(group, seed, x, B),
            lambda: _multi_scan(group.slots, seed, pr),
            x_bytes + 3 * B * 4 + B * NBINS * 4),
    }
    rows = []
    for name, (kernel, plain, out_bytes) in runs.items():
        ms = time_ms(torch, kernel, 5)
        plain_ms = time_ms(torch, plain, 1)
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
                                       "spill")):
                print(f"ptxas {lib}: {line.split(':', 1)[-1].strip()}")
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
    lap("3 (parity)")
    launches, geometries, quickstart = phase_main_path(torch)
    lap("4 (quickstart path)")
    km_launches, km_geometries = phase_kmeans_path(torch)
    lap("5 (k-means path)")
    gb_launches, gb_geometries, gb_walls = phase_groupby_path(torch)
    lap("6 (GROUP BY path)")
    launches = {k: launches[k] + km_launches[k] + gb_launches[k]
                for k in launches}
    phase_replay(torch, {**geometries, **km_geometries, **gb_geometries},
                 parity)
    lap("7 (replay)")
    rows = phase_timing(torch, launches, parity, quickstart)
    rows += groupby_rows(torch, launches, parity, gb_walls)
    lap("8 (timing)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
