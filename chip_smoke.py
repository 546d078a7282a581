#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; it imports nothing of JAX or
of the JAX package.  Phases, each of which raises (exit code 1) on
failure:

1. build the four CUDA kernels from kernels/csrc (poisson_counts.cu and
   fused_pass.cu, which holds the three fused ones; one nvcc per source,
   all at once) and print the build seconds;
2. print the card's name and power limit (nvidia-smi);
3. hold every kernel against its plain PyTorch version on the card, at
   the session's shapes and at B=256, n=2^20+37, with and without a
   validity mask, and on the binning's edge values: weights, w_tot and
   histogram counts bitwise; s1 within 1e-5·Σw|x| and s2 within
   1e-5·Σw·x² per entry; group members bitwise equal to the dedicated
   kernels;
4. the main path, with every launch count set to 0 first and the
   geometry of every launch logged: the quickstart session
   (N = 2,000,000, StatisticGroup(Mean, Quantile(0.5), Std)), a Mean()
   and a Median() session, a bootstrap of a user statistic without a
   fused path (the materialized poisson_counts route), and the one-shot
   bootstrap of the group at B=256, n=2^24-1000; the quickstart session is
   run again on the CPU and must agree;
5. replay every distinct launch geometry that phase 4 logged (rows,
   columns, RNG tile, column ranges, mask, slots) on fresh data and hold
   it against the plain version as in phase 3;
6. time each kernel (CUDA events) beside its plain version and its bound,
   and the quickstart session's wall time over a few warm runs;
7. print the kernels line, then the contract's last line.

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

REPLACES = {
    "poisson_counts": "src/repro/kernels/poisson_counts/kernel.py:63",
    "fused_poisson_moments": "src/repro/kernels/weighted_stats/kernel.py:173",
    "fused_poisson_hist": "src/repro/kernels/weighted_hist/kernel.py:253",
    "fused_poisson_multi": "src/repro/kernels/fused_multi/kernel.py:107",
}
SOURCES = {
    "poisson_counts": "src/repro_torch/kernels/csrc/poisson_counts.cu",
    "fused_poisson_moments": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_hist": "src/repro_torch/kernels/csrc/fused_pass.cu",
    "fused_poisson_multi": "src/repro_torch/kernels/csrc/fused_pass.cu",
}
NBINS, LO, HI = 2048, 0.0, 25.0
QUICKSTART_N = 2_000_000
BIG_B, BIG_N = 256, (1 << 20) + 37
BOOT_N = (1 << 24) - 1000
SESSION_REPS = 5


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
            diff = (got[i] - want[i]).abs()
            self.err[name] = max(self.err[name], float(diff.max()))
            check(bool((diff <= 1e-5 * bound).all()),
                  f"{name} s{i} {what}: max |err| {float(diff.max())} over "
                  f"1e-5·Σw|x^{i}|")


def wrappers():
    """The four kernel wrappers, each with its ``launches`` count."""
    from repro_torch.kernels.fused_multi.ops import fused_poisson_multi
    from repro_torch.kernels.poisson_counts.ops import poisson_counts
    from repro_torch.kernels.weighted_hist.ops import fused_poisson_hist
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments
    return (poisson_counts, fused_poisson_moments, fused_poisson_hist,
            fused_poisson_multi)


def geometry(lib: str, args: tuple) -> tuple:
    """What a launch's result depends on besides its data, as sorted
    (field, value) pairs, from the arguments of ``earl_<lib>``."""
    if lib == "poisson_counts":
        _, Bp, np_, bb, bn, _, _ = args
        fields = dict(Bp=Bp, np_=np_, bb=bb, bn=bn)
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
        return {f.__name__: f.launches for f in wrappers()}

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
    for f in wrappers():
        f.launches = 0
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
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
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
        Bp, np_ = g["Bp"], g["np_"]
        what = f"replay of {count} main-path launch(es) at {g}"
        shapes.setdefault(name, []).append((Bp, np_))
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
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
          f"geometries match their plain versions; (Bp, np) per kernel "
          f"{json.dumps(shapes)}")


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
    _build.build_all()
    print(f"build: 4 kernels from {len(_build.SIGNATURES)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")

    parity = Parity()
    phase_parity(torch, parity)
    launches, geometries, quickstart = phase_main_path(torch)
    phase_replay(torch, geometries, parity)
    rows = phase_timing(torch, launches, parity, quickstart)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
