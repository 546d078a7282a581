#!/usr/bin/env python3
"""Times kernels 8 (fused_kmeans.cu) and 6 (grouped_moments_kernel in
fused_grouped.cu) alone, in knock-outs and at other geometries, with
kernel 2 beside them.

    python3 probe_slots.py [--root CHECKOUT] [--label L] [--out FILE]
                           [--kernel9 | --attention | --attention-bwd |
                            --lse-parent PARENT]

Needs one CUDA card and nvcc, and chip_smoke.py beside this script, whose
timers and data it uses.  ``--root`` is the checkout whose src/repro_torch
is measured (default: this one), so one call can time two commits in
turns.  Each variant's kernel sources are copied under
``<root>/build/probe/`` and edited as the checkout's design in KNOCKOUTS
says (every edit must match its source, or the run fails), built with the
port's nvcc flags (ptxas's registers and spills are printed for every
instance) and swapped into the wrapper, which runs unchanged but for the
geometry knob KNOBS sets.  A knock-out's outputs are wrong by design and
are never compared.

Each time is chip_smoke.launch_ms (back-to-back launches inside one
wrapper call; 200 where one takes under 0.1 ms); ``call`` is the
wrapper's own time a call.  Then, with the base kernels: the B = 256,
n = 2^22 k-means bootstrap, the keyed Mean bootstrap at B = 256,
n = 2^24 - 1000, and the grouped kernel against G masked kernel-2
launches at chip_smoke's GB_RATIO_SHAPE.  Prints one JSON object as its
last line, and writes it to ``--out`` when given.

``--kernel9`` times kernel 9 (kmeans_assign.cu) instead, at the k-means
path's shape (n = 400,000, k = 5, d = 2, no weights, as kmeans_fit calls
it, and unit weights): a call, the kernel alone, the host's time to
return from a call, and one window of calls under torch.profiler: the
card's time of each kernel it ran and the host's time in each operation,
with the wrapper's launch (``_build.launch``) and the whole call as
spans of their own; then, for the register design, its variants alone
in two turns (K9_KNOCKOUTS, K9_KNOBS).

``--attention`` times kernel 12's bf16 route past head dim 128 alone at
chip_smoke.py's wide-head shapes, its K/V tiling against the other that
fits in shared memory (K12_KNOCKOUTS), in turns.

``--attention-bwd`` times kernel 12's backward on the tensor cores (bf16
up to head dim 128) alone at phase 18's granite-3-2b shape and the other
train-mode shapes of 4,096 tokens and more, its tiling against the
others (K12B_KNOCKOUTS: query tiles of 64 rows, key tiles of 128, rings
of one stage), in turns, with scaled_dot_product_attention's backward on
the same inputs; at head dims past 128 (the CUDA-core route) it times
the kernel alone.

``--lse-parent PARENT`` builds kernel 12 and its backward from PARENT's
source too (a checkout from the training slice on) and holds this
checkout's kernel, launched with a null ``lse`` and with one, and its
lse, bitwise against the parent's at chip_smoke.py's FA_CASES and
FA_WIDE_CASES in f32 and bf16 and at the serving prefill's shape in
bf16, and the backward's CUDA-core route (f32, and bf16 past head dim
128) bitwise PARENT's at tests/test_torch_cuda.py's FA_BWD_CASES.
"""
import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

#: (B, n, k, d) of kernel 8: the kernel table's bootstrap, the example's
#: 2% sample, the wide case
KMEANS_SHAPES = [(256, 1 << 22, 5, 2), (24, 8_000, 5, 2),
                 (256, (1 << 20) + 37, 16, 8)]
#: (B, n, G, d) of kernel 6: the kernel table's shape, one key, 32 keys,
#: G·(2d+1) = 144 > 128, and the grouped-against-masked shape
GROUPED_SHAPES = [(256, (1 << 20) + 37, 8, 1), (256, (1 << 20) + 37, 1, 1),
                  (256, (1 << 20) + 37, 32, 1), (256, (1 << 20) + 37, 16, 4),
                  (256, 65_536, 8, 4)]
_SLOT_ACC_K6 = (
    "#pragma unroll\n"
    "      for (int r = 0; r < R; ++r) {\n"
    "        float& aw = slot(r, ONE ? 0 : kk, 0);\n"
    "        aw = __fadd_rn(aw, w[r]);\n"
    "#pragma unroll\n"
    "        for (int q = 0; q < DC; ++q) {\n"
    "          float& a1 = slot(r, ONE ? 0 : kk, 1 + q);\n"
    "          float& a2 = slot(r, ONE ? 0 : kk, 1 + DC + q);\n"
    "          a1 = __fmaf_rn(w[r], xv[q], a1);\n"
    "          a2 = __fmaf_rn(w[r], x2[q], a2);\n"
    "        }\n"
    "      }")
_SLOT_ACC_K8 = (
    "      float* s = slots + kk * S * kThreads + threadIdx.x;\n"
    "#pragma unroll\n"
    "      for (int r = 0; r < R; ++r) {\n"
    "        float* sr = s + r * row_slots * kThreads;\n"
    "#pragma unroll\n"
    "        for (int q = 0; q < DC; ++q) {\n"
    "          sr[q * kThreads] = __fmaf_rn(w[r], xv[q], sr[q * kThreads]);\n"
    "        }\n"
    "        if (lead) {\n"
    "          float* cnt = sr + DC * kThreads;\n"
    "          *cnt = __fadd_rn(*cnt, w[r]);\n"
    "          inertia[r] = __fmaf_rn(w[r], best, inertia[r]);\n"
    "        }\n"
    "      }")
_NOHASH = [("poisson_tile.cuh",
            "  threefry2x32(key.k0, key.k1, x0, x1);\n"
            "  float w = poisson_from_bits(x0 ^ x1);",
            "  float w = 1.f;")]
#: design -> variant -> [(file, old text, new text)].  "slots" is this
#: design (csrc/slot_tile.cuh); "registers" is the one before it (commit
#: ff78254), whose knock-outs PERF.md records as the parent's.
#: nohash: every implicit weight is 1; noacc: the weights and values are
#: formed but folded into one accumulator; nonearest: the assignment is
#: column & 3 with min-d² = x_0; nonote: no notes of non-finite values;
#: rangesx: column ranges on grid x, as in kernel 2; regs48: candidate (a)
#: for kernel 6, 48 register accumulators and three CTAs an SM.
KNOCKOUTS = {
    "slots": {
        "nohash": _NOHASH,
        "noacc": [
            ("fused_kmeans.cu", _SLOT_ACC_K8,
             "      float ws = xv[0] + best;\n"
             "#pragma unroll\n"
             "      for (int r = 0; r < R; ++r) ws += w[r];\n"
             "      slots[kk * S * kThreads + threadIdx.x] += ws;"),
            ("fused_grouped.cu", _SLOT_ACC_K6,
             "      float ws = xv[0] + x2[0];\n"
             "#pragma unroll\n"
             "      for (int r = 0; r < R; ++r) ws += w[r];\n"
             "      slot(0, ONE ? 0 : kk, 0) += ws;")],
        "nonote": [("fused_grouped.cu", "      if (!ONE && !finite) {",
                    "      if (false) {")],
        "rangesx": [
            (f, "  const int r0 = blockIdx.x * R;\n"
                "  const int range = blockIdx.y;",
             "  const int r0 = blockIdx.y * R;\n"
             "  const int range = blockIdx.x;")
            for f in ("fused_kmeans.cu", "fused_grouped.cu")] + [
            (f, "  dim3 grid((p.Bp + R - 1) / R, p.ranges, zdim);",
             "  dim3 grid(p.ranges, (p.Bp + R - 1) / R, zdim);")
            for f in ("fused_kmeans.cu", "fused_grouped.cu")],
    },
    "registers": {
        "nohash": _NOHASH,
        "noacc": [
            ("fused_kmeans.cu",
             "          acc[r][e] = __fmaf_rn(w[r], v[e], acc[r][e]);",
             "          if (e == 0) acc[r][0] = __fadd_rn(acc[r][0], w[r]);\n"
             "          else if (r == 0) acc[0][e] = __fadd_rn(acc[0][e], "
             "v[e]);"),
            ("fused_grouped.cu",
             "          const float wg = hit ? w[r] : 0.f;\n"
             "          acc_w[r][k] = __fadd_rn(acc_w[r][k], wg);\n"
             "#pragma unroll\n"
             "          for (int q = 0; q < DC; ++q) {\n"
             "            acc_s1[r][k][q] = __fmaf_rn(wg, xv[q], "
             "acc_s1[r][k][q]);\n"
             "            acc_s2[r][k][q] = __fmaf_rn(wg, x2[q], "
             "acc_s2[r][k][q]);\n"
             "          }",
             "          if (k == 0) acc_w[r][0] = __fadd_rn(acc_w[r][0], "
             "hit ? w[r] : xv[0]);")],
        "nonearest": [
            ("fused_kmeans.cu",
             "      const int jstar = nearest(xr, c_s, cc_s, p.d, p.k, best);",
             "      const int jstar = c & 3;\n      best = xr[0];")],
        "regs48": [
            ("fused_grouped.cu", "constexpr int kGroupedAccs = 128;",
             "constexpr int kGroupedAccs = 48;"),
            # at least one row in the instances G = 1 and 8 never launch
            ("fused_grouped.cu",
             "                                   ? kGroupedAccs / kEntries\n",
             "                                   ? (kGroupedAccs < kEntries ? 1"
             " : kGroupedAccs / kEntries)\n"),
            ("fused_grouped.cu",
             "template <int DC, int KG>\n__global__ void "
             "__launch_bounds__(kThreads)\ngrouped_moments_kernel",
             "template <int DC, int KG>\n__global__ void "
             "__launch_bounds__(kThreads, 3)\ngrouped_moments_kernel")],
    },
}
PASS = "repro_torch.kernels._pass"
KMEANS = "repro_torch.kernels.kmeans_assign.ops"
#: design -> variant -> (module, attribute, new value from the old one),
#: set while the variant is timed, with the base library
KNOBS = {
    "slots": {
        "ctas2": (PASS, "SLOT_CTAS", lambda _: 2),
        "ctas4": (PASS, "SLOT_CTAS", lambda _: 4),
        "slots48": (PASS, "SLOT_FLOATS", lambda _: 48),
        "dc2": (PASS, "dim_chunk", lambda f: lambda d: min(2, f(d))),
        "pass": (KMEANS, "ASSIGN_IN_PLACE", lambda _: 0),
        "inplace": (KMEANS, "ASSIGN_IN_PLACE", lambda _: 1 << 62)},
    "registers": {"regs48": (PASS, "GROUPED_ACCS", lambda _: 48)},
}
#: design -> library -> the variants timed
VARIANTS = {
    "slots": {"fused_kmeans": ("base", "nohash", "noacc", "ctas2", "ctas4",
                               "pass", "inplace", "rangesx"),
              "fused_grouped": ("base", "nohash", "noacc", "nonote",
                                "ctas2", "ctas4", "slots48", "dc2",
                                "rangesx"),
              "fused_pass": ("base",)},
    "registers": {"fused_kmeans": ("base", "nohash", "noacc", "nonearest"),
                  "fused_grouped": ("base", "nohash", "noacc", "regs48"),
                  "fused_pass": ("base",)},
}
#: variant -> the kernel 6 shapes (G, d) it is timed at (default: all)
ONLY = {"regs48": ((8, 1), (1, 1)), "slots48": ((8, 4), (16, 4)),
        "dc2": ((8, 4), (16, 4))}
REPS = {"fused_kmeans": 5, "fused_grouped": 10, "fused_pass": 10}
#: launches back to back at least, where one takes under 0.1 ms
SMALL_REPS = 200


def ptxas_report(log: str):
    """[function, registers, spill line] of every kernel in a report."""
    out, entry = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.rsplit(" ", 1)[-1]
        elif "spill" in line and entry:
            out.append([entry, None, line.split(":", 1)[-1].strip()])
        elif "Used" in line and "registers" in line and out:
            m = re.search(r"Used (\d+) registers", line)
            out[-1][1] = int(m.group(1)) if m else None
    return out


def start_build(_build, csrc: Path, name: str, variant: str, edits,
                work: Path):
    """Copy ``csrc`` with ``edits`` (each must match) and start nvcc on
    ``name``.cu; returns (process, library path)."""
    src = work / f"{name}-{variant}"
    shutil.copytree(csrc, src)
    (src / "poisson_cdf.h").write_text(_build.cdf_header())
    for fname, old, new in edits:
        f = src / fname
        text = f.read_text()
        if old not in text:
            raise RuntimeError(f"knock-out text not in {fname}: {old[:60]!r}")
        f.write_text(text.replace(old, new))
    lib = src / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
           str(lib), str(src / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


#: calls a kernel 9 timing averages over, and calls in its profiled window
K9_REPS, K9_PROFILED = 200, 20
_K9_FOLD = (
    "    if (j < k) {  // uniform: the slots past k stay 0\n"
    "      const float wj = j == js ? wv : 0.f;\n"
    "#pragma unroll\n"
    "      for (int q = 0; q < D; ++q) {\n"
    "        acc[j * D + q] = __fmaf_rn(wj, xr[q], acc[j * D + q]);\n"
    "      }\n"
    "      acc[KM * D + j] = __fadd_rn(acc[KM * D + j], wj);\n"
    "    }\n"
    "  }\n"
    "  acc[KM * (D + 1)] = __fmaf_rn(wv, best, acc[KM * (D + 1)]);\n")
#: kernel 9's variants of the register layout (csrc/kmeans_assign.cu,
#: assign_regs), as [(file, old text, new text)]: notes: a point adds into
#: its own cluster only (predicated selects) and a thread notes its
#: non-finite values per dimension and poisons the other clusters before
#: the block sums (PoisonNote, as the slot kernels do); nofold: the loads
#: and sums without the assignment; nosync: no ticket and no sum across
#: CTAs; nofinish: the ticket, but the last CTA sums nothing.
K9_KNOCKOUTS = {
    "notes": [
        ("kmeans_assign.cu", _K9_FOLD,
         "    if (j < k) {\n"
         "      const bool hit = j == js;\n"
         "#pragma unroll\n"
         "      for (int q = 0; q < D; ++q) {\n"
         "        float& a = acc[j * D + q];\n"
         "        a = hit ? __fmaf_rn(wv, xr[q], a) : a;\n"
         "      }\n"
         "      float& cnt = acc[KM * D + j];\n"
         "      cnt = hit ? __fadd_rn(cnt, wv) : cnt;\n"
         "    }\n"
         "  }\n"
         "  acc[KM * (D + 1)] = __fmaf_rn(wv, best, acc[KM * (D + 1)]);\n"
         "#pragma unroll\n"
         "  for (int q = 0; q < D; ++q) {\n"
         "    if (!isfinite(xr[q])) nf[q].note(js);\n"
         "  }\n"),
        ("kmeans_assign.cu",
         "    int k, float (&acc)[KM * (D + 1) + 1]) {",
         "    int k, float (&acc)[KM * (D + 1) + 1], "
         "earl::PoisonNote (&nf)[D]) {"),
        ("kmeans_assign.cu",
         "        fold_point<D, KM>(xs[b] + u * D, ws[b][u], c, cc, p.k, "
         "acc);",
         "        fold_point<D, KM>(xs[b] + u * D, ws[b][u], c, cc, p.k, "
         "acc, nf);"),
        ("kmeans_assign.cu",
         "  for (int e = 0; e < E; ++e) acc[e] = 0.f;\n",
         "  for (int e = 0; e < E; ++e) acc[e] = 0.f;\n"
         "  earl::PoisonNote nf[D];\n"),
        ("kmeans_assign.cu",
         "  // block sums: 32 entries a butterfly, then the warps in order\n",
         "  bool noted = false;\n"
         "#pragma unroll\n"
         "  for (int q = 0; q < D; ++q) noted = noted || nf[q].any();\n"
         "  if (noted) {\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < KM; ++j) {\n"
         "#pragma unroll\n"
         "      for (int q = 0; q < D; ++q) {\n"
         "        if (nf[q].poisons(j)) acc[j * D + q] = "
         "earl::poison_nan();\n"
         "      }\n"
         "    }\n"
         "  }\n"
         "  // block sums: 32 entries a butterfly, then the warps in order\n")],
    "nofold": [
        ("kmeans_assign.cu",
         "        fold_point<D, KM>(xs[b] + u * D, ws[b][u], c, cc, p.k, "
         "acc);",
         "        acc[u] += ws[b][u] + xs[b][u * D];")],
    "nosync": [
        ("kmeans_assign.cu",
         "    p.part[static_cast<int64_t>(blockIdx.x) * entries + o] = total;\n"
         "  }\n"
         "  finish(p, entries);",
         "    p.part[static_cast<int64_t>(blockIdx.x) * entries + o] = total;\n"
         "  }")],
    "nofinish": [("kmeans_assign.cu", "  if (!last) return;",
                  "  if (true) return;")],
}
#: kernel 12's bf16 tiling past head dim 128 (csrc/flash_attention.cu):
#: tiles128, 128-key K/V tiles in one stage in place of 64-key tiles in
#: two (the same shared bytes)
K12_KNOCKOUTS = {"tiles128": [
    ("flash_attention.cu",
     "  return D <= 192 ? EARL_TC(192, 64, 2) : EARL_TC(256, 64, 2);",
     "  return D <= 192 ? EARL_TC(192, 128, 1) : EARL_TC(256, 128, 1);")]}
#: (case, query heads, KV heads, head dim, window) at chip_smoke.py's
#: FA_B requests of FA_S tokens: gemma3-27b's local and global layers and
#: recurrentgemma-2b's local layers
K12_SHAPES = [("gemma3_local", cs.GEMMA_HQ, cs.GEMMA_HKV, cs.GEMMA_D,
               cs.GEMMA_W),
              ("gemma3_global", cs.GEMMA_HQ, cs.GEMMA_HKV, cs.GEMMA_D, None),
              ("recurrentgemma_local", cs.RG_HQ, cs.RG_HKV, cs.RG_D,
               cs.RG_W)]
K12_REPS = 10
#: kernel 12's backward on the tensor cores (csrc/flash_attention_bwd.cu,
#: launch_tc), its other tilings: bq64, query tiles of 64 rows in the
#: dK/dV pass at head dim 64; bn128, key tiles of 128 in the dQ pass at
#: head dim 64; bq64bn128, both (the first tiling timed); stages1, rings
#: of one stage in both passes at both head dims
_K12B_BASE = ("  return D <= 64 ? EARL_TC_BWD(64, 128, 64, 2) : "
              "EARL_TC_BWD(128, 64, 64, 2);")
K12B_KNOCKOUTS = {
    v: [("flash_attention_bwd.cu", _K12B_BASE,
         f"  return D <= 64 ? EARL_TC_BWD({lo}) : EARL_TC_BWD({hi});")]
    for v, lo, hi in (("bq64", "64, 64, 64, 2", "128, 64, 64, 2"),
                      ("bn128", "64, 128, 128, 2", "128, 64, 64, 2"),
                      ("bq64bn128", "64, 64, 128, 2", "128, 64, 64, 2"),
                      ("stages1", "64, 128, 64, 1", "128, 64, 64, 1"))}
#: (case, (b, hq, hkv, sq, skv, d), kwargs): phase 18's granite-3-2b
#: step and chip_smoke.py's BWD_CASES at 4,096 tokens and more, whose
#: head dims past 128 (gemma3-27b's, recurrentgemma-2b's) run the
#: CUDA-core route, timed alone without variants
K12B_SHAPES = [("granite_train", (cs.TRAIN_B, 32, 8, cs.TRAIN_S, cs.TRAIN_S,
                                  64), dict(causal=True))] + [
    (n, s, kw) for n, s, kw in cs.BWD_CASES if s[3] >= 4096]
K12B_REPS = 5
#: kernel 9's geometry knobs: points a thread at the least (ranges 391,
#: 196 and 66 at n = 400,000, against 131)
K9_KNOBS = {f"points{v}": (KMEANS, "REG_POINTS", lambda _, v=v: v)
            for v in (4, 8, 24)}
K9_VARIANTS = ("base", "notes", "nofold", "nosync", "nofinish", "points4",
               "points8", "points24")


def probe_kernel9(torch, root: Path, label: str) -> dict:
    """Kernel 9 at the k-means path's shape: ms a call and alone, the
    host's return, and where one call's time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import ops as tka
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    logs = _build.build_all(["kmeans_assign"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    x, cent = cs.km_data(torch, cs.KM_N, cs.KM_K, 2, seed=5)
    ones = torch.ones(cs.KM_N, device="cuda")
    result = dict(label=label, root=str(root), device=smi,
                  ptxas=ptxas_report(logs.get("kmeans_assign", "")),
                  n=cs.KM_N, k=cs.KM_K, d=2, variants={})
    # the register design's variants, alone, in turns with the base
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    if "assign_regs" in (csrc / "kmeans_assign.cu").read_text():
        work = root / "build" / "probe9"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        started = {v: start_build(_build, csrc, "kmeans_assign", v, e, work)
                   for v, e in K9_KNOCKOUTS.items()}
        base = _build.library("kmeans_assign")
        libs = {}
        for v, (proc, lib) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(out, file=sys.stderr)
                raise RuntimeError(f"nvcc failed for kmeans_assign-{v}")
            libs[v] = ctypes.CDLL(str(lib))
            fn = libs[v].earl_kmeans_assign
            fn.argtypes = list(_build.SIGNATURES["kmeans_assign"])
            fn.restype = ctypes.c_int
            result["variants"][f"ptxas_{v}"] = ptxas_report(out)
        fn = lambda: kmeans_assign(x, None, cent)  # noqa: E731
        for turn in range(2):
            for v in K9_VARIANTS:
                _build._LOADED["kmeans_assign"] = libs.get(v, base)
                knob = K9_KNOBS.get(v)
                if knob:
                    module = importlib.import_module(knob[0])
                    before = getattr(module, knob[1])
                    setattr(module, knob[1], knob[2](before))
                tka.assign_geometry.cache_clear()
                try:
                    t = cs.launch_ms(torch, fn, "kmeans_assign", K9_REPS)
                finally:
                    _build._LOADED["kmeans_assign"] = base
                    if knob:
                        setattr(module, knob[1], before)
                    tka.assign_geometry.cache_clear()
                    torch.cuda.synchronize()
                    for ticket, _ in tka._SCRATCH.values():
                        ticket.zero_()
                result["variants"].setdefault(v, []).append(t)
        print(f"kernel 9 variants, alone, two turns (ms): "
              f"{json.dumps({v: result['variants'][v] for v in K9_VARIANTS})}")
    for name, w in (("no_weights", None), ("unit_weights", ones)):
        fn = lambda: kmeans_assign(x, w, cent)  # noqa: E731
        call = cs.time_ms(torch, fn, K9_REPS)
        alone = cs.launch_ms(torch, fn, "kmeans_assign", K9_REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K9_REPS):
            fn()
        host = (time.perf_counter() - t0) / K9_REPS * 1e3
        torch.cuda.synchronize()
        launch = _build.launch

        def spanned(lib, *a):
            with record_function("earl_launch"):
                return launch(lib, *a)
        _build.launch = spanned
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(K9_PROFILED):
                    with record_function("kmeans_assign_call"):
                        fn()
                torch.cuda.synchronize()
        finally:
            _build.launch = launch
        ops = sorted(({"key": r.key, "count": r.count,
                       "cpu_us_a_call": r.cpu_time_total / K9_PROFILED,
                       "self_cpu_us_a_call":
                           r.self_cpu_time_total / K9_PROFILED,
                       "device_us_a_call":
                           r.device_time_total / K9_PROFILED}
                      for r in prof.key_averages()),
                     key=lambda r: -r["cpu_us_a_call"])
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(e.name, [0, 0.0])
                k[0] += 1
                k[1] += e.time_range.end - e.time_range.start
        result[name] = dict(
            call_ms=call, alone_ms=alone, host_return_ms=host,
            profiled_ops=ops[:30],
            device_kernels={k: dict(count=c, us_each=t / c)
                            for k, (c, t) in kernels.items()})
        print(f"kernel 9 ({name}): a call {call:.4f} ms, alone "
              f"{alone:.4f} ms, host returns after {host:.4f} ms; card "
              f"kernels {json.dumps(result[name]['device_kernels'])}")
        for r in ops[:30]:
            print(f"  profiled {r['key']}: {json.dumps(r)}")
    return result


def probe_attention(torch, root: Path, label: str) -> dict:
    """Kernel 12 in bf16 alone at K12_SHAPES, the base tiling and each of
    K12_KNOCKOUTS in turns (base, variant, variant, base)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    logs = _build.build_all(["flash_attention"])
    base = _build.library("flash_attention")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    work = root / "build" / "probe12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = dict(label=label, root=str(root), device=smi,
                  ptxas={"base": ptxas_report(logs.get("flash_attention",
                                                       ""))},
                  shapes=[])
    libs = {}
    for v, edits in K12_KNOCKOUTS.items():
        proc, lib = start_build(_build, csrc, "flash_attention", v, edits,
                                work)
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for flash_attention-{v}")
        libs[v] = ctypes.CDLL(str(lib))
        fn = libs[v].earl_flash_attention
        fn.argtypes = list(_build.SIGNATURES["flash_attention"])
        fn.restype = ctypes.c_int
        result["ptxas"][v] = ptxas_report(out)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for case, hq, hkv, d, w in K12_SHAPES:
        q, k, v = cs.fa_inputs(torch, (cs.FA_B, hq, hkv, cs.FA_S, cs.FA_S,
                                       d), torch.bfloat16, gen)
        fn = lambda: flash_attention(q, k, v, causal=True,  # noqa: E731
                                     window=w)
        row = dict(case=case, B=cs.FA_B, Hq=hq, Hkv=hkv, S=cs.FA_S, D=d,
                   window=w)
        for variant in libs:
            for turn in ("base", variant, variant, "base"):
                _build._LOADED["flash_attention"] = libs.get(turn, base)
                try:
                    t = cs.launch_ms(torch, fn, "flash_attention", K12_REPS)
                finally:
                    _build._LOADED["flash_attention"] = base
                row.setdefault(turn, []).append(t)
        result["shapes"].append(row)
        print(f"kernel 12 alone (ms) {json.dumps(row)}")
        del q, k, v
    return result


def probe_attention_bwd(torch, root: Path, label: str) -> dict:
    """Kernel 12's backward in bf16 on the tensor cores alone at
    K12B_SHAPES, the base tiling and each of K12B_KNOCKOUTS in turns
    (base, variant, variant, base), each variant's gradients beside the
    base's (largest |difference|: another tiling sums in another order),
    and scaled_dot_product_attention's backward on the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    logs = _build.build_all(["flash_attention", "flash_attention_bwd"])
    base = _build.library("flash_attention_bwd")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    work = root / "build" / "probe12b"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    started = {v: start_build(_build, csrc, "flash_attention_bwd", v, edits,
                              work) for v, edits in K12B_KNOCKOUTS.items()}
    tc = ("_tc", "prep")
    result = dict(label=label, root=str(root), device=smi, ptxas={
        "base": [r for r in ptxas_report(logs.get("flash_attention_bwd", ""))
                 if any(t in r[0] for t in tc)]}, shapes=[])
    libs = {}
    for v, (proc, lib) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for flash_attention_bwd-{v}")
        libs[v] = ctypes.CDLL(str(lib))
        fn = libs[v].earl_flash_attention_bwd
        fn.argtypes = list(_build.SIGNATURES["flash_attention_bwd"])
        fn.restype = ctypes.c_int
        result["ptxas"][v] = [r for r in ptxas_report(out)
                              if any(t in r[0] for t in tc)]
    for key, lines in result["ptxas"].items():
        for fn_name, regs, spill in lines:
            print(f"ptxas {key}: {fn_name}: {regs} registers; {spill}")
    from repro_torch.kernels._pass import BWD_TC_MAX_D
    gen = torch.Generator(device="cuda").manual_seed(28)
    for case, shape, kw in K12B_SHAPES:
        q, k, v = cs.fa_inputs(torch, shape, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        kw = dict(causal=kw["causal"], window=kw.get("window"),
                  kv_offset=0, scale=shape[5] ** -0.5)
        o, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
        fn = lambda: ops.flash_attention_backward_cuda(  # noqa: E731
            q, k, v, o, lse, do, **kw)
        want = fn()
        row = dict(case=case, shape=list(shape), **kw, diff={})
        if shape[5] > BWD_TC_MAX_D:
            row["base"] = [cs.launch_ms(torch, fn, "flash_attention_bwd", 2)
                           for _ in range(2)]
        for variant in (libs if shape[5] <= BWD_TC_MAX_D else ()):
            _build._LOADED["flash_attention_bwd"] = libs[variant]
            try:
                got = fn()
            finally:
                _build._LOADED["flash_attention_bwd"] = base
            row["diff"][variant] = max(float((a.float() - b.float()).abs()
                                             .max()) for a, b in zip(got,
                                                                     want))
            for turn in ("base", variant, variant, "base"):
                _build._LOADED["flash_attention_bwd"] = libs.get(turn, base)
                try:
                    t = cs.launch_ms(torch, fn, "flash_attention_bwd",
                                     K12B_REPS)
                finally:
                    _build._LOADED["flash_attention_bwd"] = base
                row.setdefault(turn, []).append(t)
        row["sdpa"] = cs.sdpa_backward_ms(torch, q, k, v, do, kw)
        result["shapes"].append(row)
        print(f"kernel 12's backward alone (ms) {json.dumps(row)}")
        del q, k, v, do, o, lse, want
    return result


def build_parent(_build, src: Path, name: str, work: Path):
    """PARENT's ``csrc/<name>.cu`` built with the port's nvcc flags: its
    entry point, bound with this checkout's signature."""
    lib_path = work / f"libparent_{name}.so"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          str(src), "-o", str(lib_path),
                          str(src / f"{name}.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {name}:\n"
                           f"{out.stdout}{out.stderr}")
    fn = getattr(ctypes.CDLL(str(lib_path)), f"earl_{name}")
    fn.argtypes = list(_build.SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def probe_bwd_parent(torch, parent_bwd, cases) -> int:
    """The backward's CUDA-core route (f32 at every D, bf16 past D = 128)
    bitwise PARENT's at ``cases``; returns the geometries held."""
    from repro_torch.kernels._pass import BWD_TC_MAX_D, stream_ptr
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(28)
    same = 0
    for shape, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.bfloat16 and shape[5] <= BWD_TC_MAX_D:
                continue
            q, k, v = cs.fa_inputs(torch, shape, dt, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            b, hq, hkv, sq, skv, d = shape
            kw = dict(causal=kw["causal"], window=kw.get("window"),
                      kv_offset=kw.get("kv_offset", 0), scale=d ** -0.5)
            o, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
            tc0 = ops.flash_attention_backward_cuda.tc_launches
            got = ops.flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                    **kw)
            if ops.flash_attention_backward_cuda.tc_launches != tc0:
                raise RuntimeError(f"{shape} {dt} took the tensor cores")
            qc, kc, vc, oc, dc = (t.contiguous() for t in (q, k, v, o, do))
            want = [torch.empty_like(t) for t in (qc, kc, vc)]
            delta = torch.empty((b * hq, sq), dtype=torch.float32,
                                device=q.device)
            err = parent_bwd(
                ops._DTYPES[dt], b * hq, hq, hkv, sq, skv, d,
                float(kw["scale"]), int(kw["causal"]), kw["window"] or 0,
                kw["kv_offset"], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                oc.data_ptr(), dc.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in want),
                stream_ptr(q.device))
            if err != 0:
                raise RuntimeError(f"the parent's backward failed: {err}")
            ok = all(torch.equal(a, w) for a, w in zip(got, want))
            print(f"kernel 12's backward {shape} {kw} {dt}: bitwise the "
                  f"parent's {ok}")
            if not ok:
                raise RuntimeError(f"kernel 12's backward at {shape} {kw} "
                                   f"{dt} is not bitwise the parent's")
            same += 1
    return same


def probe_lse_parent(torch, root: Path, parent: Path) -> dict:
    """Kernel 12's output with and without lse, and lse, against PARENT's
    kernel (a checkout from the training slice on), bitwise, at every
    geometry of chip_smoke's FA_CASES and FA_WIDE_CASES (f32 and bf16)
    and the serving prefill's shape (bf16); then the backward's CUDA-core
    route bitwise PARENT's at tests/test_torch_cuda.py's FA_BWD_CASES
    (``probe_bwd_parent``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._pass import stream_ptr
    from repro_torch.kernels.flash_attention import ops
    work = root / "build" / "probe_lse"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    src = parent / "src" / "repro_torch" / "kernels" / "csrc"
    fn = build_parent(_build, src, "flash_attention", work)
    gen = torch.Generator(device="cuda").manual_seed(27)
    cases = [(s, kw, dt) for s, kw in cs.FA_CASES + cs.FA_WIDE_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(((cs.FA_B, cs.FA_HQ, cs.FA_HKV, cs.FA_S, cs.FA_S, cs.FA_D),
                  dict(causal=True, window=cs.FA_W), torch.bfloat16))
    same = 0
    for shape, kw, dt in cases:
        q, k, v = cs.fa_inputs(torch, shape, dt, gen)
        d = shape[5]
        kw = dict(causal=kw["causal"], window=kw.get("window"),
                  kv_offset=kw.get("kv_offset", 0), scale=d ** -0.5)
        got, _ = ops._forward_cuda(q, k, v, with_lse=False, **kw)
        got_lse, lse = ops._forward_cuda(q, k, v, with_lse=True, **kw)
        if dt == torch.bfloat16:
            q3, k3, v3 = (ops._tma_ready(t) for t in (q, k, v))
        else:
            q3, k3, v3 = q.contiguous(), k.contiguous(), v.contiguous()
        want = torch.empty_like(q3)
        want_lse = torch.empty_like(lse)
        err = fn(ops._DTYPES[dt], shape[0] * shape[1], shape[1], shape[2],
                 shape[3], shape[4], q3.shape[3], float(kw["scale"]),
                 int(kw["causal"]), kw["window"] or 0, kw["kv_offset"],
                 q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 want.data_ptr(), want_lse.data_ptr(), stream_ptr(q.device))
        if err != 0:
            raise RuntimeError(f"the parent's kernel 12 failed: {err}")
        want = want[..., :d]
        ok = (torch.equal(got, want) and torch.equal(got_lse, want)
              and torch.equal(lse, want_lse))
        print(f"kernel 12 {shape} {kw} {dt}: bitwise the parent's {ok}")
        if not ok:
            raise RuntimeError(f"kernel 12 at {shape} {kw} {dt} is not "
                               f"bitwise the parent's")
        same += 1
        del q, k, v, q3, k3, v3
    sys.path.insert(0, str(root / "tests"))
    from test_torch_cuda import FA_BWD_CASES
    bwd = build_parent(_build, src, "flash_attention_bwd", work)
    return dict(parent=str(parent), geometries_bitwise=same,
                geometries=len(cases),
                backward_geometries_bitwise=probe_bwd_parent(
                    torch, bwd, FA_BWD_CASES))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="probe")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernel9", action="store_true")
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--attention-bwd", action="store_true")
    ap.add_argument("--lse-parent", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import torch
    if not torch.cuda.is_available():
        print("probe_slots: no CUDA device", file=sys.stderr)
        return 2
    if args.lse_parent:
        result = probe_lse_parent(torch, root, Path(args.lse_parent))
        print(json.dumps(result))
        return 0
    if args.kernel9 or args.attention or args.attention_bwd:
        probe = (probe_kernel9 if args.kernel9 else probe_attention
                 if args.attention else probe_attention_bwd)
        result = probe(torch, root, args.label)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    from repro_torch import random as trandom
    from repro_torch.core import GroupedStatistic, KMeansStep, Mean, bootstrap
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign.ops import fused_poisson_kmeans
    from repro_torch.kernels.weighted_stats.ops import fused_poisson_moments

    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    design = "slots" if (csrc / "slot_tile.cuh").exists() else "registers"
    knockouts, knobs = KNOCKOUTS[design], KNOBS[design]
    work = root / "build" / "probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    started = {}
    for name, variants in VARIANTS[design].items():
        for v in variants:
            if v != "base" and v not in knockouts:
                if v not in knobs:
                    raise RuntimeError(f"variant {v} is neither a knock-out "
                                       f"nor a knob of the {design} design")
                continue  # the base library under a knob
            edits = [e for e in knockouts.get(v, [])
                     if e[0] == f"{name}.cu" or e[0].endswith(".cuh")]
            if v != "base" and not edits:
                raise RuntimeError(f"variant {v} edits nothing of {name}")
            started[(name, v)] = start_build(_build, csrc, name, v, edits,
                                             work)
    libs, ptxas = {}, {}
    for (name, v), (proc, lib) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {name}-{v}")
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, f"earl_{name}")
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
        libs[(name, v)] = cdll
        ptxas[f"{name}-{v}"] = ptxas_report(out)
    build_s = time.perf_counter() - t0
    for key, lines in ptxas.items():
        for fn, regs, spill in lines:
            print(f"ptxas {key}: {fn}: {regs} registers; {spill}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")

    def with_variant(name, variant, fn):
        lib = libs.get((name, variant), libs[(name, "base")])
        _build._LOADED[name] = lib
        knob = knobs.get(variant)
        if knob:
            module = importlib.import_module(knob[0])
            before = getattr(module, knob[1])
            setattr(module, knob[1], knob[2](before))
        try:
            return fn()
        finally:
            _build._LOADED[name] = libs[(name, "base")]
            if knob:
                setattr(module, knob[1], before)

    def timed(name, fn, shape=None):
        row = {}
        reps = REPS[name]
        if cs.launch_ms(torch, fn, name, 1) < 0.1:
            reps = SMALL_REPS
        for variant in VARIANTS[design][name]:
            if shape is not None and shape not in ONLY.get(variant,
                                                           (shape,)):
                continue
            row[variant] = with_variant(name, variant, lambda: cs.launch_ms(
                torch, fn, name, reps))
        row["call"] = cs.time_ms(torch, fn, reps)
        return row

    for name in VARIANTS[design]:
        _build._LOADED[name] = libs[(name, "base")]
    result = dict(label=args.label, root=str(root), design=design,
                  device=smi, build_s=build_s, ptxas=ptxas, kmeans=[],
                  grouped=[])
    seed = 2025
    for B, n, k, d in KMEANS_SHAPES:
        x, cent = cs.km_data(torch, n, k, d, seed=n + k)
        row = timed("fused_kmeans", lambda: fused_poisson_kmeans(
            seed, x, cent, B))
        row.update(B=B, n=n, k=k, d=d)
        result["kmeans"].append(row)
        print(f"kernel 8 {json.dumps(row)}")
    for B, n, G, d in GROUPED_SHAPES:
        xk = torch.from_numpy(cs.keyed_rows(n, d, G, seed=n + d + G)).cuda()
        x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
        row = timed("fused_grouped", lambda: fused_poisson_moments(
            seed, x, B, group_ids=keys, num_groups=G), shape=(G, d))
        row.update(B=B, n=n, G=G, d=d)
        if (G, d) == (8, 1):
            row["kernel2"] = timed("fused_pass", lambda: fused_poisson_moments(
                seed, x, B))
        result["grouped"].append(row)
        print(f"kernel 6 {json.dumps(row)}")

    # end to end, with the base kernels: each bootstrap a call (3 calls),
    # and chip_smoke's grouped-against-masked comparison
    xb, cb = cs.km_data(torch, 1 << 22, 5, 2, seed=7)
    result["kmeans_bootstrap_ms"] = cs.time_ms(torch, lambda: bootstrap(
        xb, KMeansStep(cb), 256, trandom.PRNGKey(11), backend="fused_rng"), 3)
    xk = torch.from_numpy(cs.keyed_rows((1 << 24) - 1000)).cuda()
    result["keyed_bootstrap_ms"] = cs.time_ms(torch, lambda: bootstrap(
        xk, GroupedStatistic(Mean(), 8), 256, trandom.PRNGKey(13),
        backend="fused_rng"), 3)
    del xk
    sh = cs.GB_RATIO_SHAPE
    xk = torch.from_numpy(cs.keyed_rows(sh["n"], sh["d"], 8, seed=5)).cuda()
    x, keys = xk[:, :-1].contiguous(), xk[:, -1].contiguous()
    masks = [(keys == g).float() for g in range(8)]
    grouped = cs.time_ms(torch, lambda: fused_poisson_moments(
        seed, x, sh["B"], group_ids=keys, num_groups=8), 20)
    masked = cs.time_ms(torch, lambda: [fused_poisson_moments(
        seed, x, sh["B"], valid_mask=m) for m in masks], 20)
    result["grouped_vs_masked"] = dict(grouped_ms=grouped, masked_ms=masked,
                                       ratio=masked / grouped)
    print(f"end to end: k-means bootstrap {result['kmeans_bootstrap_ms']} "
          f"ms, keyed bootstrap {result['keyed_bootstrap_ms']} ms, grouped "
          f"vs masked {json.dumps(result['grouped_vs_masked'])}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
