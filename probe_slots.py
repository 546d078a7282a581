#!/usr/bin/env python3
"""Times kernels 8 (fused_kmeans.cu) and 6 (grouped_moments_kernel in
fused_grouped.cu) alone, in knock-outs and at other geometries, with
kernel 2 beside them.

    python3 probe_slots.py [--root CHECKOUT] [--label L] [--out FILE]
                           [--kernel9 | --attention | --attention-bwd |
                            --lse-parent PARENT | --gloo-cuda]

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

``--attention-bwd`` times kernel 12's backward on the tensor cores (bf16)
alone at phase 18's granite-3-2b shape and the other train-mode shapes
of 4,096 tokens and more, its tiling against the others (K12B_KNOCKOUTS:
up to head dim 128 query tiles of 64 rows, key tiles of 128, rings of one
stage; past it a ring of one stage in the dK/dV pass, and key tiles of 32
in two stages in the dQ pass),
in turns, with its bound and scaled_dot_product_attention's backward on
the same inputs.

``--wide-card-cpu`` holds phase 18's leg 3 slice of recurrentgemma-2b
(bf16 compute) on the card against the CPU from four initial params,
with kernel 12's backward and with its plain version on the card: each
leaf's share of its largest gradient (PERF.md §6).

``--gloo-cuda`` starts a gloo world of 4 ranks sharing the card (fresh
interpreters of this script, ``--gloo-rank R --gloo-store FILE``) and
tries, on CUDA tensors, each collective that DTensor issues
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``all_gather``, ``broadcast``) and each DTensor
redistribution of a (data 2 x model 2) mesh on the card (Shard ->
Replicate, Partial -> Replicate, Partial -> Shard, Shard(0) -> Shard(1)),
checking each result against the same collective's sum or concatenation
on the host.  Prints, per rank, which it takes and the error of each it
refuses (``GLOO_PROBE_DEVICE=cpu`` runs the same on host tensors).

``--lse-parent PARENT`` builds kernel 12 and its backward from PARENT's
source too (a checkout from the training slice on) and holds this
checkout's kernel, launched with a null ``lse`` and with one, and its
lse, bitwise against the parent's at chip_smoke.py's FA_CASES and
FA_WIDE_CASES in f32 and bf16 and at the serving prefill's shape in
bf16, and the backward bitwise PARENT's at tests/test_torch_cuda.py's
FA_BWD_CASES where both take one route: f32 (the CUDA cores) at every
head dim, bf16 (the tensor cores) up to 128 (PARENT_TC_MAX_D: a parent
from the backward's tensor-core route on).
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
#: launch_tc), its other tilings up to head dim 128: bq64, query tiles of
#: 64 rows in the dK/dV pass at head dim 64; bn128, key tiles of 128 in
#: the dQ pass at head dim 64; bq64bn128, both (the first tiling timed);
#: stages1, rings of one stage in both passes at both head dims; past head
#: dim 128 (the variants named wide_, timed at the shapes past it only;
#: the base has key tiles of 64 in the dQ pass in a ring of one stage, as
#: two stages of 64 keys do not fit beside Q and dO at DP = 256): wide_s1,
#: a ring of one stage in the dK/dV pass too; wide_bn32, key tiles of 32
#: in two stages in the dQ pass (the first tiling timed); wide_bn32s1,
#: that with rings of one stage in both passes
_K12B_BASE = ("  return D <= 64 ? EARL_TC_BWD(64, 128, 64, 2) : "
              "EARL_TC_BWD(128, 64, 64, 2);")
_K12B_WIDE = ("    return D <= 192 ? EARL_TC_WIDE(192, 2, 64, 1) : "
              "EARL_TC_WIDE(256, 2, 64, 1);")
K12B_KNOCKOUTS = {
    v: [("flash_attention_bwd.cu", _K12B_BASE,
         f"  return D <= 64 ? EARL_TC_BWD({lo}) : EARL_TC_BWD({hi});")]
    for v, lo, hi in (("bq64", "64, 64, 64, 2", "128, 64, 64, 2"),
                      ("bn128", "64, 128, 128, 2", "128, 64, 64, 2"),
                      ("bq64bn128", "64, 64, 128, 2", "128, 64, 64, 2"),
                      ("stages1", "64, 128, 64, 1", "128, 64, 64, 1"))}
K12B_KNOCKOUTS.update({
    v: [("flash_attention_bwd.cu", _K12B_WIDE,
         f"    return D <= 192 ? EARL_TC_WIDE(192, {t}) : "
         f"EARL_TC_WIDE(256, {t});")]
    for v, t in (("wide_s1", "1, 64, 1"), ("wide_bn32", "2, 32, 2"),
                 ("wide_bn32s1", "1, 32, 1"))})
#: (case, (b, hq, hkv, sq, skv, d), kwargs): phase 18's granite-3-2b
#: step and chip_smoke.py's BWD_CASES at 4,096 tokens and more (the head
#: dims past 128, gemma3-27b's and recurrentgemma-2b's, on the wide route),
#: and recurrentgemma-2b's local layer at phase 18's training batch of 4
K12B_SHAPES = [("granite_train", (cs.TRAIN_B, 32, 8, cs.TRAIN_S, cs.TRAIN_S,
                                  64), dict(causal=True))] + [
    (n, s, kw) for n, s, kw in cs.BWD_CASES if s[3] >= 4096] + [
    ("recurrentgemma_local_b4", (cs.WIDE_RG_B, 10, 1, cs.TRAIN_S,
                                 cs.TRAIN_S, 256),
     dict(causal=True, window=2048))]
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
    tc = ("_tc", "_wide", "prep")
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
        wide = shape[5] > 128
        for variant in (v for v in libs if v.startswith("wide_") == wide):
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
        row["bound_ms"] = ops.attention_flops(
            q.shape, k.shape, kw["causal"], kw["window"], 0, 10) \
            / cs.BF16_FLOPS_PER_S * 1e3
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


#: the widest head dim a parent's tensor-core backward took (a checkout
#: whose backward ran bf16 past it on the CUDA cores)
PARENT_TC_MAX_D = 128


def probe_bwd_parent(torch, parent_bwd, cases) -> int:
    """The backward bitwise PARENT's where both take the same route: f32
    at every D (the CUDA cores) and bf16 up to D = PARENT_TC_MAX_D (the
    tensor cores' instances up to DP = 128); returns the geometries
    held."""
    from repro_torch.kernels._pass import BWD_TC_BLOCK, stream_ptr
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device="cuda").manual_seed(28)
    same = 0
    for shape, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            tc = dt == torch.bfloat16
            if tc and shape[5] > PARENT_TC_MAX_D:
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
            if ops.flash_attention_backward_cuda.tc_launches != tc0 + tc:
                raise RuntimeError(f"{shape} {dt} did not take the route "
                                   f"expected (tensor cores: {tc})")
            ready = ops._tma_ready if tc else torch.Tensor.contiguous
            qc, kc, vc, oc, dc = (ready(t) for t in (q, k, v, o, do))
            want = [torch.empty_like(t) for t in (qc, kc, vc)]
            rows = -(-sq // BWD_TC_BLOCK) * BWD_TC_BLOCK
            delta = torch.empty((2, b * hq, rows) if tc else (b * hq, sq),
                                dtype=torch.float32, device=q.device)
            err = parent_bwd(
                ops._DTYPES[dt], b * hq, hq, hkv, sq, skv, qc.shape[3],
                float(kw["scale"]), int(kw["causal"]), kw["window"] or 0,
                kw["kv_offset"], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                oc.data_ptr(), dc.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(t.data_ptr() for t in want),
                stream_ptr(q.device))
            if err != 0:
                raise RuntimeError(f"the parent's backward failed: {err}")
            ok = all(torch.equal(a, w[..., :d]) for a, w in zip(got, want))
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
    and the serving prefill's shape (bf16); then the backward bitwise
    PARENT's at tests/test_torch_cuda.py's FA_BWD_CASES
    (``probe_bwd_parent``: f32 at every D, bf16 up to PARENT_TC_MAX_D)."""
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


GLOO_WORLD = 4


#: the collectives and redistributions ``--gloo-cuda`` tries, one world
#: of 4 each (a rank that crashes on one hides nothing of the others)
GLOO_ATTEMPTS = ("all_reduce", "broadcast", "all_gather",
                 "all_gather_into_tensor", "reduce_scatter_tensor",
                 "all_to_all_single", "all_gather_into_tensor, a subgroup",
                 "funcol all_gather_tensor", "funcol all_gather_tensor, "
                 "a subgroup", "dtensor Shard -> Replicate",
                 "dtensor Shard(0) -> Replicate, contiguous",
                 "dtensor Shard(1) -> Replicate, contiguous",
                 "dtensor Partial -> Replicate", "dtensor Partial -> Shard",
                 "dtensor Shard(0) -> Shard(1)")


def gloo_rank(torch, rank: int, store: str, only=None) -> dict:
    """One rank of ``--gloo-cuda``: each collective and redistribution on
    CUDA tensors (or only the one named ``only``), ``ok`` where it ran and
    agreed with the host's result, else the exception's first line."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.device_mesh import init_device_mesh
    import faulthandler
    import os
    import torch.distributed._functional_collectives as funcol
    faulthandler.enable()
    w = GLOO_WORLD
    dist.init_process_group("gloo", rank=rank, world_size=w,
                            store=dist.FileStore(store, w))
    dev = torch.device(os.environ.get("GLOO_PROBE_DEVICE", "cuda"))
    mine = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    every = [torch.arange(8, dtype=torch.float32) + 100 * r
             for r in range(w)]
    out = {}

    def attempt(name, fn, want):
        if only is not None and name != only:
            return
        print(f"rank {rank}: {name}", flush=True)
        try:
            got = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = ("ok" if torch.equal(got.cpu(), want)
                         else "wrong result")
        except Exception as e:            # the probe records every refusal
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    def all_reduce():
        t = mine.clone()
        dist.all_reduce(t)
        return t
    attempt("all_reduce", all_reduce, sum(every))

    def all_gather_into():
        t = torch.empty(8 * w, device=dev)
        dist.all_gather_into_tensor(t, mine)
        return t
    attempt("all_gather_into_tensor", all_gather_into, torch.cat(every))

    def reduce_scatter():
        t = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(t, mine)
        return t
    attempt("reduce_scatter_tensor", reduce_scatter,
            sum(every)[2 * rank:2 * rank + 2])

    def all_to_all():
        t = torch.empty(8, device=dev)
        dist.all_to_all_single(t, mine)
        return t
    attempt("all_to_all_single", all_to_all,
            torch.cat([e[2 * rank:2 * rank + 2] for e in every]))

    def all_gather():
        ts = [torch.empty(8, device=dev) for _ in range(w)]
        dist.all_gather(ts, mine)
        return torch.cat(ts)
    attempt("all_gather", all_gather, torch.cat(every))

    def broadcast():
        t = mine.clone()
        dist.broadcast(t, src=0)
        return t
    attempt("broadcast", broadcast, every[0])

    mesh = init_device_mesh(dev.type, (2, 2),
                            mesh_dim_names=("data", "model"))
    sub = mesh.get_group("data")
    mates = [every[r] for r in range(w)
             if mesh.get_coordinate()[1] == r % 2]

    def gather_sub():
        t = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(t, mine, group=sub)
        return t
    attempt("all_gather_into_tensor, a subgroup", gather_sub,
            torch.cat(mates))
    attempt("funcol all_gather_tensor", lambda: funcol.all_gather_tensor(
        mine, 0, list(range(w))).wait(), torch.cat(every))
    attempt("funcol all_gather_tensor, a subgroup",
            lambda: funcol.all_gather_tensor(mine, 0, sub).wait(),
            torch.cat(mates))
    glob = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    shard = DTensor.from_local(
        glob.chunk(2, 0)[mesh.get_coordinate()[0]].chunk(
            2, 1)[mesh.get_coordinate()[1]].to(dev), mesh,
        [Shard(0), Shard(1)], run_check=False)
    attempt("dtensor Shard -> Replicate", lambda: shard.redistribute(
        mesh, [Replicate(), Replicate()]).to_local(), glob)
    c = mesh.get_coordinate()
    rows0 = DTensor.from_local(glob.chunk(2, 0)[c[0]].contiguous().to(dev),
                               mesh, [Shard(0), Replicate()],
                               run_check=False)
    attempt("dtensor Shard(0) -> Replicate, contiguous",
            lambda: rows0.redistribute(mesh, [Replicate(), Replicate()])
            .to_local(), glob)
    cols1 = DTensor.from_local(glob.chunk(2, 1)[c[1]].contiguous().to(dev),
                               mesh, [Replicate(), Shard(1)],
                               run_check=False)
    attempt("dtensor Shard(1) -> Replicate, contiguous",
            lambda: cols1.redistribute(mesh, [Replicate(), Replicate()])
            .to_local(), glob)
    part = DTensor.from_local(glob.to(dev), mesh, [Partial(), Partial()],
                              run_check=False)
    attempt("dtensor Partial -> Replicate", lambda: part.redistribute(
        mesh, [Replicate(), Replicate()]).to_local(), glob * w)
    attempt("dtensor Partial -> Shard", lambda: part.redistribute(
        mesh, [Shard(0), Replicate()]).to_local(),
        (glob * w).chunk(2, 0)[mesh.get_coordinate()[0]])
    rows = DTensor.from_local(glob.chunk(2, 0)[mesh.get_coordinate()[0]].to(
        dev), mesh, [Shard(0), Replicate()], run_check=False)
    attempt("dtensor Shard(0) -> Shard(1)", lambda: rows.redistribute(
        mesh, [Shard(1), Replicate()]).to_local(),
        glob.chunk(2, 1)[mesh.get_coordinate()[0]])
    dist.destroy_process_group()
    return out


#: the initial params' seeds ``--wide-card-cpu`` draws (phase 18's leg 3
#: uses TRAIN_SEED + 5)
WIDE_CARD_CPU_SEEDS = (5, 6, 7, 8)


def probe_wide_card_cpu(torch, label: str) -> dict:
    """recurrentgemma-2b's slice in phase 18's leg 3 (its one pattern group,
    bf16 compute, 1 x TRAIN_CPU_S tokens) from the initial params of
    WIDE_CARD_CPU_SEEDS: each leaf's gradient on the card against the
    CPU's, as a share of the CPU leaf's largest |gradient|, with kernel
    12's backward and with its plain version on the card in its place,
    and the two card runs against each other."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.decoder import tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_grad_step
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    cfg = cs.wide_plan()[1][0]
    kernel = ops.flash_attention_backward_cuda

    def shares(a, b):
        fa, fb = cs.leaf_dict(a), cs.leaf_dict(b)
        return {p: float((fa[p] - fb[p]).abs().max())
                / max(float(fb[p].abs().max()), 1e-30) for p in fb}

    def worst(sh, n=4):
        return sorted(sh.items(), key=lambda x: -x[1])[:n]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = dict(label=label, device=smi, seeds={})
    for seed in WIDE_CARD_CPU_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(cs.TRAIN_SEED + seed)
        params = init_train_state(gen, cfg, AdamWConfig(warmup_steps=1),
                                  device="cuda").params
        one, p = cs.attention_slice(cfg, params)
        del params
        batch = cs.card_cpu_batch(torch, cfg)
        step = make_grad_step(one)
        card = {}
        try:
            for name, bwd in (("kernel", kernel),
                              ("plain", ops.flash_attention_backward_plain)):
                ops.flash_attention_backward_cuda = bwd
                card[name] = tree_map(lambda t: t.cpu(), step(p, batch)[0])
        finally:
            ops.flash_attention_backward_cuda = kernel
        cpu = step(tree_map(lambda t: t.cpu(), p), batch)[0]
        row = {f"{n}_vs_cpu": worst(shares(card[n], cpu)) for n in card}
        row["kernel_vs_plain"] = worst(shares(card["kernel"], card["plain"]))
        result["seeds"][seed] = row
        print(f"seed {seed}: {json.dumps(row)}", flush=True)
        del p, card, cpu
        torch.cuda.empty_cache()
    return result


def probe_gloo_cuda(torch, label: str) -> dict:
    """``--gloo-cuda``: a world of 4 for each of GLOO_ATTEMPTS, each rank
    this script again; an attempt's result is rank 0's, or the exit code
    and log tail of a rank that died."""
    import tempfile
    results = {}
    for i, name in enumerate(GLOO_ATTEMPTS):
        with tempfile.TemporaryDirectory() as tmp:
            store = str(Path(tmp) / "store")
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--gloo-rank", str(r), "--gloo-store", store,
                 "--gloo-only", str(i)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for r in range(GLOO_WORLD)]
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=120)[0])
                finally:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        died = [(r, p.returncode, log[-600:]) for r, (p, log) in
                enumerate(zip(procs, logs)) if p.returncode != 0]
        if died:
            results[name] = {"died": died}
        else:
            results[name] = json.loads(logs[0].strip().splitlines()[-1])[
                name]
        print(f"gloo on CUDA tensors, {name}: {results[name]}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return dict(label=label, device=smi, torch=torch.__version__,
                results=results)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="probe")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernel9", action="store_true")
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--attention-bwd", action="store_true")
    ap.add_argument("--lse-parent", default=None)
    ap.add_argument("--gloo-cuda", action="store_true")
    ap.add_argument("--wide-card-cpu", action="store_true")
    ap.add_argument("--gloo-rank", type=int, default=None)
    ap.add_argument("--gloo-store", default=None)
    ap.add_argument("--gloo-only", type=int, default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import torch
    if not torch.cuda.is_available():
        print("probe_slots: no CUDA device", file=sys.stderr)
        return 2
    if args.gloo_rank is not None:
        only = (None if args.gloo_only is None
                else GLOO_ATTEMPTS[args.gloo_only])
        print(json.dumps(gloo_rank(torch, args.gloo_rank, args.gloo_store,
                                   only)))
        return 0
    if args.gloo_cuda or args.wide_card_cpu:
        result = (probe_gloo_cuda if args.gloo_cuda
                  else probe_wide_card_cpu)(torch, args.label)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
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
