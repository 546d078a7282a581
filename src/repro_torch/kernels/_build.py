"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, built at first use into ``build/kernels/`` at the checkout's
root (git-ignored).  The library's file name carries a hash of every
source, the generated header and the flags, so an edited source is never
served from a stale build.  ``build_all`` starts one nvcc per source at
once.

The Poisson(1) CDF rungs reach the kernels through a generated header,
``poisson_cdf.h``, written from ``poisson_counts.ref.POISSON_CDF_F32`` as
exact hexadecimal float literals: the plain and the CUDA versions compare
against the same f32 values, which are never typed out by hand.

No ``--use_fast_math``: histogram bin edges need IEEE division.  ptxas
reports each kernel's registers, shared memory and spills (``-Xptxas -v``);
``build_all`` returns that report per library it built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from repro_torch.kernels.poisson_counts.ref import POISSON_CDF_F32

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

VOID_P = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
#: C signature of each library's entry point (all return cudaError_t).
#: fused_pass serves fused_poisson_moments, _hist and _multi alike;
#: fused_grouped their keyed (GROUP BY) moments and histogram;
#: weighted_moments and weighted_hist take an explicit weight matrix;
#: fused_stream is the moments pass with x double-buffered through shared
#: memory, fused_binblocked the output-tiled (block_bins) histogram;
#: flash_attention is the attention of the model stack (kernel 12), with
#: a null or an f32 pointer for each row's log-sum-exp; flash_attention_bwd
#: its backward (q, k, v, o, dO, lse, a delta scratch, dq, dk, dv).
SIGNATURES: Dict[str, tuple] = {
    "poisson_counts": (INT, INT, INT, INT, INT, INT, VOID_P, VOID_P),
    "fused_pass": (INT, INT, INT, INT, INT, INT, INT, VOID_P, VOID_P, INT,
                   INT, INT, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P,
                   INT, VOID_P, VOID_P, VOID_P, INT, VOID_P, VOID_P),
    "kmeans_assign": (INT, INT, INT, VOID_P, VOID_P, VOID_P, INT, INT, INT,
                      VOID_P, VOID_P, VOID_P, VOID_P),
    "fused_kmeans": (INT, INT, INT, INT, INT, INT, INT, INT, VOID_P, VOID_P,
                     VOID_P, INT, INT, INT, INT, INT, VOID_P, VOID_P, VOID_P,
                     VOID_P),
    "fused_grouped": (INT, INT, INT, INT, INT, INT, INT, INT, VOID_P, VOID_P,
                      VOID_P, INT, INT, INT, INT, INT, VOID_P, VOID_P,
                      VOID_P, VOID_P, VOID_P, VOID_P, INT, VOID_P, VOID_P,
                      VOID_P, VOID_P, VOID_P),
    "weighted_moments": (INT, INT, INT, VOID_P, VOID_P, INT, INT, INT,
                         VOID_P, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P,
                         VOID_P),
    "weighted_hist": (INT, INT, INT, INT, VOID_P, VOID_P, VOID_P, VOID_P, INT,
                      INT, INT, INT, INT, INT, VOID_P, VOID_P),
    "fused_stream": (INT, INT, INT, INT, INT, INT, INT, VOID_P, VOID_P, INT,
                     INT, INT, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P,
                     VOID_P),
    "fused_binblocked": (INT, INT, INT, INT, INT, INT, INT, INT, VOID_P,
                         VOID_P, VOID_P, INT, VOID_P, VOID_P, INT, INT, INT,
                         INT, INT, VOID_P, VOID_P),
    "flash_attention": (INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, INT,
                        INT, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P),
    "flash_attention_bwd": (INT, INT, INT, INT, INT, INT, INT, FLOAT, INT,
                            INT, INT, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P,
                            VOID_P, VOID_P, VOID_P, VOID_P, VOID_P, VOID_P),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def cdf_header() -> str:
    lines = ["// Generated by repro_torch/kernels/_build.py from",
             "// poisson_counts/ref.py POISSON_CDF_F32: do not edit.",
             "#pragma once"]
    for k, c in enumerate(POISSON_CDF_F32):
        lines.append(f"#define EARL_POISSON_CDF_{k} {float(c).hex()}f")
    return "\n".join(lines) + "\n"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc was not found: the CUDA kernels are built from "
                       "source on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(cdf_header().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (process, target) pair or None."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / "poisson_cdf.h").write_text(cdf_header())
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(BUILD_DIR), "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    """Wait for nvcc; returns its output ("" when nothing was built)."""
    if started is None:
        return ""
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Build every named library, one nvcc per source, all at once;
    returns nvcc's output (the ptxas report) per library built."""
    names = list(names)
    started = {n: _start(n) for n in names}
    errors, logs = [], {}
    for n in names:
        try:
            logs[n] = _finish(n, started[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, f"earl_{name}")
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call ``earl_<name>(*args)`` and raise on a nonzero cudaError_t."""
    err = getattr(library(name), f"earl_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
