"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's weights and inputs come from
``--seed``; every shape it uses is warmed during set-up; its traffic then
runs for ``--seconds``; with ``--trace 1`` a few more units of it run
under ``torch.profiler``.  Once the window has closed and the peak memory
has been read, what the window produced is compared with the plain
reference (``reference/``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit, which also end standard error.

It exits with a code other than 0, and prints no result, where no CUDA
card is there or fewer than the cell asks for, where any stage fails, and
where JAX or the JAX package was loaded into its process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of a run inside the checkout, at a fixed path, so that only
# a checkout's first run builds; the port's kernels go to ROOT/build/kernels
CACHE = HERE / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from cardbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    import torch
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell {cell.name} needs {chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda",
                      cfg=harness.model_config(cell.model), torch=torch)
    out = harness.execute(bench, run, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"cardbench: the run's process loaded {found}; neither the "
              f"benchmark nor the port may load JAX or the JAX package",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:           # the run's boundary: report, print no result
        traceback.print_exc()
        sys.exit(1)
