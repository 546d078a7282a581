"""The upper readings of a cell's limits: the control, and for training
the faults, on the card at the cell's own size.  The benchmark's own runs
never run this.

    python3 cardbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 4] [--out FILE]

The control is the plain reference put in the program's place at the
precision below the one the configuration states (bf16 compute: fp8
e4m3 operands with one scale a tensor, ``reference/decoder.Rounding``;
the session's f32 sums: bf16), judged as the program is judged:

* ``earl_eval``: a short window answered by the program (its own
  readings beside the control's); in each answer's place, the fp8
  reference's losses of its documents and the session over them in bf16
  sums, judged as the program's answer is;
* ``train``: the fp8 reference's first steps against the f32 reference's,
  and the fault "half of each batch left out" (the mean over the rest).
  "A step that returns its state unchanged" reads 1 by the measure and
  needs no run.

Each seed prints one JSON line of readings, also appended to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def readings(run, driver, torch) -> dict:
    from cardbench.reference import bootstrap as rboot
    from cardbench.reference import decoder as rdec
    fp8 = rdec.Rounding(torch.float8_e4m3fn)
    kind = run.work["driver"]
    if kind == "train":
        want = driver.reference_steps(run)
        ctrl = driver.reference_steps(run, rnd=fp8)
        half = driver.reference_steps(run, keep_rows=run.work["batch"] // 2)
        return {"control": driver.compare(ctrl, want),
                "half_batch": driver.compare(half, want),
                "reference_grad_norm": want["grad_norm"]}
    driver.setup(run)
    driver.window(run)
    j = driver.judged(run)
    run.free()
    want = driver.reference_losses(run, j["toks"], j["labs"])
    low = driver.reference_losses(run, j["toks"], j["labs"], fp8)
    ctrl = []
    for a, x in zip(j["answers"], j["xs"]):
        rep = rboot.session_report(low[:len(x)], a["key"], a["B"], a["ns"],
                                   precision=torch.bfloat16)
        ctrl.append(dict(a, **rep))
    return {"program": driver.compare(j["answers"], j["xs"], want),
            "control": driver.compare(
                ctrl, [low[:len(x)] for x in j["xs"]], want),
            "B": [a["B"] for a in j["answers"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from cardbench import harness
    import torch
    if not torch.cuda.is_available():
        print("control.py runs on a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(HERE.parent / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    driver = harness.load_module(
        HERE / "drivers" / f"{cell.work['driver']}.py",
        "cardbench_driver_" + cell.work["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                          trace=False, device="cuda",
                          cfg=harness.model_config(cell.model), torch=torch)
        out = dict(workload=cell.name, seed=seed,
                   **readings(run, driver, torch),
                   seconds=time.perf_counter() - t0,
                   device=torch.cuda.get_device_name(0))
        run.free()
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
