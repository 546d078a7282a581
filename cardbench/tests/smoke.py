"""Runs of the benchmark's cells on the CPU at a tiny size, for the tests:
each cell's configuration cut to its port's smoke size (the same family,
d_model 64, 2 layers, vocabulary 509), its traffic to the parameters under
``tiny`` in its workload file, with the cell's own limits."""
from __future__ import annotations

import copy
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from cardbench import harness  # noqa: E402


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_model(model: dict) -> dict:
    from repro_torch.configs import smoke_of
    cfg = harness.model_config(model)
    small = dataclasses.asdict(smoke_of(cfg))
    small["layer_pattern"] = list(small["layer_pattern"])
    return dict(model, run=small)


def tiny_run(name: str, seed: int = 7, seconds: float = 0.5) -> harness.Run:
    cell = harness.find_cell(bench(), name)
    cell = dataclasses.replace(cell, model=tiny_model(cell.model),
                               work=copy.deepcopy(cell.work))
    cell.work.update(cell.work["tiny"])
    torch.manual_seed(0)
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                       device="cpu", cfg=harness.model_config(cell.model),
                       torch=torch)


def execute(run: harness.Run) -> dict:
    return harness.execute(bench(), run, time.perf_counter())


def cells(driver: str = None) -> list:
    """The names of BENCHMARK.json's cells, those of one traffic module
    (``driver``) if given."""
    out = []
    for w in bench()["workloads"]:
        work = harness.load_json(ROOT / "cardbench" / "workloads"
                                 / f"{w['name']}.json")
        if driver is None or work["driver"] == driver:
            out.append(w["name"])
    return out
