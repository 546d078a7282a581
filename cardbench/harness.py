"""The parts every run of the benchmark shares.

A cell is found by its name alone: ``BENCHMARK.json`` names its
configuration and traffic, ``workloads/<cell>.json`` holds the traffic's
parameters and the traffic module that runs it (``drivers/<kind>.py``),
``configs/<file>.json`` the model as it is run, and each metric is read by
``metrics/<metric>.py``.  A later cell or metric is a new file here, never
an edit.

A run is ``Run``: the traffic module's ``setup`` (weights and inputs from the
seed, every shape of the cell warmed), its ``window`` (the measured
traffic), with ``--trace 1`` its ``traced`` units under ``torch.profiler``,
then its ``judge``, which compares what the window produced with the plain
reference in ``reference/`` once the peak memory has been read and the
program's state freed.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import math
import numbers
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package this port was made from (``repro``; the port,
#: ``repro_torch``, shares its prefix, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the prefix of the benchmark's own ``torch.profiler`` annotations
LABEL = "cb:"


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run (weights, data, a session's
    key), fixed by the run's seed and the tags alone (a NumPy integer
    tag is its int)."""
    tags = tuple(int(t) if isinstance(t, numbers.Integral) else t
                 for t in tags)
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    entry: dict             # the BENCHMARK.json entry
    work: dict              # workloads/<name>.json
    config: dict            # the configuration's BENCHMARK.json entry
    model: dict             # the configuration's file


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[entry["config"]]
    work = load_json(HERE / "workloads" / f"{name}.json")
    if work.get("traffic") != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json runs traffic "
                         f"{work.get('traffic')!r}, BENCHMARK.json says "
                         f"{entry['traffic']!r}")
    return Cell(name, entry, work, config, load_json(root / config["file"]))


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced; a metric without ``workloads`` is every
    cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(metrics: List[dict], rec: dict) -> Dict[str, dict]:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "cardbench_metric_" + m["name"].replace(".",
                                                                     "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def model_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``run``."""
    from repro_torch.models.config import ModelConfig
    run = dict(model["run"])
    run["layer_pattern"] = tuple(run["layer_pattern"])
    cfg = ModelConfig(**run)
    cfg.validate()
    return cfg


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """A run of one cell: what its traffic module keeps between stages."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    cfg: Any
    torch: Any
    rec: dict = dataclasses.field(default_factory=dict)
    state: dict = dataclasses.field(default_factory=dict)

    @property
    def work(self) -> dict:
        return self.cell.work

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.state.clear()
        import gc
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# torch.profiler
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def label(torch, name: str):
    with torch.profiler.record_function(LABEL + name):
        yield


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries, names cut to 160 characters (a kernel's
    name holds its whole signature)."""
    return [[k[:160], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def traced(run: Run, body: Callable[[], None]) -> dict:
    """Run ``body`` under ``torch.profiler`` and read the trace.

    The traced window is the ``cb:window`` annotation around ``body``,
    which ends in a synchronise.  Returned: ``window_s``; ``busy_s``, the
    union of the device's operations inside it; ``kernel_s``, device
    seconds by operation name; ``labels``, for each of the traffic's
    annotations (``label``), its host seconds and count, the device
    seconds of the operations that started inside it (innermost
    annotation) by name, and the device seconds of the host operations
    that started inside it by name; ``device_ops``, the ten operations
    that took most device time; ``idle_gaps``, the device's idle time
    inside the window by what the host was doing (the innermost
    annotation, else the host operation, at each gap's middle)."""
    torch = run.torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=acts) as prof:
        with label(torch, "window"):
            body()
            run.sync()
    events = prof.events()
    device_t = torch.autograd.DeviceType.CUDA
    # the device's timeline also carries copies of the annotations
    dev = [e for e in events if e.device_type == device_t
           and not e.name.startswith(LABEL)]
    host = [e for e in events if e.device_type != device_t]
    labels = [e for e in host if e.name.startswith(LABEL)]
    win = [e for e in labels if e.name == LABEL + "window"][-1]
    w0, w1 = win.time_range.start, win.time_range.end
    inner = [e for e in labels if e is not win]

    def innermost(t: float) -> Optional[str]:
        best = None
        for e in inner:
            if e.time_range.start <= t <= e.time_range.end and (
                    best is None
                    or e.time_range.start >= best.time_range.start):
                best = e
        return None if best is None else best.name[len(LABEL):]

    kernel_s: Dict[str, float] = {}
    by_label: Dict[str, dict] = {}
    for e in inner:
        d = by_label.setdefault(e.name[len(LABEL):], dict(
            host_s=0.0, count=0, kernel_s={}, op_device_s={}))
        d["host_s"] += (e.time_range.end - e.time_range.start) * 1e-6
        d["count"] += 1
    spans = []
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        spans.append((a, b))
        s = (b - a) * 1e-6
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + s
        where = innermost(e.time_range.start)
        if where is not None:
            k = by_label[where]["kernel_s"]
            k[e.name] = k.get(e.name, 0.0) + s
    for e in host:
        if e.name.startswith(LABEL) or not (w0 <= e.time_range.start <= w1):
            continue
        where = innermost(e.time_range.start)
        dt = getattr(e, "device_time_total", 0.0) or 0.0
        if where is not None and dt:
            ops = by_label[where]["op_device_s"]
            ops[e.name] = ops.get(e.name, 0.0) + dt * 1e-6
    busy = _merge(spans)
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for s in busy for t in s] + [w1]
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host if not e.name.startswith(LABEL))
    starts = [o[0] for o in ops]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = innermost(mid)
        if name is None:
            # the host operation begun last before the gap's middle that
            # still runs there, among the few begun last
            i = bisect.bisect_right(starts, mid)
            name = next((o[2] for o in reversed(ops[max(0, i - 64):i])
                         if o[1] >= mid), "host")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernel_s=kernel_s, labels=by_label,
                device_ops=_top(kernel_s), idle_gaps=_top(gaps))


def kernel_seconds(kernel_s: Dict[str, float], pattern: str) -> float:
    """Device seconds of the operations whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in kernel_s.items() if rx.search(name))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def stage(name: str, t0: float) -> None:
    print(f"cardbench: {name} {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)


def device_info(run: Run) -> dict:
    torch = run.torch
    if run.device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=int(run.cell.entry.get("chips", 1)),
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def execute(bench: dict, run: Run, t_start: float,
            driver=None) -> dict:
    """Every stage of a run; returns the result line's object (the
    platform and the loaded modules are ``run.py``'s to check)."""
    if driver is None:
        driver = load_module(HERE / "drivers" / f"{run.work['driver']}.py",
                             "cardbench_driver_" + run.work["driver"])
    run.rec.update(cfg=run.cfg, work=run.work)
    driver.setup(run)
    run.sync()
    run.rec["setup_s"] = time.perf_counter() - t_start
    stage("set-up", t_start)
    t = time.perf_counter()
    driver.window(run)
    stage("window", t)
    trace = None
    if run.trace:
        t = time.perf_counter()
        trace = driver.traced(run)
        run.rec["trace"] = trace
        stage("traced units and their trace", t)
    device = device_info(run)
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    metrics = read_metrics(metrics_of(bench, run.cell.name, run.trace),
                           run.rec)
    t = time.perf_counter()
    checks = driver.judge(run)
    run.free()
    stage("judge", t)
    out = {"correct": all(c.ok for c in checks),
           "attempted": int(run.rec["attempted"]),
           "failed": int(run.rec["failed"]),
           "metrics": metrics, "device": device}
    if trace is not None:
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
