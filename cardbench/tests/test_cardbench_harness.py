"""The harness finds every file of a cell, configuration and metric by
name; ``BENCHMARK.json`` keeps the contract's shape; no module of the
benchmark loads JAX, the JAX package or the files beside the port that
measured it."""
import ast
import json
import re

import pytest

from cardbench import harness
from cardbench.tests import smoke

BENCH = smoke.bench()
HERE = smoke.ROOT / "cardbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    cell = harness.find_cell(BENCH, w["name"])
    assert (HERE / "drivers" / f"{cell.work['driver']}.py").exists()
    assert cell.model["name"] == w["config"]
    harness.model_config(cell.model)
    assert set(cell.work["limits"]) and all(
        v > 0 for v in cell.work["limits"].values())
    e2e = harness.metrics_of(BENCH, w["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    mod = harness.load_module(HERE / "metrics" / f"{m['name']}.py", "m")
    assert mod.read({}) is None      # nothing to read: left out


def test_a_reader_that_finds_nothing_is_left_out():
    got = harness.read_metrics(
        [{"name": "setup_s", "unit": "s"}, {"name": "answer_s",
                                             "unit": "s"}],
        {"setup_s": 12.5})
    assert got == {"setup_s": {"value": 12.5, "unit": "s"}}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such.cell")


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cardbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        assert {m["name"] for m in BENCH["per_layer"]
                if w in m.get("workloads", [w])
                and "mfu" in m["name"]}


def _modules():
    return sorted(p for p in HERE.rglob("*.py") if ".cache" not in p.parts)


BANNED_IMPORTS = {"jax", "jaxlib", "flax", "repro", "benchmarks",
                  "chip_smoke", "probe_slots"}


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    assert not tops & BANNED_IMPORTS, (path, tops & BANNED_IMPORTS)
    if path.parent.name != "tests":
        text = " ".join(n.value for n in ast.walk(tree)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str))
        for name in ("artifacts/", "benchmarks/", "chip_smoke",
                     "probe_slots", "BENCH_"):
            assert name not in text, (path, name)


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    for name in ("repro_torch_probe.x", "jaxtyping_probe", "repro.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert "repro" in found
    assert set(found) <= set(harness.FORBIDDEN)
