"""The dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/hlo_flops.py``) on the CPU.

With the module, six fresh interpreters start:

* the JAX package's dry run of smoke cells on a 2 x 2 mesh of 4 forced
  host devices (tests/torch_dryrun_jax.py), its analyses read from its
  own partitioned HLO;
* the port's dry run of the same cells on a 2 x 2 mesh over a fake
  process group of 4 ranks (``torch_sharded_ranks.dryrun_fake``);
* a real gloo world of 4 (2 x 2) running the same steps with real
  tensors (``torch_sharded_ranks.dryrun_real``).

Held exactly: the skip records, ``model_params``, ``model_active_params``,
``state_bytes_global`` and ``_per_chip`` and every leaf's local shape
against the JAX package's; the fake run's collectives (by kind, with
bytes) and dot FLOPs against the real world's.  The dot FLOPs outside
kernels 12 and 12b against the JAX HLO's less its attention's, cell by
cell with the cause of each gap (``_expect``).  Collective bytes
against the JAX package's are recorded (XLA's partitioner and DTensor
choose different collectives), not asserted.  In-process: kernel 12's
and 12b's FLOP formulas against a hand count of visible pairs, the fake
full-size init of the recurrent configs, and the counters' entry
points.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dryrun_jax as J
import torch_sharded_ranks as R
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels.flash_attention.ops import (attention_flops,
                                                    flash_attention,
                                                    visible_pairs)
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (collective_bytes,
                                             while_trip_counts)
from repro_torch.launch.hlo_flops import (DotFlops, collective_breakdown,
                                          dot_flops)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
TIMEOUT_S = 300
CELLS = [f"{a}.{s}" for a, s in J.CELLS]
REAL_CELLS = [f"{a}.{s}" for a, s in R.DRYRUN_REAL_CELLS]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [TESTS, SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Starts the JAX subprocess, the fake dry run and the real world of
    4, which run while the in-process tests do; yields (output directory,
    processes) and kills what is left."""
    out = tmp_path_factory.mktemp("dryrun")
    codes = [f"import torch_sharded_ranks as r; r.dryrun_real({rank}, "
             f"{R.WORLD}, {str(out / 'store')!r}, {str(out)!r})"
             for rank in range(R.WORLD)]
    codes.append(f"import torch_sharded_ranks as r; r.dryrun_fake("
                 f"{str(out)!r}, {list(J.CELLS)!r})")
    procs = []
    try:
        for code in codes:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=_env(), cwd=TESTS,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_dryrun_jax.py"),
             str(out / "jax.json")], cwd=TESTS, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu")))
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def spawned(launched):
    out, procs = launched
    logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n" \
                                  f"{log[-4000:]}"
    return out


@pytest.fixture(scope="module")
def records(spawned):
    def load(name):
        with open(spawned / name) as f:
            return json.load(f)
    return (load("jax.json"), load("fake.json"),
            [load(f"real{r}.json") for r in range(R.WORLD)])


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def test_skip_records_are_the_jax_packages(records, tmp_path):
    jax_rec = records[0]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            want = jax_rec["skips"][f"{arch}.{shape}"]
            if want is None:
                assert dryrun.shape_is_supported(
                    get_config(arch), SHAPES[shape]) is None
                continue
            rec = dryrun.lower_cell(arch, shape, False, device="cpu")
            assert rec == dict(arch=arch, shape=shape, mesh="16x16",
                               status="skipped", reason=want)
    assert sum(v is not None for v in jax_rec["skips"].values()) == 5
    dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                 "--multi-pod", "--device", "cpu", "--out", str(tmp_path)])
    with open(tmp_path / "granite-3-2b.long_500k.pod2.json") as f:
        assert json.load(f)["status"] == "skipped"
    assert dryrun.OUT_DIR == os.path.join("artifacts", "dryrun_torch")


@pytest.mark.parametrize("cell", CELLS)
def test_state_and_local_shapes_are_the_jax_packages(records, cell):
    want, got = records[0][cell], records[1][cell]
    for key in ("model_params", "model_active_params", "state_bytes_global",
                "state_bytes_per_chip"):
        assert got[key] == want[key], key
    assert got["local_shapes"] == want["local_shapes"]


#: how the port's dot FLOPs outside kernels 12 and 12b (the record's
#: ``dot_flops_by_op``: mm, bmm and the rest) stand to the JAX HLO's less
#: its attention's (``dot_flops_fused``, and for a train cell with
#: attention ``dot_flops_attention_free``, the blockwise attention
#: replaced by a stand-in without products).  The JAX package's own
#: ``dot_flops`` does not enter fused computations, where XLA's CPU
#: backend puts a decode's small products; ``dot_flops_fused`` does.
def _expect(cell, mm, bmm, other, jax_flops):
    if cell in ("granite-3-2b.train_4k", "granite-3-2b.decode_32k",
                "h2o-danube-3-4b.long_500k", "mixtral-8x22b.train_4k"):
        # the same products, rank for rank: exact.  At batch 1 (h2o's
        # long_500k) each projection contracts or writes the rank's
        # columns of d (the FSDP split of "embed" kept over data) and its
        # partial sums are all-reduced; mixtral's gspmd MoE routes each
        # data rank's own tokens and runs the experts on the rank's
        # columns of d, as XLA's partitioner does
        return mm + bmm + other == jax_flops
    if cell == "recurrentgemma-2b.decode_32k":
        # the projections exactly; at one kv head XLA lowers the local
        # layers' decode scores and context (the port's bmm) as
        # multiply-reduce, which no dot count sees
        return mm == jax_flops and bmm > 0
    if cell == "xlstm-350m.train_4k":
        # the recurrent cells' per-step products under autograd and under
        # XLA's scan transpose (which products each recomputes and
        # differentiates): within 1.5%
        return abs(mm + bmm + other - jax_flops) <= 0.015 * jax_flops
    raise KeyError(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_dot_flops_outside_attention_against_the_jax_hlo(records, cell):
    j, got = records[0][cell], records[1][cell]
    jax_flops = (j.get("dot_flops_attention_free")
                 or j["dot_flops_fused"])["flops"]
    by_op = dict(got["dot_flops_by_op"])
    attention = sum(by_op.pop(f"repro_torch.{op}", 0)
                    for op in ("flash_attention", "flash_attention_lse",
                               "flash_attention_backward"))
    assert attention == got["dot_flops_attention_per_chip"]
    mm = by_op.pop("aten.mm", 0) + by_op.pop("aten.addmm", 0)
    bmm = by_op.pop("aten.bmm", 0)
    other = sum(by_op.values())
    assert got["dot_flops_per_chip"] == mm + bmm + other + attention
    assert _expect(cell, mm, bmm, other, jax_flops), \
        (cell, mm, bmm, other, jax_flops)
    # recorded, not asserted: the two partitioners' collectives
    print(cell, "collective bytes/chip: port",
          got["collective_bytes_per_chip"], "JAX", j["collective_bytes"])


# ---------------------------------------------------------------------------
# the fake process group against a real one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", REAL_CELLS)
def test_fake_run_counts_the_real_world_of_4(records, cell):
    fake = records[1][cell]
    for real in records[2]:
        got = real[cell]
        for key in ("collective_bytes_per_chip", "collective_counts_per_chip",
                    "dot_flops_per_chip", "dot_bytes_per_chip", "num_dots",
                    "dot_flops_by_op", "local_shapes", "state_bytes_global"):
            assert got[key] == fake[key], key
    assert fake["collective_counts_per_chip"]


# ---------------------------------------------------------------------------
# kernels 12 and 12b's formulas
# ---------------------------------------------------------------------------
def _hand_pairs(sq, skv, causal, window, kv_offset):
    n = 0
    for r in range(sq):
        a = r + kv_offset
        for c in range(skv):
            if causal and c > a:
                continue
            if window and c <= a - window:
                continue
            n += 1
    return n


FORMULA_CASES = [(37, 37, True, None, 0), (37, 37, True, 5, 0),
                 (8, 40, True, None, 32), (8, 40, True, 16, 32),
                 (19, 23, False, None, 0), (1, 50, True, 7, 49),
                 (30, 30, True, 64, 0)]


@pytest.mark.parametrize("sq,skv,causal,window,kv_offset", FORMULA_CASES)
def test_attention_formulas_count_the_visible_pairs(sq, skv, causal, window,
                                                    kv_offset):
    pairs = _hand_pairs(sq, skv, causal, window, kv_offset)
    assert visible_pairs(sq, skv, causal, window, kv_offset) == pairs
    b, hq, hkv, d = 2, 4, 2, 8
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((b, hq, sq, d), generator=gen, requires_grad=True)
    k = torch.randn((b, hkv, skv, d), generator=gen, requires_grad=True)
    v = torch.randn((b, hkv, skv, d), generator=gen, requires_grad=True)
    with DotFlops() as fwd:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              kv_offset=kv_offset, block_q=16, block_k=16)
    with DotFlops() as bwd:
        out.sum().backward()
    assert fwd.attention_flops == fwd.flops == 4 * d * b * hq * pairs
    assert bwd.attention_flops == 10 * d * b * hq * pairs
    assert attention_flops((b, hq, sq, d), (b, hkv, skv, d), causal, window,
                           kv_offset, 4) == fwd.flops
    with torch.no_grad(), DotFlops() as serve:
        flash_attention(q, k, v, causal=causal, window=window,
                        kv_offset=kv_offset)
    assert serve.by_op == {"repro_torch.flash_attention":
                           [1, 4 * d * b * hq * pairs]}


# ---------------------------------------------------------------------------
# in-process: full-size fake init, the counters' entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,uncounted", [("recurrentgemma-2b",
                                             117_918_720),
                                            ("xlstm-350m", -75_423_744)])
def test_full_size_fake_init_holds_the_uncounted_params(arch, uncounted):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import init_params
    cfg = get_config(arch)
    with FakeTensorMode():
        params = init_params(cfg, None, "cpu")
        n = sum(t.numel() for _, t in dryrun.leaves(params))
    assert cfg.uncounted_params() == uncounted
    assert n == cfg.num_params() + uncounted


def test_counters_without_a_mesh():
    a, b = torch.ones((3, 5)), torch.ones((5, 7))
    assert dot_flops(lambda: a @ b) == {"flops": 2.0 * 3 * 5 * 7,
                                        "dot_bytes": 4.0 * (15 + 35 + 21),
                                        "num_dots": 1}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        xf = torch.empty((2, 3, 5), dtype=torch.bfloat16)
        yf = torch.empty((2, 5, 4), dtype=torch.bfloat16)
        with DotFlops() as df:
            torch.bmm(xf, yf, out_dtype=torch.float32)
            torch.mm(xf[0], yf[0], out_dtype=torch.float32)
    assert df.by_op == {"aten.bmm": [1, 2 * 2 * 3 * 5 * 4],
                        "aten.mm": [1, 2 * 3 * 5 * 4]}
    assert collective_bytes(lambda: a @ b) == {"total": 0.0}
    assert collective_breakdown(lambda: a @ b) == []
    assert while_trip_counts() == []
    assert np.isfinite(df.bytes_accessed)
