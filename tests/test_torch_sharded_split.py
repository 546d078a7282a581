"""The FSDP split of "embed" kept where the activation has no data split
(``models/sharded.py``): the gspmd MoE and batch-1 decode on the CPU.

With the module, five fresh interpreters start (none forks this process):

* a gloo world of 4 (data 2 x model 2) running
  tests/torch_sharded_split_ranks.py's ``main``;
* a JAX subprocess on 4 forced host devices running
  tests/torch_sharded_split_jax.py: the JAX package's 2 x 2 program from
  the same numpy params and tokens.

Held, at tests/test_torch_sharded.py's tolerances (logits within 1e-5 of
the largest unsharded logit; loss and grad_norm within 1e-5 relative;
gradients within 3e-5 of each leaf's largest entry):

* mixtral-8x22b under ``moe_impl="gspmd"`` at capacity 1.25 (slots drop),
  prefilled at batch 4 (the batch split over data) and at batch 1 (d
  split over data): the logits against the unsharded prefill's; each MoE
  layer's kept slots, and its router logits, bitwise those of the
  unsharded route of the same input, and its kept slots bitwise the
  unsharded prefill's;
* one mixtral grad step under TRAIN_RULES against the unsharded one and
  against the JAX package's 2 x 2 grad step;
* h2o-danube-3-4b's batch-1 decode with "embed" split over data (the
  stream d-split at every sublayer) against the unsharded decode and the
  JAX package's 2 x 2 decode;
* every architecture's smoke config at batch 1 (the stream d-split at
  every sublayer of each kind): one grad step under TRAIN_RULES, and a
  prefill with 2 greedy decode steps under SERVE_RULES, against the
  unsharded ones;
* no all-gather in a batch-1 decode step or a MoE layer (CommDebugMode:
  all-reduces and all-to-alls only);
* each product's local operands, as (batch, M, K, N), those of the JAX
  package's compiled HLO at the dry run's smoke cells: h2o-danube-3-4b's
  ``long_500k`` decode step and mixtral-8x22b's MoE layer in
  ``train_4k``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
import torch_sharded_split_ranks as S
from repro_torch.configs import ARCH_IDS

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
TIMEOUT_S = 300


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [TESTS, SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The output directory once the world of 4 and the JAX subprocess
    exited 0 within their timeout; kills what is left."""
    out = tmp_path_factory.mktemp("sharded_split")
    procs = []
    try:
        for rank in range(R.WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"import torch_sharded_split_ranks as r; r.main({rank}, "
                 f"{R.WORLD}, {str(out / 'store')!r}, {str(out)!r})"],
                env=_env(), cwd=TESTS, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "torch_sharded_split_jax.py"),
             str(out)], cwd=TESTS, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu")))
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        for i, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"process {i} exited {p.returncode}:" \
                                      f"\n{log[-4000:]}"
        yield out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(spawned):
    out = []
    for rank in range(R.WORLD):
        with open(spawned / f"rank{rank}.json") as f:
            out.append(json.load(f))
    assert sorted(tuple(r["coordinate"]) for r in out) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    return out


@pytest.fixture(scope="module")
def arrays(spawned):
    with np.load(spawned / "port.npz") as z:
        port = {k: z[k] for k in z.files}
    with np.load(spawned / "jax.npz") as z:
        want = {k: z[k] for k in z.files}
    return port, want


def _within(pair):
    got, bound = pair
    return got <= bound


@pytest.mark.parametrize("b", [S.MOE_B, 1])
def test_moe_prefill_matches_the_unsharded_prefill(ranks, b):
    for res in ranks:
        case = res[f"moe_b{b}"]
        assert _within(case["logit_err"]), case["logit_err"]
        layers = case["layers"]
        assert len(layers) == 2
        want = ["S(0)", "R"] if b == S.MOE_B else ["S(2)", "R"]
        assert all(lay["stream"] == want for lay in layers), layers
        # capacity 1.25 drops slots at this size
        assert sum(lay["dropped"] for lay in layers) > 0


@pytest.mark.parametrize("b", [S.MOE_B, 1])
def test_moe_kept_slots_are_bitwise_the_unsharded_routes(ranks, b):
    for res in ranks:
        for lay in res[f"moe_b{b}"]["layers"]:
            assert lay["kept_as_same_input"], lay
            assert lay["logits_max_diff"] == 0.0, lay
            assert lay["kept_as_unsharded_run"], lay


@pytest.mark.parametrize("case", [f"moe_b{S.MOE_B}", "moe_b1", "decode"])
def test_no_all_gather_in_the_moe_route_or_batch1_decode(ranks, case):
    for res in ranks:
        comms = res[case]["comms"]
        assert comms
        for c in comms:
            assert set(c) <= {"all_reduce", "all_to_all_single"}, c
            assert c.get("all_reduce", 0) > 0
            if case != "decode":
                assert c["all_to_all_single"] == 2, c


def test_moe_grad_step_matches_the_unsharded_step(ranks):
    for res in ranks:
        g = res["moe_grad"]
        assert _within(g["loss"]) and _within(g["grad_norm"]), g
        assert g["grad_share"] <= g["grad_bound"], g


def test_moe_grad_step_matches_the_jax_packages(arrays):
    port, want = arrays
    grads = [k for k in want if k.startswith("grad/")]
    assert grads and set(grads) == {k for k in port if k.startswith("grad/")}
    for key in ("loss", "grad_norm"):
        assert abs(float(port[key]) - float(want[key])) <= \
            R.LOSS_REL * abs(float(want[key])), key
    for key in grads:
        g, w = port[key], want[key]
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= R.STATE_REL * scale, key


def test_batch1_decode_keeps_d_split_and_matches_the_unsharded(ranks):
    for res in ranks:
        case = res["decode"]
        assert case["streams"] == [["S(2)", "R"]]
        assert len(case["logit_errs"]) == S.DECODE_STEPS
        assert all(_within(e) for e in case["logit_errs"]), \
            case["logit_errs"]


def test_batch1_decode_matches_the_jax_packages(arrays):
    port, want = arrays
    vocab = S.decode_config().vocab
    got, ref = port["decode_logits"], want["decode_logits"]
    assert got.shape == ref.shape == (S.DECODE_STEPS, 1, got.shape[-1])
    for i in range(S.DECODE_STEPS):
        bound = R.LOGIT_REL * float(np.abs(ref[i][..., :vocab]).max())
        assert float(np.abs(got[i][..., :vocab] - ref[i][..., :vocab])
                     .max()) <= bound, i
        assert bool((got[i][..., vocab:] == ref[i][..., vocab:]).all())


@pytest.mark.parametrize("cell", [f"{a}.{s}" for a, s in S.SHAPE_CELLS])
def test_local_products_are_the_jax_hlos(spawned, ranks, cell):
    with open(spawned / "jax_dots.json") as f:
        want = [tuple(d) for d in json.load(f)[cell]]
    assert want
    for res in ranks:
        assert [tuple(d) for d in res["shapes"][cell]] == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch1_grad_and_serving_steps_match_the_unsharded(ranks, arch):
    for res in ranks:
        case = res[f"batch1:{arch}"]
        assert _within(case["loss"]) and _within(case["grad_norm"]), case
        assert case["grad_share"] <= R.STATE_REL, case
        assert len(case["logit_errs"]) == 1 + R.DECODE_STEPS
        assert all(_within(e) for e in case["logit_errs"]), \
            case["logit_errs"]
