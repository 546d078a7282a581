"""Traffic ``train``: a pre-training job's steps.  Each step is the port's
``make_train_step`` (``value_and_grad`` of the loss, then AdamW in place,
remat as the configuration sets it) on a fresh batch of ``batch`` x
``seq`` tokens drawn from the seed on the card; a step ends when its loss
is on the host, as a job logs it.

Set-up makes the weights, builds the train state (the port's
``TrainState`` with zero AdamW states) and drives it through the first
``ref_steps`` steps, the first of which builds and warms every kernel;
the window takes the same object on.  Step 1 gives the global gradient
norm the step reports (``grad_norm``, before the clip) and each leaf's
gradient norm as the optimizer got it, from AdamW's first moment
(m = (1 - b1)·g after one step, after the clip); the last set-up step
gives each leaf's change from the initial weights.  A stacked leaf counts
a layer at a time.

The judge runs the plain reference (``reference/decoder.py`` with
autograd, ``reference/adamw.py``) on the same weights and the same first
``ref_steps`` batches, and compares the first gradient's global norm
(relative), and the leaves' first gradient norms and change norms by the
worst leaf: the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) are left out of the change.
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np

from cardbench import harness, weights
from cardbench.reference import adamw as radamw
from cardbench.reference import decoder as rdec


def batch(run, step: int):
    """Step ``step``'s batch (1-based): rows that all differ."""
    w = run.work
    t = weights.tokens(run.torch, run.cfg, run.seed, run.device,
                       (w["batch"], w["seq"] + 1), "batch", step)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def slices(tree, torch) -> Dict[str, object]:
    """A params-shaped tree's leaves by name, a stacked leaf a layer at a
    time."""
    out = {}

    def walk(t, path, stacked):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}", stacked or k == "groups")
        elif isinstance(t, (list, tuple)) or stacked:
            for i in range(len(t)):
                out[f"{path}[{i}]"] = t[i]
        else:
            out[path] = t
    walk(tree, "", False)
    return out


def norms(tree, torch) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in slices(tree, torch).items()}


def setup(run) -> None:
    torch, w = run.torch, run.work
    from repro_torch import train as T
    from repro_torch.optim import adamw as A
    opt_cfg = A.AdamWConfig(**w["adamw"])
    params = weights.make_params(torch, run.cfg, run.seed, run.device)
    state = T.TrainState(params=params, opt=A.adamw_init(params, opt_cfg))
    run.state.update(step=T.make_train_step(run.cfg, opt_cfg),
                     train_state=state, opt_cfg=opt_cfg, done=0)
    losses = []
    for s in range(1, w["ref_steps"] + 1):
        metrics = train_step(run)
        losses.append(float(metrics["loss"]))
        if s == 1:
            run.state["grad_norm"] = float(metrics["grad_norm"])
            m = norms(run.state["train_state"].opt.m, torch)
            run.state["grad_norms"] = {k: v / (1.0 - opt_cfg.b1)
                                       for k, v in m.items()}
    p0 = weights.make_params(torch, run.cfg, run.seed, run.device)
    now = slices(run.state["train_state"].params, torch)
    run.state["change_norms"] = {
        k: float(torch.linalg.vector_norm((now[k] - t).double()))
        for k, t in slices(p0, torch).items()}
    del p0, now
    run.state["losses"] = losses


def train_step(run) -> dict:
    """One step; returns its metrics once its loss is on the host."""
    run.state["done"] += 1
    st, m = run.state["step"](run.state["train_state"],
                              batch(run, run.state["done"]))
    run.state["train_state"] = st
    float(m["loss"])
    return m


def window(run) -> None:
    t0 = time.perf_counter()
    ends = []
    while time.perf_counter() - t0 < run.seconds:
        train_step(run)
        ends.append(time.perf_counter())
    w = run.work
    run.rec.update(attempted=len(ends), failed=0, window_s=ends[-1] - t0,
                   step_ends=[e - t0 for e in ends],
                   tokens_per_step=w["batch"] * w["seq"],
                   batch=w["batch"], seq=w["seq"])


def traced(run) -> dict:
    """``traced_steps`` steps as ``make_train_step`` composes them:
    ``value_and_grad``, then ``adamw_update`` between CUDA events."""
    torch = run.torch
    from repro_torch.optim import adamw as A
    from repro_torch.train import steps as S
    adamw_ms = []

    def body():
        for _ in range(run.work["traced_steps"]):
            run.state["done"] += 1
            b = batch(run, run.state["done"])
            st = run.state["train_state"]
            with harness.label(torch, "value_and_grad"):
                grads, metrics = S.value_and_grad(run.cfg, st.params, b)
            with harness.label(torch, "adamw_update"):
                e0 = _mark(run)
                A.adamw_update(st.params, grads, st.opt,
                               run.state["opt_cfg"])
                e1 = _mark(run)
            del grads
            float(metrics["loss"])
            adamw_ms.append((e0, e1))
    trace = harness.traced(run, body)
    run.rec.update(adamw_ms=[_ms(a, b) for a, b in adamw_ms],
                   traced_steps=len(adamw_ms))
    return trace


def _mark(run):
    """A point on the device's timeline, a CUDA event; on the CPU, the
    host's clock."""
    if run.device != "cuda":
        return time.perf_counter()
    e = run.torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _ms(a, b) -> float:
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def judge(run) -> list:
    torch, w = run.torch, run.work
    got = dict(losses=run.state["losses"], grad_norm=run.state["grad_norm"],
               grad_norms=run.state["grad_norms"],
               change_norms=run.state["change_norms"])
    run.free()
    want = reference_steps(run)
    gaps = compare(got, want)
    clip = w["adamw"]["grad_clip"]
    print(f"cardbench: first gradient norm {got['grad_norm']!r}, reference "
          f"{want['grad_norm']!r}; the clip at {clip} "
          f"{'scales it' if want['grad_norm'] > clip else 'leaves it'}",
          file=sys.stderr)
    # the loss is not compared: its gap has no upper reading (PERF.md)
    return [harness.Check(k, gaps[k], lim) for k, lim in w["limits"].items()]


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers of a training cell (the loss's gap beside them)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    g_med = float(np.median(list(want["grad_norms"].values())))
    c_med = float(np.median(list(want["change_norms"].values())))

    def worst(name, med, keep):
        return max(abs(got[name][k] - want[name][k])
                   / max(want[name][k], med) for k in keep)
    counted = [k for k, g in want["grad_norms"].items() if g >= 1e-3 * g_med]
    return {"loss_gap": loss_gap,
            "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"],
            "grad_gap": worst("grad_norms", g_med, want["grad_norms"]),
            "change_gap": worst("change_norms", c_med, counted)}


def reference_steps(run, rnd=rdec.F32, keep_rows=None) -> dict:
    """The plain reference through the first ``ref_steps`` steps: each
    step's loss, the first step's global gradient norm before the clip and
    each leaf's as AdamW takes it, and the change after the last.
    ``keep_rows`` keeps that many rows of each batch (a fault: the mean
    over the rest)."""
    torch, w = run.torch, run.work
    rdec.check_f32()
    model = run.cell.model["run"]
    p0 = weights.make_params(torch, run.cfg, run.seed, run.device)
    # every layer its own leaf, so that no gradient is stacked
    tree = _unstack(p0)
    del p0
    leaves = slices(tree, torch)
    for t in leaves.values():
        t.requires_grad_(True)
    opt = radamw.AdamW(leaves, **w["adamw"])
    losses = []
    for s in range(1, w["ref_steps"] + 1):
        b = batch(run, s)
        toks, labs = b["tokens"], b["labels"]
        if keep_rows is not None:
            toks, labs = toks[:keep_rows], labs[:keep_rows]
        with torch.enable_grad():
            loss = rdec.loss(model, tree, toks, labs, rnd)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        gn = opt.step(dict(zip(leaves, grads)))
        del grads, loss
        if s == 1:
            grad_norm, grad_norms = opt.total, gn
    del opt
    for t in leaves.values():
        t.requires_grad_(False)
    p0 = slices(_unstack(weights.make_params(torch, run.cfg, run.seed,
                                             run.device)), torch)
    change = {k: float(torch.linalg.vector_norm((leaves[k] - p0[k]).double()))
              for k in leaves}
    return dict(losses=losses, grad_norm=grad_norm, grad_norms=grad_norms,
                change_norms=change)


def _unstack(tree):
    """A params tree with each stacked leaf as a list of its layers'
    tensors (copies, each its own leaf)."""
    def walk(t, stacked):
        if isinstance(t, dict):
            return {k: walk(v, stacked or k == "groups") for k, v in t.items()}
        if stacked:
            return [u.clone() for u in t.unbind(0)]
        return t.clone()
    return walk(tree, False)
