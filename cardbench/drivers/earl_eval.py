"""Traffic ``earl_eval``: one client asks, again and again, for a model's
eval loss to the error bound σ with confidence τ; each answer is an
``EarlEval`` run (the port's ``train.EarlEval`` with ``make_eval_step``)
over the same corpus with a fresh session key.  Closed loop: the next
question is asked when the answer (its estimate and c_v, on the host) is
in.

Set-up makes the weights and the corpus (``docs`` documents of
``doc_len`` tokens) from the seed, builds the corpus's eval pipeline and
answers once, which warms every shape an answer uses (its full batches
and its last, shorter one).  The window answers back to back for the
run's seconds; an answer begun inside it is waited for.

The judge, over every answer of the window: (1) every document's loss
that its forwards returned against the plain reference's f32 loss of that
document; (2) the answer's estimate and c_v against the frozen bootstrap
arithmetic (``reference/bootstrap.py``) followed from the answer's own
losses, its B and its sample sizes; (3) the c_v against the session over
the reference's own losses.  (2) holds the session's arithmetic tightly,
(1) and (3) the answer end to end; the estimate, a mean of the losses,
is held end to end by (1) and (2) together.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from cardbench import harness, weights
from cardbench.reference import bootstrap as rboot
from cardbench.reference import decoder as rdec


def _key_seed(run, i: int) -> int:
    return harness.derive(run.seed, "session", i) % (2 ** 31)


def setup(run) -> None:
    torch, w = run.torch, run.work
    from repro_torch.data.pipeline import EvalSamplePipeline
    from repro_torch import train as T
    cfg = run.cfg
    run.state["params"] = weights.make_params(torch, cfg, run.seed,
                                              run.device)
    corpus = weights.tokens(torch, cfg, run.seed, run.device,
                            (w["docs"], w["doc_len"]), "corpus")
    corpus = corpus.to(torch.int32).cpu().numpy()
    run.state["pipeline"] = EvalSamplePipeline(
        corpus, seq_len=w["doc_len"] - 1,
        seed=harness.derive(run.seed, "pipeline") % (2 ** 32),
        device=run.device)
    run.state["eval_step"] = T.make_eval_step(cfg)
    run.state["forwards"] = []
    answer(run, 0)              # warms every shape an answer uses
    run.state["forwards"] = []


def answer(run, i: int, timed=None) -> dict:
    """One question and its answer.  ``timed`` (a list) receives the host
    seconds inside each eval step, each synchronised."""
    from repro_torch import random as trandom
    from repro_torch import train as T
    torch, w = run.torch, run.work
    step, rows = run.state["eval_step"], []

    def eval_step(params, batch):
        if timed is not None:
            run.sync()
            t0 = time.perf_counter()
        with harness.label(torch, "eval_step"):
            out = step(params, batch)
        if timed is not None:
            run.sync()
            timed.append(time.perf_counter() - t0)
        rows.append((batch["tokens"], batch["labels"], out))
        return out

    res = T.EarlEval(eval_step, run.state["params"], run.state["pipeline"],
                     sigma=w["sigma"], tau=w["tau"],
                     eval_batch=w["eval_batch"], device=run.device).run(
        trandom.PRNGKey(_key_seed(run, i)))
    est = float(torch.as_tensor(res.result).reshape(-1)[0])
    ns = [e["n"] for e in res.history if "n" in e]
    forwards = [e["model_forwards"] for e in res.history
                if "model_forwards" in e][0]
    run.state["forwards"].append(rows)
    return dict(estimate=est, cv=float(res.cv), B=int(res.B), ns=ns,
                forwards=int(forwards), key=_key_seed(run, i))


def window(run) -> None:
    answers, spans = [], []
    t0 = time.perf_counter()
    i = 1
    while time.perf_counter() - t0 < run.seconds:
        a = time.perf_counter()
        answers.append(answer(run, i))
        spans.append((a, time.perf_counter()))
        i += 1
    run.state["answers"] = answers
    run.rec.update(
        attempted=len(answers), failed=0, answer_spans=spans,
        window_s=spans[-1][1] - t0,
        forwards=[a["forwards"] for a in answers],
        tokens_per_forward=run.work["doc_len"] - 1)


def traced(run) -> dict:
    n = run.work["traced_answers"]
    walls, inside = [], []

    def body():
        for j in range(n):
            timed = []
            a = time.perf_counter()
            with harness.label(run.torch, "answer"):
                answer(run, 10 ** 6 + j, timed)
            walls.append(time.perf_counter() - a)
            inside.append(sum(timed))
    trace = harness.traced(run, body)
    run.rec["session_s"] = [wa - ins for wa, ins in zip(walls, inside)]
    return trace


def judged(run) -> dict:
    """What the judge holds the window to, taken before the program's
    state is freed: each answer's report and its losses in sample order,
    and the documents they are of."""
    torch = run.torch
    answers = run.state["answers"]
    rows = run.state["forwards"][:len(answers)]
    xs = [torch.cat([o for _, _, o in fw]).double().cpu().numpy()
          for fw in rows]
    # every answer reads the pipeline's rows 0, 1, ... in order, so a row
    # is one document whichever answer read it
    longest = max(rows, key=lambda fw: sum(len(o) for _, _, o in fw))
    return dict(answers=answers, xs=xs,
                toks=torch.cat([t for t, _, _ in longest]),
                labs=torch.cat([lab for _, lab, _ in longest]))


def judge(run) -> list:
    j = judged(run)
    run.free()
    want = reference_losses(run, j["toks"], j["labs"])
    gaps = compare(j["answers"], j["xs"], want)
    print(f"cardbench: B {sorted({a['B'] for a in j['answers']})}, "
          f"reference c_v {gaps.pop('reference_cv')!r}", file=sys.stderr)
    return [harness.Check(k, gaps[k], lim)
            for k, lim in run.work["limits"].items()]


def compare(answers, xs, want) -> dict:
    """The numbers of an EarlEval cell, over every answer: ``loss_gap``,
    the widest |program - reference| of a document's loss (nats);
    ``estimate_gap`` and ``cv_gap``, the answer's estimate and c_v against
    the frozen session followed from the answer's own losses, its B and
    its sample sizes (relative); ``cv_ref_gap``, the c_v against the
    session over the reference's losses of its documents, over the larger
    of the answer's reference c_v and the median answer's (a c_v from few
    resamples can come out near nought by chance).  Also
    ``reference_cv``, each answer's."""
    out = dict.fromkeys(("loss_gap", "estimate_gap", "cv_gap",
                         "cv_ref_gap"), 0.0)
    refs = []
    for a, x in zip(answers, xs):
        mine = want[:len(x)]
        out["loss_gap"] = max(out["loss_gap"],
                              float(np.max(np.abs(x - mine))))
        ref = rboot.session_report(x, a["key"], a["B"], a["ns"])
        out["estimate_gap"] = max(out["estimate_gap"],
                                  abs(a["estimate"] - ref["estimate"])
                                  / abs(ref["estimate"]))
        out["cv_gap"] = max(out["cv_gap"], abs(a["cv"] - ref["cv"])
                            / max(ref["cv"], 1e-30))
        refs.append(rboot.session_report(mine, a["key"], a["B"],
                                         a["ns"])["cv"])
    med = float(np.median(refs))
    out["cv_ref_gap"] = max(abs(a["cv"] - r) / max(r, med, 1e-30)
                            for a, r in zip(answers, refs))
    out["reference_cv"] = refs
    return out


def reference_losses(run, toks, labs, rnd=rdec.F32) -> np.ndarray:
    """The plain reference's loss of each document, a batch at a time."""
    torch = run.torch
    rdec.check_f32()
    params = weights.make_params(torch, run.cfg, run.seed, run.device)
    out = []
    with torch.no_grad():
        for i in range(0, len(toks), run.work["eval_batch"]):
            sl = slice(i, i + run.work["eval_batch"])
            out.append(rdec.per_example_loss(
                run.cell.model["run"], params, toks[sl].to(torch.int64),
                labs[sl], rnd).cpu())
    del params
    return torch.cat(out).double().numpy()
