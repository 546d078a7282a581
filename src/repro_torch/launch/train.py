"""The training entry point, the JAX package's ``repro/launch/train.py``.

Wires together: the config registry, the data pipeline, AdamW (updating
in place), checkpointing (restart-safe), EARL-adaptive gradient
accumulation and early-accurate eval: the EARL technique as a
first-class feature of the training loop.  It runs on the card unless
``--device cpu``; the flags are the JAX package's, in its order, with
``--device`` last.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT \\
        [--eval-every 25] [--adaptive-accum] [--resume] [--device cpu]

``main`` prints the JAX package's lines and returns its dict (steps,
wall_s, history) with two more entries: ``ckpt`` (saves, seconds spent
saving and waiting for the writes, bytes of the last checkpoint) and
``evals`` (each EarlEval's model forwards and full-pass forwards).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import synthetic_tokens
from repro_torch.data.pipeline import EvalSamplePipeline, TokenBatchPipeline
from repro_torch.device import resolve_device
from repro_torch.models import num_params
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.adaptive_accum import earl_accumulate_gradients
from repro_torch.train import EarlEval, make_eval_step, make_train_step
from repro_torch.train.steps import init_train_state, make_grad_step


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--override", default=None,
                    help="JSON ModelConfig overrides (e.g. custom dims)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--docs", type=int, default=4096)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-sigma", type=float, default=0.01)
    ap.add_argument("--adaptive-accum", action="store_true",
                    help="EARL bootstrap-CI gradient accumulation")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.override:
        cfg = dataclasses.replace(cfg, **json.loads(args.override))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          state_dtype=cfg.adam_dtype)

    key = trandom.PRNGKey(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(gen, cfg, opt_cfg, device=dev)
    n_params = num_params(state.params)[0]
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    docs = synthetic_tokens(args.docs, args.seq + 1, cfg.vocab,
                            seed=args.seed)
    pipeline = TokenBatchPipeline(docs, batch=args.batch, seq_len=args.seq,
                                  seed=args.seed, device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    ckpt = {"saves": 0, "seconds": 0.0, "bytes": 0}

    def save(step: int) -> None:
        t = time.perf_counter()
        mgr.save(step, state, extra={"step": step,
                                     "pipeline": pipeline.state_dict()})
        mgr.wait()
        ckpt["seconds"] += time.perf_counter() - t
        ckpt["saves"] += 1
        ckpt["bytes"] = _dir_bytes(os.path.join(args.ckpt_dir,
                                                f"ckpt_{step:08d}"))

    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state, extra = mgr.restore(state)
        pipeline.load_state_dict(extra["pipeline"])
        start_step = extra["step"]
        print(f"[train] resumed from step {start_step}")

    train_step = make_train_step(cfg, opt_cfg)
    grad_step = make_grad_step(cfg)
    eval_step = make_eval_step(cfg)

    history, evals = [], []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        if args.adaptive_accum:
            mbs = []
            for _ in range(args.microbatches):
                tokens, labels = pipeline.next_batch()
                mbs.append({"tokens": tokens, "labels": labels})
            grads, decision = earl_accumulate_gradients(
                grad_step, state.params, mbs, sigma=0.02)
            _, _, m = adamw_update(state.params, grads, state.opt, opt_cfg)
            del grads
            metrics = {"loss": decision.mean_loss, **m,
                       "micro_used": decision.microbatches_used,
                       "grad_cv": decision.cv}
        else:
            tokens, labels = pipeline.next_batch()
            state, metrics = train_step(state,
                                        {"tokens": tokens, "labels": labels})
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics.get("loss", float("nan")))
            extra_s = (f" micro={metrics['micro_used']}"
                       if "micro_used" in metrics else "")
            print(f"[train] step {step:5d} loss={loss:.4f}"
                  f" gnorm={float(metrics['grad_norm']):.3f}{extra_s}")
        history.append({k: float(v) if hasattr(v, "item") or
                        isinstance(v, (int, float)) else v
                        for k, v in metrics.items()})

        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)

        if args.eval_every and (step + 1) % args.eval_every == 0:
            eval_docs = synthetic_tokens(2048, args.seq + 1, cfg.vocab,
                                         seed=args.seed + 1)
            ev = EarlEval(eval_step, state.params,
                          EvalSamplePipeline(eval_docs, seq_len=args.seq,
                                             device=dev),
                          sigma=args.eval_sigma, eval_batch=args.batch * 4,
                          device=dev)
            res = ev.run(trandom.fold_in(key, step))
            info = res.history[-1]
            evals.append({"step": step + 1,
                          "model_forwards": info["model_forwards"],
                          "full_pass_forwards": info["full_pass_forwards"]})
            print(f"[earl_eval] step {step + 1}: "
                  f"loss={float(torch.as_tensor(res.result).reshape(-1)[0]):.4f}"
                  f"±cv {res.cv:.4f} "
                  f"using {info['model_forwards']}/{info['full_pass_forwards']}"
                  f" forwards ({info['full_pass_forwards'] / max(info['model_forwards'], 1):.1f}x saved)")

    save(args.steps)
    mgr.close()
    wall = time.perf_counter() - t0
    print(f"[train] done: {args.steps - start_step} steps in {wall:.1f}s")
    return {"steps": args.steps, "wall_s": wall, "history": history,
            "ckpt": ckpt, "evals": evals}


if __name__ == "__main__":
    main()
