"""Serving and evaluation loops with EARL integrated: the eval, prefill
and decode steps and early-accurate evaluation (EarlEval)."""
from repro_torch.train.earl_eval import EarlEval, LossValuesSampler
from repro_torch.train.steps import (make_decode_step, make_eval_step,
                                     make_prefill_step)

__all__ = ["make_decode_step", "make_eval_step", "make_prefill_step",
           "EarlEval", "LossValuesSampler"]
