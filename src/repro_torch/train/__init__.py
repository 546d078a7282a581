"""Training, serving and evaluation loops with EARL integrated: the train
and grad steps, the eval, prefill and decode steps and early-accurate
evaluation (EarlEval)."""
from repro_torch.train.earl_eval import EarlEval, LossValuesSampler
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_decode_step, make_eval_step,
                                     make_grad_step, make_prefill_step,
                                     make_train_step)

__all__ = ["TrainState", "init_train_state", "make_decode_step",
           "make_eval_step", "make_grad_step", "make_prefill_step",
           "make_train_step", "EarlEval", "LossValuesSampler"]
