"""EARL in PyTorch and CUDA: the port of the JAX package ``repro``.

Subpackages mirror ``repro`` (core, data, kernels).  Plain tensor code is
PyTorch; each TPU kernel on the ported path is a hand-written CUDA kernel
for Hopper (kernels/csrc), built with nvcc at first use.  Entry points run
on the card unless the caller passes ``device="cpu"``, which runs each
kernel's plain PyTorch version instead.

The f32 matrix products the path keeps (point-estimate updates) run in
IEEE f32, never TF32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
