"""The benchmark's plain reference: a frozen copy of the port's plain routes.

Copied from `visualodometry_tpu_torch` when the benchmark was defined and
kept here, where later changes to the program cannot move it: the SIFT and
SuperPoint extractors, the kNN + Lowe matcher, the VO step with its state,
RANSAC estimators and geometry. Only the plain PyTorch version of each
kernel is kept (K1: distance matrix + masked reductions; K2: one flat
gather; the pyramid's band matmuls), so nothing here builds or launches a
hand-written kernel, and nothing here imports the program.

`precision.lowered()` runs the reference one precision step below what
the configuration states, for the control of the correctness check
(vobench/harness/judge.py): float32 products as TF32 (operands rounded to
TF32's 10-bit mantissa in the pyramid's band matmuls on every device, and
cuBLAS / cuDNN allowed TF32 on CUDA), and the bf16 SuperPoint network's
weights and activations rounded through float8 (e4m3, per-tensor scale).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
