"""Monocular visual odometry in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of `visualodometry_tpu` (the JAX engine, which
stays the reference). Module layout and function names mirror the JAX
package so each function's counterpart is easy to find; inside, the code is
plain PyTorch on tensors: `NamedTuple`s of tensors for state, an explicit
`device` at every entry point, an explicit `torch.Generator` for RANSAC
draws, and Python control flow on the host where the JAX engine used
`lax.cond` / `lax.scan`.

Both frontends are ported: SIFT-style extraction and the learned SuperPoint
(`models/superpoint.py`, cell-softmax and dense heads), and both matchers:
kNN + Lowe ratio and the attention matcher (`models/attention_matcher.py`).
The learned models read the JAX package's bundled weight files
(`models/weights.py`, `models/convert.py`).

The three kernels of the SIFT -> kNN -> RANSAC path (top-2 matcher, patch
gather, and the opt-in blur stack of the pyramid) are CUDA C++ for sm_90a
(`csrc/`), built with nvcc at first use and bound through ctypes
(`ops/_build.py`). Each sits beside a plain PyTorch version that the
wrapper runs for CPU tensors.

This package imports neither JAX nor anything of `visualodometry_tpu`.

Precision: float32 matrix products run in full float32. TF32 is switched
off here, at import, because the pyramid's band matmuls feed a DoG
contrast threshold of O(2.5e-3) and TF32 keeps only ~3 decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from visualodometry_tpu_torch.config import (  # noqa: E402,F401
    VOConfig,
    config_from_dict,
    get_config,
)
from visualodometry_tpu_torch._device import resolve_device  # noqa: E402,F401
