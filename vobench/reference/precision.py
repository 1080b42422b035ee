"""The control's lowered precision (see the package docstring)."""

from __future__ import annotations

import contextlib

import torch

# read by ops/pyramid.py and models/superpoint.py at each call
LOWERED = {"tf32": False, "fp8": False}

_FP8_MAX = 448.0  # largest finite float8 e4m3 value


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one per-tensor scale, back in x's dtype."""
    scale = torch.clamp(x.detach().abs().amax().to(torch.float32), min=1e-12) / _FP8_MAX
    q = (x.to(torch.float32) / scale).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) * scale).to(x.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, with TF32-rounded operands under `lowered()`."""
    if LOWERED["tf32"]:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


@contextlib.contextmanager
def lowered(tf32: bool = True, fp8: bool = False):
    """Run the reference one precision step down while inside."""
    saved = dict(LOWERED), torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    LOWERED.update(tf32=tf32, fp8=fp8)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        LOWERED.update(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
