"""The P3P minimal solver on the card: the launch of csrc/p3p.cu.

`p3p_grunert` (estimation/p3p.py) keeps its plain version,
`_p3p_grunert_torch`, as the CPU route and as the kernel's contract. The
JAX package has no Pallas kernel for it: under `jit`, XLA fuses the solve.
Run eagerly, the plain version is one launch per operation, ~4,050 a call
at 512 samples, ~3,690 of them Durand-Kerner's; csrc/p3p.cu solves every
sample in one launch, one thread a sample, in the plain version's
operation order (the kernel's header says where the two may still differ
in the last bits).

CPU tensors take the plain version; CUDA float32 tensors launch the
kernel. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.utils import profiling

# calls that reached the kernel since the last reset (a plain count; callers
# zero it). One call is one launch.
launches = 0


def check(X: torch.Tensor, xy: torch.Tensor) -> None:
    """Raise unless X (H, 3, 3) and xy (H, 3, 2) are contiguous float32
    tensors on one device, the CPU or a CUDA device."""
    H = X.shape[0] if X.dim() == 3 else -1
    if tuple(X.shape) != (H, 3, 3) or tuple(xy.shape) != (H, 3, 2):
        raise ValueError(
            f"p3p_grunert: wants X (H, 3, 3) and xy (H, 3, 2), got {tuple(X.shape)} "
            f"and {tuple(xy.shape)}"
        )
    if X.dtype != torch.float32 or xy.dtype != torch.float32:
        raise TypeError(f"p3p_grunert: float32 only, got {X.dtype} and {xy.dtype}")
    if X.device != xy.device:
        raise ValueError(f"p3p_grunert: inputs on two devices, {X.device} and {xy.device}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"p3p_grunert: unsupported device {X.device}")
    if not (X.is_contiguous() and xy.is_contiguous()):
        raise ValueError("p3p_grunert: inputs must be contiguous")


def p3p_cuda(X: torch.Tensor, xy: torch.Tensor, vs: torch.Tensor, vander_inv_t: torch.Tensor,
             seeds: torch.Tensor):
    """One launch of csrc/p3p.cu on the current stream, with no host read:
    (R (H, 4, 3, 3), t (H, 4, 3), ok (H, 4)) for CUDA inputs that passed
    `check`. vs (5,), vander_inv_t (5, 5) and seeds (4,) complex64 are the
    plain version's constants on the same device."""
    global launches
    H = X.shape[0]
    R = torch.empty((H, 4, 3, 3), dtype=torch.float32, device=X.device)
    t = torch.empty((H, 4, 3), dtype=torch.float32, device=X.device)
    ok = torch.empty((H, 4), dtype=torch.bool, device=X.device)
    if H == 0:
        return R, t, ok
    err = _build.c_function("p3p", "p3p_launch")(
        X.data_ptr(), xy.data_ptr(), vs.data_ptr(), vander_inv_t.data_ptr(), seeds.data_ptr(),
        R.data_ptr(), t.data_ptr(), ok.data_ptr(), H, _build.current_stream_handle(X.device),
    )
    _build.check_launch("p3p", err)
    launches += 1
    profiling.count("p3p.launch")
    return R, t, ok
