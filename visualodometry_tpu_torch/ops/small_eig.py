"""Smallest eigenvector of small symmetric matrices: a CUDA kernel and its
plain version.

`smallest_eigvec` for n >= 4 (geometry/linalg.py sends it here) is shifted
inverse iteration through one Cholesky factor. The JAX package has no
Pallas kernel for it: under `jit`, XLA fuses its chain of batched scalar
operations. Run eagerly, the plain version `_smallest_eigvec_torch` is one
launch per scalar operation, ~920 launches at n = 4 and ~7,700 at n = 12;
csrc/small_eig.cu does the whole batch in one launch, one thread a matrix,
in the plain version's operation order (the kernel's header says where the
two may still differ in the last bits).

CPU tensors take the plain version; CUDA tensors launch the kernel. There
is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.geometry.linalg import (
    _TINY,
    _norm,
    cho_solve_small,
    cholesky_small,
)
from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.utils import profiling

MIN_N, MAX_N = 4, 16  # the kernel's template instantiations

# calls that reached the kernel since the last reset (a plain count; callers
# zero it). One call is one launch.
launches = 0


def _smallest_eigvec_torch(M: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Plain version: shifted inverse iteration through `cholesky_small`.

    The port of the JAX function's n > 3 branch, one batched tensor
    operation per scalar step.
    """
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = (torch.abs(tr) / n) * 1e-6 + 1e-12
    Ms = M + eps[..., None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    L = cholesky_small(Ms)

    v = (1.0 + 0.01 * torch.arange(n, dtype=M.dtype, device=M.device)).expand(
        M.shape[:-1]
    )
    for _ in range(iters):
        v = cho_solve_small(L, v)
        v = v / torch.clamp(_norm(v), min=_TINY)
    return v


def _check(M: torch.Tensor) -> None:
    if M.dtype != torch.float32:
        raise TypeError(f"smallest_eigvec: float32 matrices only, got {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"smallest_eigvec: wants (..., n, n), got {tuple(M.shape)}")
    if not MIN_N <= M.shape[-1] <= MAX_N:
        raise ValueError(
            f"smallest_eigvec: n = {M.shape[-1]} outside {MIN_N} .. {MAX_N}"
        )


def smallest_eigvec(M: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each symmetric
    (..., n, n) float32 matrix, 4 <= n <= 16; returns (..., n).

    CPU tensors take the plain version; a CUDA tensor, which must be
    contiguous, is one launch of csrc/small_eig.cu on the current stream,
    with no host read.
    """
    global launches
    _check(M)
    if M.device.type == "cpu":
        return _smallest_eigvec_torch(M, iters)
    if M.device.type != "cuda":
        raise ValueError(f"smallest_eigvec: unsupported device {M.device}")
    if not M.is_contiguous():
        raise ValueError("smallest_eigvec: matrices must be contiguous")
    n = M.shape[-1]
    out = torch.empty(M.shape[:-1], dtype=torch.float32, device=M.device)
    batch = M.numel() // (n * n)
    if batch == 0:
        return out
    err = _build.c_function("small_eig", "small_eig_launch")(
        M.data_ptr(), out.data_ptr(), batch, n, iters, _build.current_stream_handle(M.device)
    )
    _build.check_launch("small_eig", err)
    launches += 1
    profiling.count("small_eig.launch")
    return out
