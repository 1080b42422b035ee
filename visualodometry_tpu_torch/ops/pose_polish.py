"""PnP's IRLS Gauss-Newton pose polish: a CUDA kernel and its plain version.

`_finish_pnp` (estimation/pnp.py) polishes the RANSAC winner by a few
rounds of truncated-Huber reweighting, each followed by damped
Gauss-Newton iterations (`refine_pose_gn`). The JAX package has no Pallas
kernel for it: under `jit`, XLA fuses the loop. Run eagerly, the plain
version `_polish_pose_torch` is ~300 launches per Gauss-Newton iteration,
4,475 on the card for the default 3 rounds of 8 + 3 + 3 iterations;
csrc/pose_polish.cu runs the whole loop in one launch, one thread block a
problem (the kernel's header says where the two may differ in the last
bits).

CPU tensors take the plain version; CUDA float32 tensors launch the
kernel. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.utils import profiling

# points the kernel holds weights for in shared memory (4 bytes each, of
# the 227 KB an H100 block may have)
MAX_POINTS = 49152

# calls that reached the kernel since the last reset (a plain count; callers
# zero it). One call is one launch.
launches = 0


def _polish_pose_torch(T0, pts3d, uv, valid, K, delta, cut_sq, rounds, iters):
    """Plain version: `rounds` truncated-Huber reweightings from the
    current pose, each followed by `refine_pose_gn`, `iters` iterations in
    the first round and max(3, iters // 3) in each later one."""
    # imported here: estimation/pnp.py imports this module
    from visualodometry_tpu_torch.estimation.pnp import _reproj_err_sq, refine_pose_gn

    T_out = T0
    for rnd in range(max(1, rounds)):
        err_sq_r, z_r = _reproj_err_sq(T_out[:3, :3], T_out[:3, 3], pts3d, uv, K)
        r = torch.sqrt(torch.clamp(err_sq_r, min=1e-12))
        w = (
            torch.clamp(delta / r, max=1.0)
            * (err_sq_r < cut_sq)
            * valid
            * (z_r > 0)
        )
        n_iters = iters if rnd == 0 else max(3, iters // 3)
        T_out = refine_pose_gn(T_out, pts3d, uv, w, K, n_iters)
    return T_out


def _check(T0, pts3d, uv, valid, K) -> None:
    n = pts3d.shape[0] if pts3d.dim() == 2 else -1
    shapes = ((T0, (4, 4)), (pts3d, (n, 3)), (uv, (n, 2)), (valid, (n,)), (K, (3, 3)))
    for x, want in shapes:
        if tuple(x.shape) != want:
            raise ValueError(
                "polish_pose: wants T0 (4, 4), pts3d (N, 3), uv (N, 2), valid (N,) "
                f"and K (3, 3), got {[tuple(x.shape) for x, _ in shapes]}"
            )
    if len({x.device for x, _ in shapes}) != 1:
        raise ValueError(
            f"polish_pose: inputs on several devices {[x.device for x, _ in shapes]}"
        )
    if valid.dtype != torch.bool:
        raise TypeError(f"polish_pose: valid must be bool, got {valid.dtype}")
    if T0.device.type == "cpu":
        return
    for x in (T0, pts3d, uv, K):
        if x.dtype != torch.float32:
            raise TypeError(f"polish_pose: float32 only off the CPU, got {x.dtype}")
    if T0.device.type != "cuda":
        raise ValueError(f"polish_pose: unsupported device {T0.device}")
    if not all(x.is_contiguous() for x, _ in shapes):
        raise ValueError("polish_pose: inputs must be contiguous")
    if n > MAX_POINTS:
        raise ValueError(f"polish_pose: {n} points, the kernel holds {MAX_POINTS}")


def polish_pose(T0, pts3d, uv, valid, K, delta: float, cut_sq: float, rounds: int,
                iters: int) -> torch.Tensor:
    """The IRLS-polished camera-from-world pose (4, 4), from `T0` over the
    correspondences pts3d (N, 3) <-> uv (N, 2) where valid (N,) holds.

    Each of max(1, rounds) rounds weighs a point by
    min(delta / r, 1) where its reprojection error r is under sqrt(cut_sq)
    and its depth positive, then runs `iters` damped Gauss-Newton
    iterations (max(3, iters // 3) after the first round).

    CPU tensors take the plain version; CUDA float32 tensors, which must
    be contiguous, are one launch of csrc/pose_polish.cu on the current
    stream, with no host read.
    """
    global launches
    _check(T0, pts3d, uv, valid, K)
    if T0.device.type == "cpu":
        return _polish_pose_torch(T0, pts3d, uv, valid, K, delta, cut_sq, rounds, iters)
    out = torch.empty((4, 4), dtype=torch.float32, device=T0.device)
    err = _build.c_function("pose_polish", "pose_polish_launch")(
        T0.data_ptr(), pts3d.data_ptr(), uv.data_ptr(), valid.data_ptr(), K.data_ptr(),
        out.data_ptr(), pts3d.shape[0], max(1, rounds), iters, max(3, iters // 3),
        delta, cut_sq, _build.current_stream_handle(T0.device),
    )
    _build.check_launch("pose_polish", err)
    launches += 1
    profiling.count("pose_polish.launch")
    return out
