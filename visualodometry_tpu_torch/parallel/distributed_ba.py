"""Distributed Schur BA: landmark blocks sharded over the mesh's "map" axis.

Port of visualodometry_tpu/parallel/distributed_ba.py. Every term of the
reduced pose system (S, rhs) is a sum over landmarks, so each rank takes its
L / n_map block of (X, uv, mask), computes `landmark_contributions` of it,
all-reduces S and rhs over the axis's process group (one all-reduce of
P·P·36 + P·6 floats a Gauss-Newton iteration, the whole communication of
the solve), runs the small dense solve replicated, and back-substitutes its
own block. The JAX function returns global arrays; here every rank gets the
whole problem back: the landmark blocks are gathered by one more all-reduce
of zero-padded (L, 3) blocks, exact since each entry is one block's value
plus zeros. (An all-reduce, not an all-gather, because the gloo backend
takes CUDA tensors only in `broadcast` and `all_reduce`, and the gloo
route is how two ranks share one card: NCCL refuses two ranks on one GPU.)

On a mesh without process groups (one rank) it is `ba_solve` bit for bit.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.ba.solver import (
    BAProblem,
    apply_updates,
    landmark_contributions,
    reduced_solve,
)
from visualodometry_tpu_torch.parallel.mesh import Mesh


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(x, group=group)
    return x


def ba_solve_distributed(
    prob: BAProblem,
    mesh: Mesh,
    iters: int = 8,
    damping: float = 1e-3,
    fixed_poses: int = 2,
    axis: str = "map",
) -> BAProblem:
    """Mesh-sharded BA solve: `ba_solve`'s iterations with the landmark sums
    all-reduced over `axis`. Every rank passes the whole problem (on its
    mesh's device) and gets the whole solved problem back. Raises
    ValueError when L is not divisible by the axis size."""
    n_shards = mesh.shape[axis]
    L = prob.X.shape[0]
    if L % n_shards:
        raise ValueError(
            f"landmark count {L} not divisible by mesh axis '{axis}' of size {n_shards}"
        )
    group = mesh.group(axis)
    block = L // n_shards
    rows = slice(mesh.coord(axis) * block, (mesh.coord(axis) + 1) * block)
    T, X = prob.T_cw, prob.X[rows]
    uv, mask = prob.uv[rows], prob.mask[rows]
    for _ in range(iters):
        contrib = landmark_contributions(T, X, uv, mask, prob.K, damping)
        S, rhs = contrib.S, contrib.rhs
        if group is not None:
            flat = _all_reduce(torch.cat([S.reshape(-1), rhs.reshape(-1)]), group)
            S, rhs = flat[: S.numel()].view_as(S), flat[S.numel() :].view_as(rhs)
        delta_pose = reduced_solve(S, rhs, damping, fixed_poses)
        T, X = apply_updates(T, X, delta_pose, contrib)
    if group is not None:
        full = torch.zeros_like(prob.X)
        full[rows] = X
        X = _all_reduce(full, group)
    return prob._replace(T_cw=T, X=X)
