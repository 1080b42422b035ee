"""Batched two-view DLT triangulation with quality gates.

Port of visualodometry_tpu/geometry/triangulation.py, including the
camera-2 / unit-baseline conditioning of the DLT solve.
"""

from __future__ import annotations

import math

import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.geometry.camera import project_points_T
from visualodometry_tpu_torch.geometry.linalg import smallest_eigvec


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
) -> torch.Tensor:
    """Linear triangulation of N correspondences -> (N, 3) points."""
    a0 = uv1[:, 0:1] * P1[2] - P1[0]  # (N, 4)
    a1 = uv1[:, 1:2] * P1[2] - P1[1]
    a2 = uv2[:, 0:1] * P2[2] - P2[0]
    a3 = uv2[:, 1:2] * P2[2] - P2[1]
    A = torch.stack([a0, a1, a2, a3], dim=1)  # (N, 4, 4)
    A = A / torch.clamp(
        torch.linalg.vector_norm(A, dim=2, keepdim=True), min=1e-12
    )
    X = smallest_eigvec(A.transpose(1, 2) @ A)  # (N, 4)
    w = X[:, 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:, :3] / w_safe[:, None]


def triangulate_points(
    T_cw1: torch.Tensor,
    T_cw2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    K: torch.Tensor,
    cfg: VOConfig,
    valid_in: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Triangulate + gate (cheirality, reprojection, optional parallax).

    Returns (pts3d (N, 3), valid (N,) bool). The DLT solve runs in a
    conditioned world frame (origin at camera 2's center, unit baseline)
    and the result is mapped back.
    """
    c1 = -(T_cw1[:3, :3].T @ T_cw1[:3, 3])
    c2 = -(T_cw2[:3, :3].T @ T_cw2[:3, 3])
    b = torch.clamp(torch.linalg.vector_norm(c1 - c2), min=1e-9)

    def _cond(T_cw):
        Rt = T_cw[:3, :]
        t_new = (Rt[:, :3] @ c2 + Rt[:, 3]) / b
        return torch.cat([Rt[:, :3], t_new[:, None]], dim=1)

    P1 = K @ _cond(T_cw1)
    P2 = K @ _cond(T_cw2)
    pts3d = b * triangulate_dlt(P1, P2, uv1, uv2) + c2

    proj2, z2 = project_points_T(pts3d, T_cw2, K)
    err2 = torch.linalg.vector_norm(proj2 - uv2, dim=-1)

    valid = (z2 > cfg.min_depth) & (err2 < cfg.max_reproj_err)
    if cfg.min_parallax_deg > 0.0:
        r1 = pts3d - c1
        r2 = pts3d - c2
        cos_a = torch.sum(r1 * r2, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(r1, dim=-1)
            * torch.linalg.vector_norm(r2, dim=-1),
            min=1e-12,
        )
        cos_thr = float(math.cos(math.radians(cfg.min_parallax_deg)))
        valid = valid & (cos_a < cos_thr)
    if valid_in is not None:
        valid = valid & valid_in
    return pts3d, valid
