"""Pinhole camera projection and analytic Jacobians (distortion-free)."""

from __future__ import annotations

import torch


def project_points(
    pts_cam: torch.Tensor, K: torch.Tensor, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points (..., N, 3) to pixels (..., N, 2).

    Returns (uv, depth).
    """
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    x = pts_cam[..., 0] / z_safe
    y = pts_cam[..., 1] / z_safe
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = fx[..., None] * x + cx[..., None]
    v = fy[..., None] * y + cy[..., None]
    return torch.stack([u, v], dim=-1), z


def project_points_T(
    pts_world: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points (..., N, 3) through camera-from-world (..., 4, 4)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    pts_cam = torch.einsum("...ij,...nj->...ni", R, pts_world) + t[..., None, :]
    return project_points(pts_cam, K)


def projection_jacobian_point(
    pts_cam: torch.Tensor, K: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """d(uv)/d(pts_cam): (..., N, 2, 3) analytic Jacobian."""
    X, Y, Z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    Zs = torch.where(torch.abs(Z) < eps, torch.full_like(Z, eps), Z)
    inv_z = 1.0 / Zs
    inv_z2 = inv_z * inv_z
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    zeros = torch.zeros_like(X)
    fxb = fx[..., None].expand(X.shape)
    fyb = fy[..., None].expand(X.shape)
    row_u = torch.stack([fxb * inv_z, zeros, -fxb * X * inv_z2], dim=-1)
    row_v = torch.stack([zeros, fyb * inv_z, -fyb * Y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def pixels_to_normalized(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project pixels (..., N, 2) to normalized image coordinates."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = (uv[..., 0] - cx[..., None]) / fx[..., None]
    y = (uv[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y], dim=-1)
