"""Closed-form SO(3) maps (batched over leading dims).

Port of visualodometry_tpu/geometry/so3.py (`so3_hat`, `so3_exp`,
`so3_log`, `rotation_angle`): the same Taylor-guarded Rodrigues formula
and its inverse, so the estimators and the pose graph see the same
numerics.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) -> (..., 3, 3) rotation matrix."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq
    )
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Three regimes: small angle (series), generic, and near pi (the axis
    from the largest column of R + I, its sign from the antisymmetric
    part). OpenCV's Rodrigues convention: the vector's norm is the angle.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    # antisymmetric part: (R - R^T) / 2 has entries sin(theta) * axis
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    factor = torch.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,
        theta / torch.where(torch.abs(sin_theta) < _EPS, _EPS, 2.0 * sin_theta),
    )
    w_generic = factor[..., None] * v

    S = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(S, k[..., None, None], dim=-1)[..., 0]
    col_norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    axis = col / torch.where(col_norm < _EPS, _EPS, col_norm)
    sign = torch.where(torch.sum(axis * v, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where((theta > math.pi - 1e-3)[..., None], w_pi, w_generic)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of (..., 3, 3) matrices."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
