"""SE(3) rigid-transform helpers (4x4 homogeneous matrices, batched)."""

from __future__ import annotations

import torch

from vobench.reference.geometry.so3 import so3_exp, so3_hat


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    # fill_, not `= 1.0`: assigning a number to a 0-d view copies it from
    # the host and waits for the device
    T[..., 3, 3].fill_(1.0)
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (no linalg.inv)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    return make_T(Rt, t_inv)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq + 1e-16)
    W = so3_hat(phi)
    W2 = W @ W
    small = theta_sq < 1e-8
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (theta_sq * theta),
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)

