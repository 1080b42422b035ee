"""Loop-free pose-graph smoothing over a keyframe chain.

Port of visualodometry_tpu/ba/pose_graph.py. Given absolute pose
estimates and relative-pose measurements between pairs, minimise

    sum_e w_e || log( Z_e^{-1} · T_i^{-1} · T_j ) ||^2

over SE(3) with Gauss-Newton: every edge's residual and Jacobian at once,
the normal system assembled dense (6P x 6P) and solved directly, pose 0
fixed. Jacobians take the first-order approximation J_j = I,
J_i = -Ad(rel^{-1}), exact at convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualodometry_tpu_torch.geometry.se3 import se3_exp, se3_inverse
from visualodometry_tpu_torch.geometry.so3 import so3_hat, so3_log


class PoseGraph(NamedTuple):
    T_wc: torch.Tensor  # (P, 4, 4) absolute poses (world-from-camera)
    edges_i: torch.Tensor  # (E,) source pose index
    edges_j: torch.Tensor  # (E,) target pose index
    Z: torch.Tensor  # (E, 4, 4) measured relative transforms T_i^{-1} T_j
    weight: torch.Tensor  # (E,) per-edge weight (0 disables an edge)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [rho, phi], the inverse of se3_exp."""
    phi = so3_log(T[..., :3, :3])
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq + 1e-16)
    W = so3_hat(phi)
    # V^{-1} = I - W/2 + a W^2, a = (1 - theta sin / (2 (1 - cos))) / theta^2;
    # the closed form cancels in float32 below theta ~ 1e-2, so the series
    # covers that regime
    small = theta_sq < 1e-4
    one_minus_cos = 2.0 * (1.0 - torch.cos(theta))
    a = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - theta * torch.sin(theta) / torch.where(small, 1.0, one_minus_cos))
        / torch.where(small, 1.0, theta_sq),
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + a[..., None, None] * (W @ W)
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def _residuals(T_wc: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    rel = se3_inverse(T_wc[g.edges_i]) @ T_wc[g.edges_j]
    return se3_log(se3_inverse(g.Z) @ rel)  # (E, 6)


def pose_graph_cost(g: PoseGraph) -> torch.Tensor:
    r = _residuals(g.T_wc, g)
    return torch.sum(torch.sum(r * r, dim=-1) * g.weight)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad(T) for twist order [rho, phi]: [[R, hat(t) R], [0, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, so3_hat(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def smooth_pose_graph(g: PoseGraph, iters: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """GN smoothing; returns refined (P, 4, 4) poses, pose 0 fixed. With the
    right perturbation T_k <- T_k exp(x_k); no host read."""
    P = g.T_wc.shape[0]
    ei, ej = g.edges_i.long(), g.edges_j.long()
    dt, dev = g.T_wc.dtype, g.T_wc.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    idx = torch.arange(P, device=dev)
    w = g.weight[:, None, None]
    T_wc = g.T_wc
    for _ in range(iters):
        r = _residuals(T_wc, g)  # (E, 6)
        rel = se3_inverse(T_wc[ei]) @ T_wc[ej]
        Ji = -_adjoint(se3_inverse(rel))  # (E, 6, 6)
        JiTJi = torch.einsum("eki,ekj->eij", Ji * w, Ji)
        JiTr = torch.einsum("eki,ek->ei", Ji * w, r)
        JiTJj = (Ji * w).transpose(1, 2)  # J_j = I
        H = torch.zeros((P, P, 6, 6), dtype=dt, device=dev)
        H.index_put_((ei, ei), JiTJi, accumulate=True)
        H.index_put_((ej, ej), eye6 * w, accumulate=True)
        H.index_put_((ei, ej), JiTJj, accumulate=True)
        H.index_put_((ej, ei), JiTJj.transpose(1, 2), accumulate=True)
        b = torch.zeros((P, 6), dtype=dt, device=dev)
        b.index_put_((ei,), JiTr, accumulate=True)
        b.index_put_((ej,), r * g.weight[:, None], accumulate=True)
        # gauge: freeze pose 0
        H[0] = 0.0
        H[:, 0] = 0.0
        H[0, 0] = eye6
        b[0] = 0.0
        H[idx, idx] += damping * eye6
        Hd = H.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
        delta = torch.linalg.solve_ex(Hd, b.reshape(P * 6, 1))[0].reshape(P, 6)
        T_wc = T_wc @ se3_exp(-delta)
    return T_wc
