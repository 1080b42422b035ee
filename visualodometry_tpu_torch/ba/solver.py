"""Damped Gauss-Newton bundle adjustment with Schur elimination.

Port of visualodometry_tpu/ba/solver.py. Problem layout:
  poses     T_cw: (P, 4, 4) camera-from-world per keyframe
  landmarks X:    (L, 3) world points
  obs       uv:   (L, P, 2) pixel observations, mask: (L, P)

One GN iteration:
  residual r_lp = proj(K, T_p X_l) - uv_lp                      (L, P, 2)
  pose Jacobian    A_lp = Jproj · [I | -hat(p_cam)]             (L, P, 2, 6)
  landmark Jacobian B_lp = Jproj · R_p                          (L, P, 2, 3)
  U_p = Σ_l AᵀA,  V_l = Σ_p BᵀB + λ,  W_lp = AᵀB
  Schur: S_pq = δ_pq U_p − Σ_l W_lp V_l⁻¹ W_lqᵀ   (dense 6P x 6P)
  rhs_p = g_p − Σ_l W_lp V_l⁻¹ h_l
  δpose = S⁻¹ rhs;  δX_l = V_l⁻¹ (h_l − Σ_p W_lpᵀ δpose_p)
  T_p ← exp(−δ_p) T_p;  X_l ← X_l − δX_l

Gauge: the first two poses are held fixed (one pins SE(3), the second the
monocular scale). The JAX package lays the per-landmark terms out
landmark-last for the TPU's lanes; here they are landmark-first, PyTorch's
natural layout, with the same sums. The Schur product Σ_l W V⁻¹ Wᵀ is one
(6P, 3L) x (3L, 6P) matrix product. A fixed iteration count and no host
read: `ba_solve` queues its whole solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualodometry_tpu_torch.geometry.linalg import inv3_sym, solve_psd
from visualodometry_tpu_torch.geometry.se3 import se3_exp


class BAProblem(NamedTuple):
    T_cw: torch.Tensor  # (P, 4, 4)
    X: torch.Tensor  # (L, 3)
    uv: torch.Tensor  # (L, P, 2)
    mask: torch.Tensor  # (L, P) bool
    K: torch.Tensor  # (3, 3)


class LandmarkContrib(NamedTuple):
    """The Σ_l terms of the reduced pose system and the back-substitution
    data, landmark-first."""

    S: torch.Tensor  # (P, P, 6, 6): δ_pq U_p − Σ_l W V⁻¹ Wᵀ
    rhs: torch.Tensor  # (P, 6): g − Σ_l W V⁻¹ h
    Vinv: torch.Tensor  # (L, 3, 3)
    W: torch.Tensor  # (L, P, 6, 3)
    h: torch.Tensor  # (L, 3)
    seen: torch.Tensor  # (L,) bool


def _residuals_jacobians(T, X, uv, mask, K):
    """Residuals and Jacobians: r (L, P, 2), A (L, P, 2, 6), B (L, P, 2, 3),
    m (L, P) (the mask, less observations behind the camera)."""
    R = T[:, :3, :3]  # (P, 3, 3)
    p = torch.einsum("pij,lj->lpi", R, X) + T[None, :, :3, 3]  # (L, P, 3)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    r = torch.stack([fx * x * iz + cx, fy * y * iz + cy], dim=-1) - uv
    m = mask & (z > 1e-3)  # behind-camera observations would poison the solve
    w = m.to(X.dtype)[..., None, None]

    zero = torch.zeros_like(x)
    # d uv / d p_cam rows, and their products with [I | -hat(p)]
    ju = (fx * iz, zero, -fx * x * iz2)
    jv = (zero, fy * iz, -fy * y * iz2)
    Au = torch.stack(
        [*ju, -fx * x * y * iz2, fx * (1.0 + x * x * iz2), -fx * y * iz], dim=-1
    )
    Av = torch.stack(
        [*jv, -fy * (1.0 + y * y * iz2), fy * x * y * iz2, fy * x * iz], dim=-1
    )
    A = torch.stack([Au, Av], dim=-2) * w  # (L, P, 2, 6)
    # B rows = Jp row @ R_p
    Bu = ju[0][..., None] * R[None, :, 0] + ju[2][..., None] * R[None, :, 2]
    Bv = jv[1][..., None] * R[None, :, 1] + jv[2][..., None] * R[None, :, 2]
    B = torch.stack([Bu, Bv], dim=-2) * w  # (L, P, 2, 3)
    return r, A, B, m


def landmark_contributions(T, X, uv, mask, K, damping) -> LandmarkContrib:
    """Per-landmark-block GN terms, summed over the landmarks."""
    P = T.shape[0]
    r, A, B, m = _residuals_jacobians(T, X, uv, mask, K)
    rw = r * m.to(X.dtype)[..., None]  # (L, P, 2)
    U = torch.einsum("lpia,lpib->pab", A, A)  # (P, 6, 6)
    g = torch.einsum("lpia,lpi->pa", A, rw)  # (P, 6)
    V = torch.einsum("lpia,lpib->lab", B, B)  # (L, 3, 3)
    W = torch.einsum("lpia,lpib->lpab", A, B)  # (L, P, 6, 3)
    h = torch.einsum("lpia,lpi->la", B, rw)  # (L, 3)
    lam = damping + 1e-6
    V = V + lam * torch.eye(3, dtype=X.dtype, device=X.device)
    Vinv = inv3_sym(V)
    WVinv = torch.einsum("lpac,lcb->lpab", W, Vinv)  # (L, P, 6, 3)
    # S_pq[a, b] = -Σ_{l, c} WVinv[l, p, a, c] W[l, q, b, c]
    M1 = WVinv.permute(1, 2, 0, 3).reshape(P * 6, -1)
    M2 = W.permute(1, 2, 0, 3).reshape(P * 6, -1)
    S = -(M1 @ M2.T).reshape(P, 6, P, 6).permute(0, 2, 1, 3).contiguous()
    idx = torch.arange(P, device=X.device)
    S[idx, idx] += U
    rhs = g - torch.einsum("lpac,lc->pa", WVinv, h)
    return LandmarkContrib(S=S, rhs=rhs, Vinv=Vinv, W=W, h=h, seen=torch.any(m, dim=1))


def reduced_solve(S, rhs, damping, fixed_poses: int) -> torch.Tensor:
    """Solve the (gauge-fixed, damped) dense reduced pose system -> (P, 6)."""
    P = rhs.shape[0]
    eye6 = torch.eye(6, dtype=rhs.dtype, device=rhs.device)
    idx = torch.arange(P, device=rhs.device)
    S = S.clone()
    S[idx, idx] += damping * eye6
    # gauge fix: freeze the first `fixed_poses` poses
    S[:fixed_poses] = 0.0
    S[:, :fixed_poses] = 0.0
    S[idx[:fixed_poses], idx[:fixed_poses]] = eye6
    rhs = rhs.clone()
    rhs[:fixed_poses] = 0.0
    S_dense = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    return solve_psd(S_dense, rhs.reshape(P * 6)).reshape(P, 6)


def apply_updates(T, X, delta_pose, contrib: LandmarkContrib):
    """Pose retraction and landmark back-substitution."""
    T_new = se3_exp(-delta_pose) @ T
    Wt_dp = torch.einsum("lpab,pa->lb", contrib.W, delta_pose)  # (L, 3)
    delta_X = torch.einsum("lab,lb->la", contrib.Vinv, contrib.h - Wt_dp)
    X_new = torch.where(contrib.seen[:, None], X - delta_X, X)
    return T_new, X_new


class ScalePrior(NamedTuple):
    """Radial scale-gauge prior for windowed monocular BA: each free pose's
    distance from the gauge pose is pinned to its pre-solve value with
    relative sigma `rel` (see the JAX class for why)."""

    d0: torch.Tensor  # (P,) pre-solve distances ||c_p - c_0||
    inv_sigma: torch.Tensor  # (P,) 1/(rel*d0), 0 for fixed/degenerate


def _centers(T):
    return -torch.einsum("pji,pj->pi", T[:, :3, :3], T[:, :3, 3])  # (P, 3)


def make_scale_prior(T, rel: float, fixed_poses: int = 2) -> ScalePrior:
    """The prior anchored at the pre-solve pose configuration."""
    c = _centers(T)
    d0 = torch.linalg.vector_norm(c - c[0], dim=-1)
    ok = (torch.arange(T.shape[0], device=T.device) >= fixed_poses) & (d0 > 1e-6)
    inv_sigma = torch.where(ok, 1.0 / (rel * torch.clamp(d0, min=1e-6)), 0.0)
    return ScalePrior(d0=d0, inv_sigma=inv_sigma)


def scale_prior_terms(T, prior: ScalePrior):
    """(dU (P, 3, 3), dg (P, 3)) Gauss-Newton terms of the prior."""
    R = T[:, :3, :3]
    dvec = _centers(T)
    dvec = dvec - dvec[0]
    d = torch.linalg.vector_norm(dvec, dim=-1)
    u = dvec / torch.clamp(d, min=1e-9)[:, None]
    Ru = torch.einsum("pij,pj->pi", R, u)
    s = (d - prior.d0) * prior.inv_sigma
    J = Ru * prior.inv_sigma[:, None]
    return torch.einsum("pa,pb->pab", J, J), -J * s[:, None]


def ba_iteration(prob: BAProblem, damping, fixed_poses: int = 2,
                 scale_prior: ScalePrior | None = None) -> BAProblem:
    T, X, uv, mask, K = prob
    contrib = landmark_contributions(T, X, uv, mask, K, damping)
    S, rhs = contrib.S, contrib.rhs
    if scale_prior is not None:
        dU, dg = scale_prior_terms(T, scale_prior)
        idx = torch.arange(T.shape[0], device=T.device)
        S = S.clone()
        S[idx, idx, :3, :3] += dU
        rhs = rhs.clone()
        rhs[:, :3] += dg
    delta_pose = reduced_solve(S, rhs, damping, fixed_poses)
    T_new, X_new = apply_updates(T, X, delta_pose, contrib)
    return BAProblem(T_cw=T_new, X=X_new, uv=uv, mask=mask, K=K)


def ba_cost(prob: BAProblem) -> torch.Tensor:
    """Masked mean squared reprojection error (diagnostic)."""
    r, _, _, m = _residuals_jacobians(*prob)
    err = torch.sum(r * r, dim=-1) * m.to(r.dtype)
    return torch.sum(err) / torch.clamp(torch.sum(m), min=1.0)


def ba_solve(prob: BAProblem, iters: int = 8, damping: float = 1e-3,
             fixed_poses: int = 2, scale_prior_rel: float = 0.0) -> BAProblem:
    """A fixed number of damped GN iterations. `scale_prior_rel` > 0 adds
    the radial `ScalePrior` anchored at the entry poses (needed where BA
    corrects poses: the monocular scale direction is weakly observable)."""
    prior = (
        make_scale_prior(prob.T_cw, scale_prior_rel, fixed_poses)
        if scale_prior_rel > 0.0 else None
    )
    for _ in range(iters):
        prob = ba_iteration(prob, damping, fixed_poses=fixed_poses, scale_prior=prior)
    return prob
