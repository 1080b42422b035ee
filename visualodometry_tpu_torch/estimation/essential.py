"""Vectorized essential-matrix RANSAC and cheirality pose recovery.

Port of visualodometry_tpu/estimation/essential.py, five-point path
(the eight-point alternative is not on the main path and raises). The
RANSAC takes its minimal-sample indices explicitly, `idx` (H, 5). The
manifold GN refit runs batched over the top-k candidates with its
Jacobian written out; the fixed iteration counts are Python loops.

Conventions match OpenCV: x1^T E x0 = 0 in normalized coordinates, and
the recovered (R, t) maps frame0 camera coordinates to frame1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.estimation.fivepoint import five_point_candidates
from visualodometry_tpu_torch.estimation.ransac import take
from visualodometry_tpu_torch.geometry.camera import pixels_to_normalized
from visualodometry_tpu_torch.geometry.linalg import (
    _any_orthonormal,
    _cross,
    det3,
    smallest_eigvec,
    solve_psd_small,
    svd3,
)
from visualodometry_tpu_torch.geometry.so3 import so3_exp, so3_hat


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _W(E: torch.Tensor) -> torch.Tensor:
    """[[0, -1, 0], [1, 0, 0], [0, 0, 1]], built on E's device."""
    ez = torch.eye(3, dtype=E.dtype, device=E.device)[2]
    return so3_hat(ez) + torch.outer(ez, ez)


def _sampson_sq(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance. E: (..., 3, 3); x0, x1: (N, 2) -> (..., N)."""
    ones = torch.ones_like(x0[..., :1])
    X0 = torch.cat([x0, ones], dim=-1)
    X1 = torch.cat([x1, ones], dim=-1)
    Ex0 = torch.einsum("...ij,nj->...ni", E, X0)
    Etx1 = torch.einsum("...ji,nj->...ni", E, X1)
    x1Ex0 = torch.sum(X1 * Ex0, dim=-1)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return (x1Ex0 * x1Ex0) / torch.clamp(denom, min=1e-12)


def _sampson_residual_and_jac(E, dE, X0, X1, weights):
    """Weighted signed Sampson residual r (k, N) of E (k, 3, 3) and its
    derivative J (k, N, P) along the P tangent directions dE (k, P, 3, 3)."""
    Ex0 = X0 @ E.transpose(-1, -2)  # (k, N, 3)
    Etx1 = X1 @ E
    num = torch.sum(X1 * Ex0, dim=-1)
    s = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    den = torch.sqrt(torch.clamp(s, min=1e-12))
    dEx0 = torch.einsum("kpab,nb->kpna", dE, X0)
    dEtx1 = torch.einsum("kpba,nb->kpna", dE, X1)
    dnum = torch.sum(X1 * dEx0, dim=-1)  # (k, P, N)
    ds = 2.0 * (
        Ex0[:, None, :, 0] * dEx0[..., 0] + Ex0[:, None, :, 1] * dEx0[..., 1]
        + Etx1[:, None, :, 0] * dEtx1[..., 0] + Etx1[:, None, :, 1] * dEtx1[..., 1]
    )
    dden = torch.where((s > 1e-12)[:, None, :], ds / (2.0 * den[:, None, :]), 0.0)
    w = weights[:, None, :]
    dr = w * (dnum / den[:, None, :] - num[:, None, :] * dden / (den * den)[:, None, :])
    return (num / den) * weights, dr.transpose(1, 2)


def refine_essential_manifold(
    E: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
    weights: torch.Tensor,
    iters: int = 5,
) -> torch.Tensor:
    """GN refinement of E on the essential manifold (5 DOF), batched.

    E: (k, 3, 3); weights: (k, N) (0 = ignore); x0, x1: (N, 2) normalized
    coords. Minimizes the weighted signed Sampson residual over (so(3)
    perturbation of R, 2-dof tangent of the unit translation). The JAX
    module differentiates the residual with `jax.jacfwd`; here the same
    Jacobian at the expansion point is written out: d exp(w)/dw_i = [e_i]x
    and the normalized translation moves along its tangent basis.
    """
    U, _, Vt = svd3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    R0 = U @ _W(E) @ Vt
    t0 = U[..., :, 2]

    ones = torch.ones_like(x0[..., :1])
    X0 = torch.cat([x0, ones], dim=-1)
    X1 = torch.cat([x1, ones], dim=-1)
    gens = so3_hat(torch.eye(3, dtype=E.dtype, device=E.device))  # [e_i]x
    eye5 = torch.eye(5, dtype=E.dtype, device=E.device)

    for _ in range(iters):
        b1 = _any_orthonormal(t0)
        b2 = _cross(t0, b1)
        t_len = torch.clamp(torch.linalg.vector_norm(t0, dim=-1, keepdim=True), min=1e-12)
        tn = t0 / t_len
        tx = so3_hat(tn)
        Em = tx @ R0
        # tangent of t / |t| along b at the expansion point
        dt1 = (b1 - tn * torch.sum(tn * b1, -1, keepdim=True)) / t_len
        dt2 = (b2 - tn * torch.sum(tn * b2, -1, keepdim=True)) / t_len
        dE = torch.stack(
            [tx @ gens[i] @ R0 for i in range(3)]
            + [so3_hat(dt1) @ R0, so3_hat(dt2) @ R0],
            dim=1,
        )  # (k, 5, 3, 3)
        r, J = _sampson_residual_and_jac(Em, dE, X0, X1, weights)
        JtJ = J.transpose(1, 2) @ J
        Jtr = torch.einsum("knp,kn->kp", J, r)
        lam = 1e-6 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1) / 5.0 + 1e-12
        delta = -solve_psd_small(JtJ + lam[:, None, None] * eye5, Jtr)
        R0 = so3_exp(delta[:, :3]) @ R0
        t_new = t0 + delta[:, 3:4] * b1 + delta[:, 4:5] * b2
        t0 = t_new / torch.clamp(
            torch.linalg.vector_norm(t_new, dim=-1, keepdim=True), min=1e-12
        )
    E_f = so3_hat(t0) @ R0
    return E_f / torch.clamp(
        torch.linalg.vector_norm(E_f, dim=(-2, -1), keepdim=True), min=1e-12
    )


def estimate_essential_ransac(
    uv0: torch.Tensor,
    uv1: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    cfg: VOConfig,
    idx: torch.Tensor,
) -> EssentialResult:
    """Batched essential-matrix RANSAC over padded correspondences.

    uv0, uv1: (N, 2) pixels; valid: (N,) live matches; idx: (H, 5)
    minimal-sample indices for the five-point solver.
    """
    if cfg.essential_solver != "5point":
        raise NotImplementedError(
            f"estimate_essential_ransac: essential_solver={cfg.essential_solver!r} "
            "is not ported (five-point only)"
        )
    x0 = pixels_to_normalized(uv0, K)
    x1 = pixels_to_normalized(uv1, K)
    E_c, cand_ok = five_point_candidates(x0[idx], x1[idx])  # (H, 10, 3, 3)
    E_h = E_c.reshape(-1, 3, 3)
    hyp_ok = cand_ok.reshape(-1)

    f_mean = 0.5 * (K[0, 0] + K[1, 1])
    thresh = cfg.init_ransac_thresh / f_mean
    thresh_sq = thresh * thresh

    d2 = _sampson_sq(E_h, x0, x1)
    inlier_mat = (d2 < thresh_sq) & valid[None, :] & hyp_ok[:, None]
    counts = torch.sum(inlier_mat, dim=1)
    best = torch.argmax(counts)

    # refine the top-k by consensus, polish each with four robust IRLS
    # rounds, select by truncated-MSAC cost (see the JAX module)
    k_top = min(16, E_h.shape[0])
    top_idx = _top_k_stable(counts, k_top)
    E_ref = E_h[top_idx]
    w_ref = inlier_mat[top_idx].to(x0.dtype)
    cut_sq = 9.0 * thresh_sq
    E_ref = refine_essential_manifold(E_ref, x0, x1, w_ref)
    for _ in range(4):
        d2_ref = _sampson_sq(E_ref, x0, x1)
        w_ref = (
            torch.clamp(
                torch.sqrt(thresh_sq / torch.clamp(d2_ref, min=1e-18)), max=1.0
            )
            * (d2_ref < cut_sq)
            * valid[None, :]
        )
        E_ref = refine_essential_manifold(E_ref, x0, x1, w_ref)
    d2_ref = _sampson_sq(E_ref, x0, x1)
    cost = torch.sum(torch.clamp(d2_ref, max=thresh_sq) * valid[None, :], dim=1)
    E = take(E_ref, torch.argmin(cost))
    final_d2 = _sampson_sq(E, x0, x1)
    final_inliers = (final_d2 < thresh_sq) & valid
    num = torch.sum(final_inliers).to(torch.int32)

    # safety fallback to the raw winner, judged by truncated-MSAC cost
    cost_ref = torch.sum(torch.clamp(final_d2, max=thresh_sq) * valid)
    d2_raw = _sampson_sq(take(E_h, best), x0, x1)
    cost_raw = torch.sum(torch.clamp(d2_raw, max=thresh_sq) * valid)
    use_refit = cost_ref <= cost_raw
    E = torch.where(use_refit, E, take(E_h, best))
    final_inliers = torch.where(use_refit, final_inliers, take(inlier_mat, best))
    num = torch.where(use_refit, num, take(counts, best).to(torch.int32))
    return EssentialResult(E=E, inliers=final_inliers, num_inliers=num, ok=num >= 8)


def _top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index (the
    order of `lax.top_k`)."""
    return torch.argsort(x, descending=True, stable=True)[:k]


def _triangulate_normalized(R, t, x0, x1):
    """DLT triangulation in normalized coords for P0=[I|0], P1=[R|t].

    R: (..., 3, 3), t: (..., 3); x0, x1: (N, 2). Returns (depth in cam0,
    depth in cam1), each (..., N).
    """
    batch = R.shape[:-2]
    N = x0.shape[0]
    P0 = torch.zeros(batch + (3, 4), dtype=R.dtype, device=R.device)
    P0[..., 0, 0].fill_(1.0)
    P0[..., 1, 1].fill_(1.0)
    P0[..., 2, 2].fill_(1.0)
    P1 = torch.cat([R, t[..., :, None]], dim=-1)

    def rows(P, xy):
        Pb = P[..., None, :, :].expand(batch + (N, 3, 4))
        r0 = xy[..., 0:1] * Pb[..., 2, :] - Pb[..., 0, :]
        r1 = xy[..., 1:2] * Pb[..., 2, :] - Pb[..., 1, :]
        return torch.stack([r0, r1], dim=-2)

    A = torch.cat([rows(P0, x0), rows(P1, x1)], dim=-2)  # (..., N, 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    X = smallest_eigvec(AtA)
    w = X[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    pts = X[..., :3] / w_safe[..., None]
    z0 = pts[..., 2]
    z1 = (torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :])[..., 2]
    return z0, z1


def recover_pose(E, uv0, uv1, inliers, K):
    """Choose (R, t) from E by batched cheirality voting over the inliers.

    Equivalent to `cv2.recoverPose`; t has unit norm.
    """
    x0 = pixels_to_normalized(uv0, K)
    x1 = pixels_to_normalized(uv1, K)
    U, _, Vt = svd3(E)
    U = U * torch.sign(det3(U))
    Vt = Vt * torch.sign(det3(Vt))
    W = _W(E)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t_unit = U[:, 2]
    R4 = torch.stack([Ra, Ra, Rb, Rb])
    t4 = torch.stack([t_unit, -t_unit, t_unit, -t_unit])
    z0, z1 = _triangulate_normalized(R4, t4, x0, x1)
    front = (z0 > 0) & (z1 > 0) & inliers[None, :]
    votes = torch.sum(front, dim=1)
    best = torch.argmax(votes)
    return take(R4, best), take(t4, best)
