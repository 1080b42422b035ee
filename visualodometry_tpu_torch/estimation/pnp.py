"""Vectorized PnP RANSAC with damped Gauss-Newton refinement.

Port of visualodometry_tpu/estimation/pnp.py with both minimal solvers:
the 6-point DLT and P3P (`cfg.pnp_solver`, P3P under `get_config("kitti")`).
The minimal-sample indices come in explicitly as `idx`, (H, 6) or (H, 3)
(`pnp_sample_size`); the IRLS Gauss-Newton polish of the winner is
ops/pose_polish.py's `polish_pose` (one kernel launch on a CUDA tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.estimation.p3p import p3p_grunert
from visualodometry_tpu_torch.estimation.ransac import take
from visualodometry_tpu_torch.geometry.camera import (
    pixels_to_normalized,
    project_points,
    projection_jacobian_point,
)
from visualodometry_tpu_torch.geometry.linalg import (
    det3,
    smallest_eigvec,
    solve_psd_small,
    svd3,
)
from visualodometry_tpu_torch.geometry.se3 import make_T, se3_exp
from visualodometry_tpu_torch.geometry.so3 import so3_hat
from visualodometry_tpu_torch.ops.pose_polish import polish_pose


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # (4, 4) camera-from-world
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _dlt_rows(X: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """DLT rows (..., N, 2, 12) for x ~ P [X; 1] over vec(P) (row-major)."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = xy[..., 0:1]
    v = xy[..., 1:2]
    row_u = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row_v = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _pose_from_P(P: torch.Tensor, X_sample: torch.Tensor):
    """Project a (..., 3, 4) DLT solution onto SE(3) -> (R, t)."""

    def decompose(Pm):
        M = Pm[..., :, :3]
        U, s, Vt = svd3(M)
        det_uv = det3(U @ Vt)
        D = torch.stack(
            [torch.ones_like(det_uv), torch.ones_like(det_uv), det_uv], dim=-1
        )
        R = (U * D[..., None, :]) @ Vt
        lam = torch.mean(s, dim=-1)
        t = Pm[..., :, 3] / torch.clamp(lam[..., None], min=1e-12)
        return R, t

    R_pos, t_pos = decompose(P)
    R_neg, t_neg = decompose(-P)

    def front_votes(R, t):
        z = (torch.einsum("...ij,...nj->...ni", R, X_sample) + t[..., None, :])[..., 2]
        return torch.sum(z > 0, dim=-1)

    pick_pos = front_votes(R_pos, t_pos) >= front_votes(R_neg, t_neg)
    R = torch.where(pick_pos[..., None, None], R_pos, R_neg)
    t = torch.where(pick_pos[..., None], t_pos, t_neg)
    return R, t


def _reproj_err_sq(R, t, X, uv, K):
    """Squared pixel reprojection error. R: (..., 3, 3); X, uv: (N, ·)."""
    p_cam = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    uv_hat, z = project_points(p_cam, K)
    err = torch.sum((uv_hat - uv) ** 2, dim=-1)
    return err, z


def refine_pose_gn(T_cw, X, uv, weights, K, iters: int, damping: float = 1e-3):
    """Damped Gauss-Newton pose polish on weighted correspondences."""
    eye3 = torch.eye(3, dtype=T_cw.dtype, device=T_cw.device)
    eye6 = torch.eye(6, dtype=T_cw.dtype, device=T_cw.device)
    T = T_cw
    for _ in range(iters):
        R = T[:3, :3]
        t = T[:3, 3]
        p_cam = X @ R.T + t[None, :]
        uv_hat, _ = project_points(p_cam, K)
        r = uv_hat - uv  # (N, 2)
        Jp = projection_jacobian_point(p_cam, K)  # (N, 2, 3)
        Jx = torch.cat([eye3.expand(X.shape[0], 3, 3), -so3_hat(p_cam)], dim=-1)
        J = Jp @ Jx  # (N, 2, 6)
        Jw = J * weights[:, None, None]
        H = torch.einsum("nik,nil->kl", Jw, J)
        b = torch.einsum("nik,ni->k", Jw, r)
        H = H + damping * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        delta = solve_psd_small(H, b)
        T = se3_exp(-delta) @ T
    return T


def pnp_sample_size(cfg: VOConfig) -> int:
    """Points per minimal sample of `cfg.pnp_solver`."""
    sizes = {"dlt": 6, "p3p": 3}
    if cfg.pnp_solver not in sizes:
        raise ValueError(f"unknown pnp_solver {cfg.pnp_solver!r}")
    return sizes[cfg.pnp_solver]


def solve_pnp_ransac(
    pts3d: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    cfg: VOConfig,
    idx: torch.Tensor,
    T_init: torch.Tensor | None = None,
) -> PnPResult:
    """Batched PnP RANSAC over padded 2D-3D correspondences.

    pts3d: (N, 3) world points; uv: (N, 2) pixels; valid: (N,) live mask;
    idx: (H, k) minimal-sample indices, k = `pnp_sample_size(cfg)`.
    `T_init` (camera-from-world) joins the pool as a fallback hypothesis
    (see `_finish_pnp`).
    """
    k = pnp_sample_size(cfg)
    if idx.dim() != 2 or idx.shape[1] != k:
        raise ValueError(
            f"solve_pnp_ransac: pnp_solver={cfg.pnp_solver!r} takes (H, {k}) "
            f"sample indices, not {tuple(idx.shape)}"
        )
    xy = pixels_to_normalized(uv, K)
    H = idx.shape[0]
    thresh_sq = cfg.pnp_reproj_err * cfg.pnp_reproj_err

    if cfg.pnp_solver == "p3p":
        R4, t4, ok4 = p3p_grunert(pts3d[idx], xy[idx])
        R_h = R4.reshape(-1, 3, 3)  # (4H, 3, 3)
        t_h = t4.reshape(-1, 3)
        err_sq, z = _reproj_err_sq(R_h, t_h, pts3d, uv, K)
        inlier_mat = (
            (err_sq < thresh_sq) & (z > 0) & valid[None, :] & ok4.reshape(-1)[:, None]
        )
        counts = torch.sum(inlier_mat, dim=1)
        best = torch.argmax(counts)
        return _finish_pnp(
            R_h, t_h, inlier_mat, counts, best, pts3d, uv, valid, K, cfg, T_init
        )

    # Hartley-style conditioning of the 3D points
    w_sum = torch.clamp(torch.sum(valid), min=1.0)
    centroid = torch.sum(torch.where(valid[:, None], pts3d, 0.0), dim=0) / w_sum
    spread = (
        torch.sum(
            torch.where(
                valid, torch.linalg.vector_norm(pts3d - centroid, dim=-1), 0.0
            )
        )
        / w_sum
    )
    scale = torch.where(spread > 1e-6, 1.0 / spread, 1.0)
    Xn = (pts3d - centroid) * scale

    X_s = Xn[idx]  # (H, 6, 3)
    xy_s = xy[idx]
    rows = _dlt_rows(X_s, xy_s).reshape(H, 12, 12)
    rows = rows / torch.clamp(
        torch.linalg.vector_norm(rows, dim=-1, keepdim=True), min=1e-12
    )
    AtA = torch.einsum("hni,hnj->hij", rows, rows)
    p = smallest_eigvec(AtA)
    P = p.reshape(H, 3, 4)
    R_h, tn_h = _pose_from_P(P, X_s)
    t_h = tn_h / scale - torch.einsum("hij,j->hi", R_h, centroid)

    err_sq, z = _reproj_err_sq(R_h, t_h, pts3d, uv, K)
    inlier_mat = (err_sq < thresh_sq) & (z > 0) & valid[None, :]
    counts = torch.sum(inlier_mat, dim=1)
    best = torch.argmax(counts)
    return _finish_pnp(
        R_h, t_h, inlier_mat, counts, best, pts3d, uv, valid, K, cfg, T_init
    )


def _finish_pnp(
    R_h, t_h, inlier_mat, counts, best, pts3d, uv, valid, K, cfg, T_init
) -> PnPResult:
    """RANSAC tail: T_init fallback + truncated-Huber IRLS local
    optimization + robust-cost safety fallback (see the JAX module)."""
    thresh_sq = cfg.pnp_reproj_err * cfg.pnp_reproj_err
    if T_init is not None:
        # fallback only: T_init wins when the sampled hypotheses hold
        # under half of its inlier support
        err_i, z_i = _reproj_err_sq(T_init[:3, :3], T_init[:3, 3], pts3d, uv, K)
        inl_i = (err_i < thresh_sq) & (z_i > 0) & valid
        count_i = torch.sum(inl_i)
        use_init = take(counts, best) < torch.clamp(count_i // 2, min=6)
        R_h = torch.cat([R_h, T_init[None, :3, :3]], dim=0)
        t_h = torch.cat([t_h, T_init[None, :3, 3]], dim=0)
        inlier_mat = torch.cat([inlier_mat, inl_i[None]], dim=0)
        counts = torch.cat([counts, count_i[None]], dim=0)
        best = torch.where(use_init, counts.shape[0] - 1, best)

    R_b, t_b = take(R_h, best), take(t_h, best)
    T_out = make_T(R_b, t_b)
    T_out = polish_pose(
        T_out, pts3d, uv, valid, K,
        delta=cfg.pnp_irls_delta * cfg.pnp_reproj_err,
        cut_sq=(cfg.pnp_irls_cut * cfg.pnp_reproj_err) ** 2,
        rounds=cfg.pnp_refine_rounds, iters=cfg.pnp_refine_iters,
    )

    err_sq_f, z_f = _reproj_err_sq(T_out[:3, :3], T_out[:3, 3], pts3d, uv, K)
    inliers_f = (err_sq_f < thresh_sq) & (z_f > 0) & valid
    num_f = torch.sum(inliers_f).to(torch.int32)
    cost_ref = torch.sum(torch.clamp(err_sq_f, max=thresh_sq) * valid)
    err_sq_0, _ = _reproj_err_sq(R_b, t_b, pts3d, uv, K)
    cost_raw = torch.sum(torch.clamp(err_sq_0, max=thresh_sq) * valid)
    keep_refined = cost_ref <= cost_raw
    T_out = torch.where(keep_refined, T_out, make_T(R_b, t_b))
    inliers_out = torch.where(keep_refined, inliers_f, take(inlier_mat, best))
    num_out = torch.where(keep_refined, num_f, take(counts, best).to(torch.int32))
    return PnPResult(T_cw=T_out, inliers=inliers_out, num_inliers=num_out, ok=num_out >= 6)
