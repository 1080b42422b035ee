"""Faithful CPU re-execution of the reference pipeline (OpenCV SIFT path).

The port's copy of visualodometry_tpu/eval/reference_cv2.py (only the
config import differs). This is the benchmark ANCHOR, not part of the
device path: it re-runs the reference's actual per-frame loop — cv2 SIFT detectAndCompute, BF
kNN + Lowe ratio loop, median-flow init gate, findEssentialMat/
recoverPose bootstrap with global scale, PnP tracking with speed-scale
smoothing, keyframe triangulation with cheirality+reprojection gates,
age-pruned dict map, failure reset — with verbatim semantics from
reference src/modules/vo.py:49-299, src/modules/frontend.py:27-148 so
the pipeline's fps and ATE can be compared against the real thing
on identical images.

Per-item Python loops (ratio test, id lookup, landmark registration) are
kept loop-shaped exactly where the reference has them — they are part of
the baseline's genuine cost profile (reference frontend.py:100-111,
vo.py:121-124,277-284).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from visualodometry_tpu_torch.config import VOConfig


@dataclass
class _RefVO:
    """Mutable state mirroring reference vo.py:15-29."""

    K: np.ndarray
    cfg: VOConfig
    sift: object
    matcher: object
    frame_id: int = 0
    initialized: bool = False
    map_points: dict = field(default_factory=dict)
    next_pt_id: int = 0
    T_wc: np.ndarray = field(default_factory=lambda: np.eye(4))
    last_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    baseline_speed: float = 1.0
    keyframe: dict | None = None
    num_resets: int = 0
    num_keyframes: int = 0


def _make_vo(K: np.ndarray, cfg: VOConfig) -> _RefVO:
    import cv2

    sift = cv2.SIFT_create(
        nfeatures=cfg.sift_n_features,
        contrastThreshold=cfg.sift_contrast_threshold,
        edgeThreshold=cfg.sift_edge_threshold,
        sigma=cfg.sift_sigma,
    )  # reference frontend.py:27-32
    matcher = cv2.BFMatcher(cv2.NORM_L2, crossCheck=False)
    return _RefVO(K=K.astype(np.float64), cfg=cfg, sift=sift, matcher=matcher)


def _match(vo: _RefVO, des_ref, des_curr) -> np.ndarray:
    """BF kNN k=2 + Lowe ratio, loop-shaped (reference frontend.py:100-111)."""
    if des_ref is None or des_curr is None or not len(des_ref) or not len(des_curr):
        return np.zeros((0, 2), int)
    knn = vo.matcher.knnMatch(des_ref, des_curr, k=2)
    good = []
    for pair in knn:
        if len(pair) == 2:
            m, n = pair
            if m.distance < vo.cfg.lowe_ratio * n.distance:
                good.append([m.queryIdx, m.trainIdx])
    return np.asarray(good, int).reshape(-1, 2)


def _triangulate(vo: _RefVO, T_cw1, T_cw2, pts1, pts2):
    """DLT + cheirality/reprojection gates (reference frontend.py:115-148)."""
    import cv2

    cfg = vo.cfg
    P1 = vo.K @ T_cw1[:3, :]
    P2 = vo.K @ T_cw2[:3, :]
    Xh = cv2.triangulatePoints(P1, P2, pts1.T.astype(float), pts2.T.astype(float))
    X = (Xh[:3] / Xh[3:]).T
    Xc2 = (T_cw2[:3, :3] @ X.T).T + T_cw2[:3, 3]
    depth_ok = Xc2[:, 2] > cfg.min_depth
    rvec2, _ = cv2.Rodrigues(T_cw2[:3, :3])
    proj2, _ = cv2.projectPoints(X, rvec2, T_cw2[:3, 3], vo.K, None)
    err2 = np.linalg.norm(proj2.reshape(-1, 2) - pts2, axis=1)
    valid = depth_ok & (err2 < cfg.max_reproj_err)
    return X[valid], valid


def _create_keyframe(vo: _RefVO, kps, des, curr_ids, ref_idx, curr_idx):
    """Triangulate unmatched, register, swap keyframe (reference vo.py:252-288)."""
    T_cw_ref = np.linalg.inv(vo.keyframe["T_wc"])
    T_cw_curr = np.linalg.inv(vo.T_wc)
    no_id = curr_ids[curr_idx] == -1
    if no_id.sum() > 0:
        uv_ref = vo.keyframe["kps"][ref_idx[no_id]]
        uv_curr = kps[curr_idx[no_id]]
        pts3d, valid = _triangulate(vo, T_cw_ref, T_cw_curr, uv_ref, uv_curr)
        targets = curr_idx[no_id]
        count = 0
        for i, ok in enumerate(valid):
            if ok:
                vo.map_points[vo.next_pt_id] = pts3d[count]
                curr_ids[targets[i]] = vo.next_pt_id
                vo.next_pt_id += 1
                count += 1
    vo.keyframe = {"kps": kps, "des": des, "ids": curr_ids, "T_wc": vo.T_wc.copy()}
    vo.num_keyframes += 1
    # age-based prune to 20k (reference vo.py:35-47)
    cutoff = vo.next_pt_id - 20000
    if cutoff > 0:
        for pid in [p for p in vo.map_points if p < cutoff]:
            del vo.map_points[pid]


def _reset(vo: _RefVO):
    """Failure reset (reference vo.py:290-299)."""
    vo.initialized = False
    vo.map_points = {}
    vo.keyframe = None
    vo.last_pos = np.zeros(3)
    vo.baseline_speed = 1.0
    vo.num_resets += 1


def _process_frame(vo: _RefVO, img: np.ndarray) -> None:
    """One reference step (reference vo.py:49-250)."""
    import cv2

    cfg = vo.cfg
    kp, des = vo.sift.detectAndCompute(img, None)
    kps = np.array([k.pt for k in kp], np.float64).reshape(-1, 2)
    curr_ids = np.full(len(kps), -1, dtype=int)

    if vo.keyframe is None:  # bootstrap frame (vo.py:56-61)
        vo.keyframe = {"kps": kps, "des": des, "ids": curr_ids, "T_wc": np.eye(4)}
        vo.frame_id += 1
        return

    matches = _match(vo, vo.keyframe["des"], des)
    ref_idx, curr_idx = matches[:, 0], matches[:, 1]

    if not vo.initialized:  # init path (vo.py:71-117)
        uv_ref = vo.keyframe["kps"][ref_idx]
        uv_curr = kps[curr_idx]
        flow = (
            float(np.median(np.linalg.norm(uv_ref - uv_curr, axis=1)))
            if len(uv_ref)
            else 0.0
        )
        if flow < cfg.min_median_flow:
            vo.frame_id += 1
            return
        E, _ = cv2.findEssentialMat(
            uv_ref,
            uv_curr,
            vo.K,
            method=cv2.RANSAC,
            prob=cfg.init_ransac_prob,
            threshold=cfg.init_ransac_thresh,
        )
        if E is not None:
            _, R, t, _ = cv2.recoverPose(E, uv_ref, uv_curr, vo.K)
            T_cw = np.eye(4)
            T_cw[:3, :3] = R
            T_cw[:3, 3] = t.flatten() * cfg.global_scale
            vo.T_wc = np.linalg.inv(T_cw)
            vo.last_pos = np.zeros(3)
            vo.baseline_speed = float(np.linalg.norm(vo.T_wc[:3, 3]))
            vo.initialized = True
            _create_keyframe(vo, kps, des, curr_ids, ref_idx, curr_idx)
    else:  # tracking path (vo.py:120-245)
        kf_ids = vo.keyframe["ids"][ref_idx]
        valid = np.array(
            [(pid != -1 and pid in vo.map_points) for pid in kf_ids]
        ).reshape(-1)
        if valid.sum() > cfg.min_inliers:
            pnp_3d = np.array([vo.map_points[pid] for pid in kf_ids[valid]])
            pnp_2d = kps[curr_idx[valid]]
            ok, rvec, tvec, inliers = cv2.solvePnPRansac(
                pnp_3d, pnp_2d, vo.K, None, reprojectionError=cfg.pnp_reproj_err
            )
            if ok:
                R, _ = cv2.Rodrigues(rvec)
                T_cw = np.eye(4)
                T_cw[:3, :3] = R
                T_cw[:3, 3] = tvec.flatten()
                T_wc_raw = np.linalg.inv(T_cw)
                raw_pos = T_wc_raw[:3, 3]

                # speed-scale smoothing (vo.py:150-204)
                delta = raw_pos - vo.last_pos
                raw_speed = float(np.linalg.norm(delta))
                rel, _ = cv2.Rodrigues(R @ vo.T_wc[:3, :3])
                turning = float(np.linalg.norm(rel)) > cfg.turn_thresh
                moving = raw_speed > cfg.move_thresh
                if moving:
                    smooth = cfg.turn_smoothing if turning else cfg.trans_smoothing
                    target = smooth * vo.baseline_speed + (1 - smooth) * raw_speed
                    if not turning:
                        vo.baseline_speed = (
                            1 - cfg.baseline_lr
                        ) * vo.baseline_speed + cfg.baseline_lr * raw_speed
                    scale = np.clip(
                        target / raw_speed, cfg.scale_clamp_min, cfg.scale_clamp_max
                    )
                    vo.T_wc = T_wc_raw.copy()
                    vo.T_wc[:3, 3] = vo.last_pos + delta * scale
                else:
                    vo.T_wc = T_wc_raw
                vo.last_pos = vo.T_wc[:3, 3].copy()

                # id propagation (vo.py:206-210)
                if inliers is not None:
                    tracked_idx = curr_idx[valid]
                    tracked_ids = kf_ids[valid]
                    for i in inliers.flatten():
                        curr_ids[tracked_idx[i]] = tracked_ids[i]

                # keyframe decision (vo.py:212-226)
                uv_ref = vo.keyframe["kps"][ref_idx]
                uv_curr = kps[curr_idx]
                flow = float(np.median(np.linalg.norm(uv_ref - uv_curr, axis=1)))
                if flow > cfg.min_median_flow or (curr_ids != -1).sum() < cfg.kf_min_tracked:
                    _create_keyframe(vo, kps, des, curr_ids, ref_idx, curr_idx)
            else:
                _reset(vo)
        else:
            _reset(vo)
    vo.frame_id += 1


def run_reference_pipeline(
    imgs_u8: np.ndarray, K: np.ndarray, cfg: VOConfig
) -> tuple[np.ndarray, dict]:
    """Run the reference loop over (F, H, W) uint8 frames.

    Returns (positions (F, 3), stats) where stats has fps (measured over
    frames after the first, like bench_tpu_pipeline's makespan), resets,
    keyframes.
    """
    vo = _make_vo(K, cfg)
    positions = np.zeros((len(imgs_u8), 3))
    _process_frame(vo, imgs_u8[0])
    positions[0] = vo.T_wc[:3, 3]
    t0 = time.perf_counter()
    for f in range(1, len(imgs_u8)):
        _process_frame(vo, imgs_u8[f])
        positions[f] = vo.T_wc[:3, 3]
    dt = time.perf_counter() - t0
    return positions, {
        "fps": (len(imgs_u8) - 1) / dt,
        "resets": vo.num_resets,
        "keyframes": vo.num_keyframes,
        "map_size": len(vo.map_points),
    }
