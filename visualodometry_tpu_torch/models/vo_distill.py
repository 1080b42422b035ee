"""SuperPoint distillation stage: VO pairs + SIFT-teacher labels.

Port of visualodometry_tpu/models/vo_distill.py: a pre-rendered pool of
consecutive corridor frames with exact depth maps, SIFT-keypoint cell
labels (with in-cell subpixel targets) computed once per pool image, and
batches whose cell correspondence comes from depth reprojection between
consecutive frames (`vo_pair_batch`) or from a homography
(`homography_pool_batch`).

`build_vo_pool` runs the port's SIFT on every rendered frame: on CUDA its
orientation and descriptor taps are K2 (ops/patches.py). Crops are
8-aligned so the full-image cell labels slice directly. The batch
generators are numpy and draw from the `np.random.Generator` in the JAX
module's order.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.models.train_superpoint import _tensors, forward_pair
from visualodometry_tpu_torch.models.train_superpoint_textured import (
    TrainBatchH,
    _cell_correspondence,
    _jitter_corridor as _jitter,
    _loss_h,
    _random_homography,
    _warp,
)


class TrainBatchSub(NamedTuple):
    """TrainBatchH + view-0 subpixel regression targets."""

    h: TrainBatchH
    sub0: torch.Tensor  # (B, Hc, Wc, 2) subpixel (x, y) in-cell, [0, 8)
    subv0: torch.Tensor  # (B, Hc, Wc) bool


def loss_fn_sub(model, batch: TrainBatchSub, desc_w: float = 1.0, sub_w: float = 0.25):
    """`loss_fn_h` + expected-coordinate subpixel regression.

    The detector head's within-cell 8x8 softmax mass is pulled so its
    expected position matches the SIFT teacher's subpixel location (Huber,
    px units). Returns (total, (det_loss, desc_loss, sub_loss)). View 0
    runs through the network once; the JAX function runs it a second time
    for this term, with the same value and gradient.
    """
    det0, desc0, det1, desc1 = forward_pair(model, batch.h.img0, batch.h.img1)
    total, aux = _loss_h(det0, desc0, det1, desc1, batch.h, desc_w)
    prob = torch.softmax(det0.permute(0, 2, 3, 1), dim=-1)[..., :64]
    mass = torch.clamp(prob.sum(-1, keepdim=True), min=1e-6)
    p = (prob / mass).reshape(*prob.shape[:-1], 8, 8)  # within-cell distribution
    jj = torch.arange(8, dtype=torch.float32, device=p.device)
    ex = torch.einsum("...ij,j->...", p, jj) + 0.5  # expected x in-cell
    ey = torch.einsum("...ij,i->...", p, jj) + 0.5
    dx = ex - batch.sub0[..., 0]
    dy = ey - batch.sub0[..., 1]
    r = torch.sqrt(dx * dx + dy * dy + 1e-9)
    huber = torch.where(r < 1.0, 0.5 * r * r, r - 0.5)
    w = batch.subv0.to(torch.float32)
    sub_loss = torch.sum(huber * w) / torch.clamp(torch.sum(w), min=1.0)
    return total + sub_w * sub_loss, (*aux, sub_loss)


def sift_cell_labels(kps, resp, H, W):
    """65-way cell labels + subpixel targets from SIFT keypoints.

    kps: (N, 2) pixel (x, y); resp: (N,) strength for tie-breaks. Returns
    (labels (H//8, W//8) int32, dustbin 64 where empty; sub (H//8, W//8,
    2) float32, the keypoint's subpixel (x, y) within the cell in [0, 8),
    zeros where empty).
    """
    hc, wc = H // 8, W // 8
    labels = np.full((hc, wc), 64, np.int32)
    sub = np.zeros((hc, wc, 2), np.float32)
    best = np.full((hc, wc), -np.inf, np.float32)
    xi = np.clip(np.round(kps[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kps[:, 1]).astype(int), 0, H - 1)
    ci, cj = yi // 8, xi // 8
    subcls = (yi % 8) * 8 + (xi % 8)
    for k in range(len(kps)):
        i, j = ci[k], cj[k]
        if i < hc and j < wc and resp[k] > best[i, j]:
            best[i, j] = resp[k]
            labels[i, j] = subcls[k]
            sub[i, j, 0] = np.clip(kps[k, 0] - j * 8.0, 0.0, 7.999)
            sub[i, j, 1] = np.clip(kps[k, 1] - i * 8.0, 0.0, 7.999)
    return labels, sub


def vo_pool_config(render_size=(640, 360), sift_slots: int = 1024):
    """The SIFT teacher's configuration: cv2-parity -1 octave, 4 octaves."""
    from visualodometry_tpu_torch.config import VOConfig

    return VOConfig(
        extractor_type="sift",
        max_keypoints=sift_slots,
        sift_n_features=sift_slots,
        sift_contrast_threshold=0.015,
        sift_num_octaves=4,
        sift_first_octave=-1,
        image_size=render_size,
    )


def build_vo_pool(
    rng: np.random.Generator,
    n_scenes: int = 16,
    frames_per_scene: int = 8,
    render_size: tuple[int, int] = (640, 360),
    cache: str | None = None,
    sift_slots: int = 1024,
    device=None,
    timings: dict | None = None,
):
    """Render corridor scenes with depth + SIFT-teacher labels.

    Returns a dict of arrays: imgs (N, H, W) f32, depth (N, H, W) f32,
    labels (N, Hc, Wc) i32, labels_sub (N, Hc, Wc, 2), T_wc (N, 4, 4),
    scene_id (N,), K (3, 3). SIFT runs on `device` (CUDA unless "cpu" is
    asked for). With `timings`, the seconds of rendering and of extraction
    are added to its "render_s" and "extract_s".
    """
    if cache and os.path.exists(cache):
        return dict(np.load(cache))
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_textured_image
    from visualodometry_tpu_torch.frontend.sift import extract_sift

    dev = resolve_device(device)
    W, H = render_size
    cfg = vo_pool_config(render_size, sift_slots)
    t = timings if timings is not None else {}
    imgs, depths, labels, subs, poses, sids = [], [], [], [], [], []
    K = None
    for s in range(n_scenes):
        t0 = time.perf_counter()
        scene = make_scene(
            rng,
            num_frames=frames_per_scene,
            speed=float(rng.uniform(0.9, 2.6)),
            turn_rate=float(rng.uniform(-0.008, 0.008)),
            image_size=render_size,
        )
        K = scene.K
        t["render_s"] = t.get("render_s", 0.0) + time.perf_counter() - t0
        for f in range(frames_per_scene):
            t0 = time.perf_counter()
            img, depth = render_textured_image(scene, f, with_depth=True)
            img = np.clip(img, 0.0, 1.0).astype(np.float32)
            t1 = time.perf_counter()
            feats = extract_sift(torch.from_numpy(img), cfg, device=dev)
            v = feats.valid.cpu().numpy()
            kps = feats.kps.cpu().numpy()[v]
            t["render_s"] = t.get("render_s", 0.0) + t1 - t0
            t["extract_s"] = t.get("extract_s", 0.0) + time.perf_counter() - t1
            # response proxy: the slots' order (top-k sorts per octave)
            resp = -np.arange(len(kps), dtype=np.float32)
            lab, sub = sift_cell_labels(kps, resp, H, W)
            labels.append(lab)
            subs.append(sub)
            imgs.append(img)
            depths.append(depth.astype(np.float32))
            poses.append(scene.poses_T_wc[f].astype(np.float32))
            sids.append(s)
    out = dict(
        imgs=np.stack(imgs),
        depth=np.stack(depths),
        labels=np.stack(labels),
        labels_sub=np.stack(subs),
        T_wc=np.stack(poses),
        scene_id=np.asarray(sids, np.int32),
        K=np.asarray(K, np.float32),
    )
    if cache:
        np.savez_compressed(cache, **out)
    return out


def _sub_batch(img0, img1, labels0, labels1, cell_tgt, cell_valid, sub0) -> TrainBatchSub:
    h = TrainBatchH(*_tensors(img0, img1, labels0, labels1, cell_tgt, cell_valid))
    return TrainBatchSub(h, *_tensors(sub0, labels0 != 64))


def vo_pair_batch(
    rng: np.random.Generator,
    pool: dict,
    batch: int = 16,
    hw: tuple[int, int] = (320, 640),
) -> TrainBatchSub:
    """Consecutive-frame batches with depth-GT cell correspondence."""
    H, W = hw
    hc, wc = H // 8, W // 8
    imgs, depth, labels = pool["imgs"], pool["depth"], pool["labels"]
    labels_sub = pool["labels_sub"]
    T_wc, sid, K = pool["T_wc"], pool["scene_id"], pool["K"]
    FH, FW = imgs.shape[1:]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    img0 = np.zeros((batch, H, W), np.float32)
    img1 = np.zeros((batch, H, W), np.float32)
    labels0 = np.zeros((batch, hc, wc), np.int32)
    labels1 = np.zeros((batch, hc, wc), np.int32)
    sub0 = np.zeros((batch, hc, wc, 2), np.float32)
    cell_tgt = np.zeros((batch, hc, wc, 2), np.int32)
    cell_valid = np.zeros((batch, hc, wc), bool)

    # cell-center pixel coords within the crop
    ci = (np.arange(hc) * 8 + 3.5)[:, None]
    cj = (np.arange(wc) * 8 + 3.5)[None, :]

    n = len(imgs)
    for b in range(batch):
        while True:
            f0 = int(rng.integers(0, n - 1))
            if sid[f0 + 1] == sid[f0]:
                break
        f1 = f0 + 1
        oy = int(rng.integers(0, max((FH - H) // 8, 1))) * 8
        ox = int(rng.integers(0, max((FW - W) // 8, 1))) * 8
        cy0, cx0 = oy // 8, ox // 8
        img0[b] = _jitter(rng, imgs[f0, oy : oy + H, ox : ox + W])
        img1[b] = _jitter(rng, imgs[f1, oy : oy + H, ox : ox + W])
        labels0[b] = labels[f0, cy0 : cy0 + hc, cx0 : cx0 + wc]
        labels1[b] = labels[f1, cy0 : cy0 + hc, cx0 : cx0 + wc]
        sub0[b] = labels_sub[f0, cy0 : cy0 + hc, cx0 : cx0 + wc]

        # depth reprojection of cell centres: frame0 -> world -> frame1
        u = cj + ox
        v = ci + oy
        d = depth[f0][np.clip(v.astype(int), 0, FH - 1), np.clip(u.astype(int), 0, FW - 1)]
        finite = np.isfinite(d)
        xc = (u - cx) / fx * d
        yc = (v - cy) / fy * d
        pc0 = np.stack([xc, yc, np.broadcast_to(d, xc.shape)], axis=-1)  # (hc, wc, 3)
        R0, t0 = T_wc[f0, :3, :3], T_wc[f0, :3, 3]
        R1, t1 = T_wc[f1, :3, :3], T_wc[f1, :3, 3]
        pw = pc0 @ R0.T + t0
        pc1 = (pw - t1) @ R1
        z1 = pc1[..., 2]
        u1 = pc1[..., 0] / np.maximum(z1, 1e-6) * fx + cx - ox
        v1 = pc1[..., 1] / np.maximum(z1, 1e-6) * fy + cy - oy
        ti = (v1 // 8).astype(np.int32)
        tj = (u1 // 8).astype(np.int32)
        cell_valid[b] = finite & (z1 > 0.5) & (ti >= 0) & (ti < hc) & (tj >= 0) & (tj < wc)
        cell_tgt[b, ..., 0] = np.clip(ti, 0, hc - 1)
        cell_tgt[b, ..., 1] = np.clip(tj, 0, wc - 1)

    return _sub_batch(img0, img1, labels0, labels1, cell_tgt, cell_valid, sub0)


def homography_pool_batch(
    rng: np.random.Generator,
    pool: dict,
    batch: int = 16,
    hw: tuple[int, int] = (320, 640),
    strength: float = 0.10,
) -> TrainBatchSub:
    """Homography pairs over pool crops with the SIFT-teacher labels.

    View 0's labels slice from the pool's; view 1's are view 0's label
    keypoints carried through the homography."""
    H, W = hw
    hc, wc = H // 8, W // 8
    imgs, labels = pool["imgs"], pool["labels"]
    labels_sub = pool["labels_sub"]
    FH, FW = imgs.shape[1:]
    img0 = np.zeros((batch, H, W), np.float32)
    img1 = np.zeros((batch, H, W), np.float32)
    labels0 = np.zeros((batch, hc, wc), np.int32)
    labels1 = np.zeros((batch, hc, wc), np.int32)
    sub0 = np.zeros((batch, hc, wc, 2), np.float32)
    cell_tgt = np.zeros((batch, hc, wc, 2), np.int32)
    cell_valid = np.zeros((batch, hc, wc), bool)
    n = len(imgs)
    for b in range(batch):
        f = int(rng.integers(0, n))
        oy = int(rng.integers(0, max((FH - H) // 8, 1))) * 8
        ox = int(rng.integers(0, max((FW - W) // 8, 1))) * 8
        base = imgs[f, oy : oy + H, ox : ox + W].copy()
        lab = labels[f, oy // 8 : oy // 8 + hc, ox // 8 : ox // 8 + wc]
        Hmat = _random_homography(rng, H, W, strength)
        view1 = _warp(base, Hmat)
        img0[b] = _jitter(rng, base)
        img1[b] = _jitter(rng, view1)
        labels0[b] = lab
        sub0[b] = labels_sub[f, oy // 8 : oy // 8 + hc, ox // 8 : ox // 8 + wc]

        # warp the label keypoints (cell + sub-cell offset) through H
        iy, ix = np.nonzero(lab != 64)
        sub = lab[iy, ix]
        px = ix * 8.0 + (sub % 8)
        py = iy * 8.0 + (sub // 8)
        w = Hmat[2, 0] * px + Hmat[2, 1] * py + Hmat[2, 2]
        qx = (Hmat[0, 0] * px + Hmat[0, 1] * py + Hmat[0, 2]) / w
        qy = (Hmat[1, 0] * px + Hmat[1, 1] * py + Hmat[1, 2]) / w
        lab1 = np.full((hc, wc), 64, np.int32)
        ok = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
        qxi = np.clip(np.round(qx[ok]).astype(int), 0, W - 1)
        qyi = np.clip(np.round(qy[ok]).astype(int), 0, H - 1)
        lab1[qyi // 8, qxi // 8] = (qyi % 8) * 8 + (qxi % 8)
        labels1[b] = lab1
        cell_tgt[b], cell_valid[b] = _cell_correspondence(Hmat, hc, wc)

    return _sub_batch(img0, img1, labels0, labels1, cell_tgt, cell_valid, sub0)
