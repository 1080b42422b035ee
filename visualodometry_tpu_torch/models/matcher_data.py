"""Real-descriptor training data for the attention matcher.

Port of visualodometry_tpu/models/matcher_data.py: match problems from the
actual frontend. Textured homography-warped pairs (`build_sift_match_dataset`)
or consecutive textured-corridor frames at the marathon speed
(`build_vo_match_dataset`) run through the port's SIFT extractor (K2 on
CUDA), and the ground-truth assignment comes from the homography or the
rendered depth, one-to-one (`gt_assignment`). The dataset is extracted once
and then sampled into minibatches (`sample_batch`, `subsample_slots`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.models.train_matcher import MatchBatch
from visualodometry_tpu_torch.models.train_superpoint import _tensors
from visualodometry_tpu_torch.models.train_superpoint_textured import (
    _add_polygons,
    _random_homography,
    _value_noise,
    _warp,
)

_KEYS = ("kps0", "desc0", "valid0", "kps1", "desc1", "valid1", "gt_idx")
VO_FRAMES_PER_SCENE = 8  # frames of each corridor scene of `build_vo_match_dataset`


def match_config(image_size, n_slots: int) -> VOConfig:
    """The SIFT configuration of both `build_*` functions (3 octaves,
    contrast 0.02)."""
    return VOConfig(
        extractor_type="sift",
        max_keypoints=n_slots,
        sift_n_features=n_slots,
        sift_contrast_threshold=0.02,
        sift_num_octaves=3,
        image_size=image_size,
    )


def gt_assignment(uv, inb, k1, valid1, match_tol: float) -> np.ndarray:
    """One-to-one ground truth: each frame-0 keypoint mapped to `uv` in
    frame 1 (in-frame where `inb`) takes its nearest valid frame-1 slot
    `k1` within `match_tol` px; a frame-1 slot is claimed once, by the
    nearest claimant first. Returns (N0,) int32, -1 = unmatched."""
    d = np.linalg.norm(uv[:, None, :] - k1[None, :, :], axis=-1)
    d[:, ~valid1] = np.inf
    nearest = d.argmin(axis=1)
    dmin = d[np.arange(len(uv)), nearest]
    ok = inb & (dmin < match_tol)
    gt = np.full(len(uv), -1, np.int32)
    taken = np.zeros(len(k1), bool)
    for idx in np.argsort(dmin):
        if ok[idx] and not taken[nearest[idx]]:
            gt[idx] = nearest[idx]
            taken[nearest[idx]] = True
    return gt


def _features(extract, img: np.ndarray):
    f = extract(torch.from_numpy(np.ascontiguousarray(img, np.float32)))
    return f.kps.cpu().numpy(), f.desc.cpu().numpy(), f.valid.cpu().numpy()


def _timed(t: dict, key: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    t[key] = t.get(key, 0.0) + time.perf_counter() - t0
    return out


def build_sift_match_dataset(
    rng: np.random.Generator,
    n_pairs: int = 256,
    hw: tuple[int, int] = (240, 320),
    n_slots: int = 512,
    strength: float = 0.10,
    match_tol: float = 3.0,
    log_every: int = 64,
    device=None,
    timings: dict | None = None,
) -> dict:
    """SIFT on homography pairs; ground truth from the warp.

    Returns numpy arrays {kps0, desc0, valid0, kps1, desc1, valid1,
    gt_idx} with leading axis n_pairs, keypoints normalized to [-1, 1].
    SIFT runs on `device` (CUDA unless "cpu" is asked for); with `timings`
    the seconds of rendering and extraction add to "render_s" and
    "extract_s".
    """
    from visualodometry_tpu_torch.frontend.sift import extract_sift

    dev = resolve_device(device)
    H, W = hw
    cfg = match_config((W, H), n_slots)
    t = timings if timings is not None else {}
    out = {k: [] for k in _KEYS}
    norm = np.array([W, H], np.float32)

    def extract(img):
        return extract_sift(img, cfg, device=dev)

    def render():
        base = _add_polygons(rng, _value_noise(rng, H, W))
        Hmat = _random_homography(rng, H, W, strength)
        return base, Hmat, _warp(base, Hmat)

    for i in range(n_pairs):
        base, Hmat, img1 = _timed(t, "render_s", render)
        k0, desc0, v0 = _timed(t, "extract_s", _features, extract, base)
        k1, desc1, v1 = _timed(t, "extract_s", _features, extract, img1)

        # frame-0 keypoints through H, matched to the nearest frame-1 slot
        p = np.concatenate([k0, np.ones((len(k0), 1), np.float32)], axis=1)
        q = (Hmat @ p.T).T
        uv = q[:, :2] / np.maximum(np.abs(q[:, 2:]), 1e-9) * np.sign(q[:, 2:])
        inb = v0 & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        gt = gt_assignment(uv, inb, k1, v1, match_tol)

        for k, v in zip(_KEYS, (k0 / norm * 2.0 - 1.0, desc0, v0, k1 / norm * 2.0 - 1.0,
                                desc1, v1, gt)):
            out[k].append(v)
        if log_every and (i + 1) % log_every == 0:
            print(f"dataset {i + 1}/{n_pairs}", flush=True)
    return {k: np.stack(v) for k, v in out.items()}


def build_vo_match_dataset(
    rng: np.random.Generator,
    n_pairs: int = 96,
    image_size: tuple[int, int] = (1226, 370),
    n_slots: int = 4096,
    speed: float = 2.4,
    gaps: tuple = (1, 2),
    match_tol: float = 3.0,
    log_every: int = 16,
    device=None,
    timings: dict | None = None,
) -> dict:
    """Deployment-regime match problems: consecutive textured-corridor
    frames at the marathon speed (gap 2 is the 2x-speed regime), 4096 SIFT
    slots at full KITTI width, ground truth from the rendered depth
    (data/synthetic.gt_correspondence), one-to-one. Arguments as
    `build_sift_match_dataset`'s; scenes of VO_FRAMES_PER_SCENE frames."""
    from visualodometry_tpu_torch.data.synthetic import (
        gt_correspondence,
        make_scene,
        render_textured_image,
    )
    from visualodometry_tpu_torch.frontend.sift import extract_sift

    dev = resolve_device(device)
    W, H = image_size
    cfg = match_config(image_size, n_slots)
    t = timings if timings is not None else {}
    norm = np.array([W, H], np.float32)
    out = {k: [] for k in _KEYS}
    max_gap = max(gaps)
    frames_per_scene = VO_FRAMES_PER_SCENE
    n_scenes = int(np.ceil(n_pairs / (len(gaps) * (frames_per_scene - max_gap))))

    def extract(img):
        return extract_sift(img, cfg, device=dev)

    def render(scene):
        return [render_textured_image(scene, f, with_depth=True)
                for f in range(frames_per_scene)]

    made = 0
    for s in range(n_scenes):
        scene = make_scene(
            rng, num_frames=frames_per_scene, speed=speed,
            turn_rate=rng.uniform(0.0, 0.006), num_landmarks=2,
            image_size=image_size,
        )
        rendered = _timed(t, "render_s", render, scene)
        feats = [_timed(t, "extract_s", _features, extract, im) for im, _ in rendered]
        for a in range(frames_per_scene - max_gap):
            for g in gaps:
                if made >= n_pairs:
                    break
                b = a + g
                k0, desc0, v0 = feats[a]
                k1, desc1, v1 = feats[b]
                k0 = k0.astype(np.float64)
                k1 = k1.astype(np.float64)
                uv, ok_d = gt_correspondence(scene, a, b, k0.astype(np.float32), rendered[a][1])
                inb = (v0 & ok_d & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                       & (uv[:, 1] >= 0) & (uv[:, 1] < H))
                gt = gt_assignment(uv, inb, k1, v1, match_tol)
                for k, v in zip(_KEYS, (
                    (k0 / norm * 2.0 - 1.0).astype(np.float32), desc0, v0,
                    (k1 / norm * 2.0 - 1.0).astype(np.float32), desc1, v1, gt,
                )):
                    out[k].append(v)
                made += 1
        if log_every and (s + 1) % max(1, log_every // 8) == 0:
            print(f"vo dataset scenes {s + 1}/{n_scenes} pairs {made}", flush=True)
        if made >= n_pairs:
            break
    return {k: np.stack(v) for k, v in out.items()}


def subsample_slots(b: dict, rng: np.random.Generator, n_sub: int) -> dict:
    """A random subset of `n_sub` slots a side per pair (ground-truth
    indices remapped); valid slots first, padding fills the rest."""
    B, N = b["valid0"].shape
    out = {k: np.empty((B, n_sub) + v.shape[2:], v.dtype) for k, v in b.items()}
    for i in range(B):
        keeps = []
        for side in ("0", "1"):
            v = b[f"valid{side}"][i]
            pool = np.nonzero(v)[0]
            pad = np.nonzero(~v)[0]
            if len(pool) >= n_sub:
                keep = rng.choice(pool, n_sub, replace=False)
            else:
                keep = np.concatenate([pool, rng.choice(pad, n_sub - len(pool), replace=False)])
            keep.sort()
            keeps.append(keep)
        keep0, keep1 = keeps
        inv1 = np.full(N, -1, np.int64)
        inv1[keep1] = np.arange(n_sub)
        for k in ("kps0", "desc0", "valid0"):
            out[k][i] = b[k][i][keep0]
        for k in ("kps1", "desc1", "valid1"):
            out[k][i] = b[k][i][keep1]
        g = b["gt_idx"][i][keep0]
        out["gt_idx"][i] = np.where(g >= 0, inv1[g], -1).astype(np.int32)
    return out


def as_match_batch(b: dict) -> MatchBatch:
    """A dict of numpy arrays as a MatchBatch of CPU tensors."""
    return MatchBatch(*_tensors(*(b[k] for k in _KEYS)))


def sample_batch(data: dict, rng: np.random.Generator, batch: int) -> MatchBatch:
    """Random minibatch with slot-dropout augmentation."""
    n_total = len(data["kps0"])
    sel = rng.integers(0, n_total, batch)
    b = {k: v[sel].copy() for k, v in data.items()}
    n = b["kps0"].shape[1]
    for i in range(batch):  # random slot dropout (padding realism)
        drop0 = rng.choice(n, n // 10, replace=False)
        drop1 = rng.choice(n, n // 10, replace=False)
        b["valid0"][i, drop0] = False
        b["valid1"][i, drop1] = False
        b["gt_idx"][i, drop0] = -1
        b["gt_idx"][i, np.isin(b["gt_idx"][i], drop1)] = -1
    return as_match_batch(b)


def vo_match_batch(data: dict, rng: np.random.Generator, batch: int = 4,
                   n_sub: int = 1024) -> MatchBatch:
    """A minibatch of VO problems cut to `n_sub` random slots a side (the v3
    recipe's: attention at the full 4096 slots is O(N^2) in training)."""
    sel = rng.integers(0, len(data["kps0"]), batch)
    return as_match_batch(subsample_slots({k: v[sel].copy() for k, v in data.items()}, rng, n_sub))


def load_or_build(path: str, build) -> dict:
    """The dataset cached at `path`, or `build()`'s, saved there."""
    if os.path.exists(path):
        data = dict(np.load(path))
        print(f"loaded {len(data['kps0'])} problems ({path})", flush=True)
        return data
    data = build()
    np.savez_compressed(path, **data)
    print(f"built {len(data['kps0'])} problems ({path})", flush=True)
    return data


def held_out_split(data: dict, frac: int = 8):
    """(train, held out): the first max(n / frac, 8) problems are held out,
    as the JAX training scripts split."""
    n_test = max(len(data["kps0"]) // frac, 8)
    return {k: v[n_test:] for k, v in data.items()}, {k: v[:n_test] for k, v in data.items()}
