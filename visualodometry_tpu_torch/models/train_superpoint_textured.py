"""Homography-supervised SuperPoint training on textured imagery.

Port of visualodometry_tpu/models/train_superpoint_textured.py:

- images: multi-octave value noise + random shaded polygons + brightness /
  gamma jitter, or crops of pre-rendered corridor frames;
- views: related by a random perspective homography, photometric jitter
  drawn independently per view;
- detector labels: per-view Harris corners, one 65-way label per 8x8 cell;
- descriptor loss: symmetric InfoNCE between homography-corresponding
  cells of the two views.

The image synthesis is numpy, a copy of the JAX module's, and draws from
the `np.random.Generator` in the same order: the same seed gives the same
batch. `pretrain_textured` makes batches on a producer thread
(data/prefetch.py's loader) while the device steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch.models.optim import Adam, linear_schedule
from visualodometry_tpu_torch.models.superpoint import SuperPointBackbone, init_superpoint
from visualodometry_tpu_torch.models.train_superpoint import (
    _tensors,
    cell_ce,
    forward_pair,
    make_step,
)


class TrainBatchH(NamedTuple):
    img0: torch.Tensor  # (B, H, W) float32 in [0, 1]
    img1: torch.Tensor  # (B, H, W) homography-warped second view
    labels0: torch.Tensor  # (B, Hc, Wc) int32 cell class in [0, 64]
    labels1: torch.Tensor  # (B, Hc, Wc)
    cell_tgt: torch.Tensor  # (B, Hc, Wc, 2) int32 (ti, tj) in view 1
    cell_valid: torch.Tensor  # (B, Hc, Wc) bool correspondence in-bounds


# ------------------------- image synthesis (numpy) -------------------------


def _value_noise(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """Multi-octave value noise in [0, 1] (texture base)."""
    out = np.zeros((H, W), np.float32)
    amp, total = 1.0, 0.0
    for octave in range(5):
        g = 4 * (2**octave)
        grid = rng.uniform(0, 1, (g + 2, g + 2)).astype(np.float32)
        ys = np.linspace(0, g, H, endpoint=False)
        xs = np.linspace(0, g, W, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None].astype(np.float32)
        fx = (xs - x0)[None, :].astype(np.float32)
        v = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + grid[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        out += amp * v
        total += amp
        amp *= 0.55
    return out / total


def _add_polygons(rng: np.random.Generator, img: np.ndarray, n: int = 6):
    """Overlay shaded convex quads: corner/edge structure on the texture."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(n):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        r = rng.uniform(6, min(H, W) * 0.35)
        k = rng.integers(3, 6)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        vx = cx + r * np.cos(ang)
        vy = cy + r * np.sin(ang)
        inside = np.ones((H, W), bool)
        for i in range(k):
            ex, ey = vx[(i + 1) % k] - vx[i], vy[(i + 1) % k] - vy[i]
            inside &= (xx - vx[i]) * ey - (yy - vy[i]) * ex <= 0
        shade = rng.uniform(-0.5, 0.5)
        img[inside] = np.clip(img[inside] + shade, 0.0, 1.0)
    return img


def _random_homography(rng: np.random.Generator, H: int, W: int, strength: float) -> np.ndarray:
    """3x3 map from view-0 pixels to view-1 pixels (corner jitter)."""
    src = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]], np.float64)
    jit = rng.uniform(-strength, strength, (4, 2)) * [W, H]
    dst = src + jit
    # DLT for the 8 unknowns
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A), np.asarray(b))
    return np.append(h, 1.0).reshape(3, 3)


def _warp(img: np.ndarray, Hmat: np.ndarray) -> np.ndarray:
    """Inverse bilinear warp: out(p) = img(H^-1 p)."""
    H, W = img.shape
    Hinv = np.linalg.inv(Hmat)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    ones = np.ones_like(xx)
    p = np.stack([xx, yy, ones], axis=0).reshape(3, -1)
    q = Hinv @ p
    qx = (q[0] / q[2]).reshape(H, W)
    qy = (q[1] / q[2]).reshape(H, W)
    x0 = np.clip(np.floor(qx).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(qy).astype(int), 0, H - 2)
    fx = np.clip(qx - x0, 0, 1).astype(np.float32)
    fy = np.clip(qy - y0, 0, 1).astype(np.float32)
    out = (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx)
        + img[y0 + 1, x0 + 1] * fy * fx
    )
    inb = (qx >= 0) & (qx <= W - 1) & (qy >= 0) & (qy <= H - 1)
    return np.where(inb, out, 0.0).astype(np.float32)


def _box(img: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)-box filter via cumsum (Harris structure tensor smoothing)."""
    H, W = img.shape
    pad = np.pad(img, r + 1, mode="edge")
    c = pad.cumsum(0).cumsum(1)
    s = 2 * r + 1
    return (c[s:, s:] - c[:-s, s:] - c[s:, :-s] + c[:-s, :-s])[:H, :W] / (s * s)


def _harris_cell_labels(
    img: np.ndarray, max_cells: int | None = None, rel_thresh: float = 0.01
) -> np.ndarray:
    """65-way per-8x8-cell labels from Harris corner responses.

    `max_cells` defaults to 16% of the cell grid (a density, not a fixed
    count); a relative threshold drops cells below 1% of the strongest.
    """
    H, W = img.shape
    hc, wc = H // 8, W // 8
    if max_cells is None:
        max_cells = max(48, int(0.16 * hc * wc))
    gy, gx = np.gradient(img.astype(np.float32))
    Sxx, Syy, Sxy = _box(gx * gx, 2), _box(gy * gy, 2), _box(gx * gy, 2)
    R = (Sxx * Syy - Sxy * Sxy) - 0.05 * (Sxx + Syy) ** 2
    R[:4, :] = R[-4:, :] = 0.0
    R[:, :4] = R[:, -4:] = 0.0
    cells = R[: hc * 8, : wc * 8].reshape(hc, 8, wc, 8).transpose(0, 2, 1, 3)
    flat = cells.reshape(hc, wc, 64)
    best = flat.argmax(-1)
    score = flat.max(-1)
    order = np.argsort(score.ravel())[::-1][:max_cells]
    labels = np.full((hc, wc), 64, np.int32)  # dustbin
    keep = np.zeros(hc * wc, bool)
    keep[order] = True
    keep &= score.ravel() > rel_thresh * max(score.max(), 1e-12)
    labels.ravel()[keep] = best.ravel()[keep]
    return labels


def _cell_correspondence(Hmat: np.ndarray, hc: int, wc: int):
    """(cell_tgt (hc, wc, 2), cell_valid (hc, wc)): view 0's cell centres
    through the homography, as view 1's cells."""
    ci = (np.arange(hc) * 8 + 3.5)[:, None]
    cj = (np.arange(wc) * 8 + 3.5)[None, :]
    px = Hmat[0, 0] * cj + Hmat[0, 1] * ci + Hmat[0, 2]
    py = Hmat[1, 0] * cj + Hmat[1, 1] * ci + Hmat[1, 2]
    pw = Hmat[2, 0] * cj + Hmat[2, 1] * ci + Hmat[2, 2]
    u, v = px / pw, py / pw
    tj, ti = (u // 8).astype(np.int32), (v // 8).astype(np.int32)
    valid = (ti >= 0) & (ti < hc) & (tj >= 0) & (tj < wc)
    return np.stack([np.clip(ti, 0, hc - 1), np.clip(tj, 0, wc - 1)], axis=-1), valid


def _homography_batch(rng, batch, hw, strength, base_fn, jitter) -> TrainBatchH:
    """Pairs (jitter(base), jitter(warp(base))) with Harris labels on each
    view and the homography's cell correspondence; `base_fn(rng)` draws a
    view-0 image before the homography, as both JAX generators do."""
    H, W = hw
    hc, wc = H // 8, W // 8
    img0 = np.zeros((batch, H, W), np.float32)
    img1 = np.zeros((batch, H, W), np.float32)
    labels0 = np.zeros((batch, hc, wc), np.int32)
    labels1 = np.zeros((batch, hc, wc), np.int32)
    cell_tgt = np.zeros((batch, hc, wc, 2), np.int32)
    cell_valid = np.zeros((batch, hc, wc), bool)
    for b in range(batch):
        base = base_fn(rng)
        Hmat = _random_homography(rng, H, W, strength)
        view1 = _warp(base, Hmat)
        img0[b] = jitter(rng, base)
        img1[b] = jitter(rng, view1)
        labels0[b] = _harris_cell_labels(img0[b])
        labels1[b] = _harris_cell_labels(img1[b])
        cell_tgt[b], cell_valid[b] = _cell_correspondence(Hmat, hc, wc)
    return TrainBatchH(*_tensors(img0, img1, labels0, labels1, cell_tgt, cell_valid))


def _jitter_textured(rng, im):
    g = rng.uniform(0.7, 1.4)
    gain = rng.uniform(0.7, 1.2)
    off = rng.uniform(-0.08, 0.08)
    im = np.clip(gain * np.power(im, g) + off, 0, 1)
    return np.clip(im + rng.normal(0, 0.02, im.shape), 0, 1).astype(np.float32)


def _jitter_corridor(rng, im):
    g = rng.uniform(0.8, 1.25)
    gain = rng.uniform(0.8, 1.15)
    off = rng.uniform(-0.06, 0.06)
    im = np.clip(gain * np.power(np.clip(im, 0, 1), g) + off, 0, 1)
    return np.clip(im + rng.normal(0, 0.015, im.shape), 0, 1).astype(np.float32)


def textured_batch(
    rng: np.random.Generator,
    batch: int = 16,
    hw: tuple[int, int] = (120, 160),
    strength: float = 0.12,
) -> TrainBatchH:
    """Value-noise + polygon worlds under random homographies."""
    H, W = hw
    return _homography_batch(
        rng, batch, hw, strength, lambda r: _add_polygons(r, _value_noise(r, H, W)),
        _jitter_textured,
    )


# ------------------------------- losses -----------------------------------


def info_nce_sym(desc0, desc1, cell_tgt, cell_valid) -> torch.Tensor:
    """Symmetric InfoNCE over corresponding cells: desc (B, Hc, Wc, D),
    cell_tgt (B, Hc, Wc, 2) view-1 cell of each view-0 cell, cell_valid
    (B, Hc, Wc). Each term is the mean over valid cells of the two
    directions' cross entropies at temperature 0.1."""
    B, hc, wc, _ = desc0.shape
    bidx = torch.arange(B, device=desc0.device)[:, None, None]
    tgt = cell_tgt.long()
    d1_at = desc1[bidx, tgt[..., 0], tgt[..., 1]]
    sim = torch.einsum(
        "bnd,bmd->bnm", desc0.reshape(B, hc * wc, -1), d1_at.reshape(B, hc * wc, -1)
    ) / 0.1
    rows = torch.diagonal(torch.log_softmax(sim, dim=-1), dim1=1, dim2=2)
    cols = torch.diagonal(torch.log_softmax(sim, dim=-2), dim1=1, dim2=2)
    per_cell = -0.5 * (rows + cols)
    mask = cell_valid.reshape(B, hc * wc).to(torch.float32)
    return torch.sum(per_cell * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_h(det0, desc0, det1, desc1, batch: TrainBatchH, desc_w: float):
    det_loss = 0.5 * (cell_ce(det0, batch.labels0) + cell_ce(det1, batch.labels1))
    desc_loss = info_nce_sym(desc0, desc1, batch.cell_tgt, batch.cell_valid)
    return det_loss + desc_w * desc_loss, (det_loss, desc_loss)


def loss_fn_h(model: SuperPointBackbone, batch: TrainBatchH, desc_w: float = 1.0):
    """(total, (det_loss, desc_loss)): both views' cell CE, halved, plus
    the symmetric InfoNCE."""
    return _loss_h(*forward_pair(model, batch.img0, batch.img1), batch, desc_w)


def make_train_step_h(model: SuperPointBackbone, optimizer: Adam, group=None):
    return make_step(model, optimizer, loss_fn_h, group)


def corridor_crop_pool(
    rng: np.random.Generator,
    n_scenes: int = 6,
    frames_per_scene: int = 4,
    render_size: tuple[int, int] = (640, 360),
) -> list[np.ndarray]:
    """Pre-render textured-corridor images (the deployment distribution)
    for crop-based homography training."""
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_textured_image

    pool = []
    for _ in range(n_scenes):
        scene = make_scene(
            rng,
            num_frames=frames_per_scene,
            speed=1.2,
            turn_rate=rng.uniform(-0.004, 0.004),
            image_size=render_size,
        )
        for f in range(frames_per_scene):
            pool.append(render_textured_image(scene, f).astype(np.float32))
    return pool


def corridor_batch(
    rng: np.random.Generator,
    pool: list[np.ndarray],
    batch: int = 16,
    hw: tuple[int, int] = (240, 320),
    strength: float = 0.10,
) -> TrainBatchH:
    """Homography pairs whose view-0 images are random crops of the pool's
    corridor frames; labels and correspondence as `textured_batch`'s."""
    H, W = hw

    def crop(r):
        src = pool[r.integers(0, len(pool))]
        sh, sw = src.shape
        y = r.integers(0, max(sh - H, 1))
        x = r.integers(0, max(sw - W, 1))
        return src[y : y + H, x : x + W].copy()

    return _homography_batch(rng, batch, hw, strength, crop, _jitter_corridor)


def pretrain_textured(
    steps: int = 2000,
    batch: int = 24,
    lr: float = 1e-3,
    seed: int = 0,
    hw: tuple[int, int] = (120, 160),
    init_model: SuperPointBackbone | None = None,
    log_every: int = 100,
    curriculum=((0.04, 0.3), (0.12, 1.0)),
    corridor: bool = False,
    device=None,
):
    """Train with a warp-strength curriculum; returns (model, log).

    `curriculum` is a list of (strength, fraction-of-steps boundary): easy
    near-affine warps first, full perspective after. With `corridor=True`
    the images are crops of pre-rendered corridor frames. Adam's rate falls
    linearly from `lr` to lr/10 over the steps. `log` holds (step, loss,
    det_loss, desc_loss) every `log_every` steps and at the last.
    """
    from visualodometry_tpu_torch.data.prefetch import PrefetchLoader

    model = (
        init_model
        if init_model is not None
        else init_superpoint(torch.Generator().manual_seed(seed), hw, device=device)
    )
    rng = np.random.default_rng(seed)
    opt = Adam(model.parameters(), linear_schedule(lr, lr * 0.1, steps))
    train_step = make_train_step_h(model, opt)

    def strength_at(i):
        frac = i / steps
        for s, bound in curriculum:
            if frac < bound:
                return s
        return curriculum[-1][0]

    pool = corridor_crop_pool(rng) if corridor else None

    def make_batch(i):
        if corridor:
            return corridor_batch(rng, pool, batch=batch, hw=hw, strength=strength_at(i))
        return textured_batch(rng, batch=batch, hw=hw, strength=strength_at(i))

    log = []
    # host batches made on a producer thread while the device steps
    for i, b in enumerate(PrefetchLoader(range(steps), depth=4, decode=make_batch)):
        loss, aux = train_step(b)
        if i % log_every == 0 or i == steps - 1:
            log.append((i, float(loss), float(aux[0]), float(aux[1])))
    return model, log
