"""Synthetic drive and textured-corridor renderer (pure numpy).

The port's own copy of the parts of visualodometry_tpu/data/synthetic.py
that render the bench fixture: `make_scene` (a KITTI-like forward drive)
and `render_textured_image` (a ray-cast corridor: ground plane and two
side walls) with the value-noise or the photo texture. Same code, same
seeds, so the frames are the same as the JAX package's. Also the dot renderer
`render_image` (the KLT tests' frames), `render_features` (projected
landmarks as `Features`) and `gt_correspondence`. Also its long fixtures
(`make_marathon_fixture`, `make_long_corridor_fixture`: S-curves and
blackout windows that force resets) and `segment_ate`, their metric; and
`make_pnp_problem`, the pose polish's correspondences.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from visualodometry_tpu_torch.frontend.interface import Features, pad_features

K_DEFAULT = np.array(
    [[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]],
    dtype=np.float32,
)


@dataclass
class SyntheticScene:
    K: np.ndarray  # (3, 3)
    image_size: tuple[int, int]  # (W, H)
    landmarks: np.ndarray  # (L, 3) world points
    base_desc: np.ndarray  # (L, D) unit descriptors
    poses_T_wc: np.ndarray  # (F, 4, 4) ground-truth world-from-camera

    @property
    def num_frames(self) -> int:
        return len(self.poses_T_wc)

    @property
    def gt_positions(self) -> np.ndarray:
        return self.poses_T_wc[:, :3, 3]


def _yaw_T_wc(pos: np.ndarray, yaw: float) -> np.ndarray:
    """Camera at `pos` looking along the yaw direction (y-down convention)."""
    c, s = np.cos(yaw), np.sin(yaw)
    forward = np.array([s, 0.0, c])
    right = np.array([c, 0.0, -s])
    down = np.array([0.0, 1.0, 0.0])
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = forward
    T[:3, 3] = pos
    return T


def make_scene(
    rng: np.random.Generator,
    num_frames: int = 60,
    speed: float = 1.0,
    turn_rate: float = 0.004,
    num_landmarks: int = 6000,
    desc_dim: int = 128,
    image_size: tuple[int, int] = (1226, 370),
    K: np.ndarray | None = None,
    depth_range: tuple[float, float] = (5.0, 60.0),
    lateral_range: float = 25.0,
    turn_profile: np.ndarray | None = None,
) -> SyntheticScene:
    """KITTI-like forward drive with a gentle curve and roadside landmarks.

    `turn_profile` (num_frames,) overrides the constant `turn_rate` with a
    per-frame yaw rate (rad per unit distance).
    """
    if K is None:
        if image_size == (1226, 370):
            K = K_DEFAULT
        else:
            # the KITTI camera scaled to the viewport: same field of view,
            # principal point at the image center
            W, H = image_size
            f = 718.856 / 1226.0 * W
            K = np.array(
                [[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]],
                dtype=np.float32,
            )
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for f in range(num_frames):
        poses.append(_yaw_T_wc(pos.copy(), yaw))
        heading = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + speed * heading
        rate = turn_rate if turn_profile is None else float(turn_profile[f])
        yaw += rate * speed
    poses = np.stack(poses)

    anchor = rng.integers(0, num_frames, num_landmarks)
    T_anchor = poses[anchor]
    offs_cam = np.stack(
        [
            rng.uniform(-lateral_range, lateral_range, num_landmarks),
            rng.uniform(-4, 3, num_landmarks),
            rng.uniform(*depth_range, num_landmarks),
        ],
        axis=1,
    )
    landmarks = (
        np.einsum("lij,lj->li", T_anchor[:, :3, :3], offs_cam)
        + T_anchor[:, :3, 3]
    )
    base_desc = rng.normal(size=(num_landmarks, desc_dim)).astype(np.float32)
    base_desc /= np.linalg.norm(base_desc, axis=1, keepdims=True)
    return SyntheticScene(
        K=K.astype(np.float32),
        image_size=image_size,
        landmarks=landmarks.astype(np.float32),
        base_desc=base_desc,
        poses_T_wc=poses.astype(np.float32),
    )


def render_features(
    scene: SyntheticScene,
    frame: int,
    num_slots: int,
    rng: np.random.Generator,
    pixel_noise: float = 0.3,
    desc_noise: float = 0.02,
    outlier_frac: float = 0.0,
    max_depth: float = 80.0,
    device=None,
) -> Features:
    """Project visible landmarks into the frame's camera as `Features`
    on `device` (CUDA unless "cpu" is asked for)."""
    T_wc = scene.poses_T_wc[frame]
    R_cw = T_wc[:3, :3].T
    t_cw = -R_cw @ T_wc[:3, 3]
    p_cam = scene.landmarks @ R_cw.T + t_cw
    z = p_cam[:, 2]
    W, H = scene.image_size
    uv = p_cam[:, :2] / np.maximum(z[:, None], 1e-6)
    uv = uv * [scene.K[0, 0], scene.K[1, 1]] + [scene.K[0, 2], scene.K[1, 2]]
    visible = (
        (z > 1.0) & (z < max_depth) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
        & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    )
    # deterministic priority (landmark index): a response-ranked detector
    # whose selection is stable across frames
    idx = np.flatnonzero(visible)[:num_slots]
    kps = uv[idx] + rng.normal(0, pixel_noise, (len(idx), 2))
    desc = scene.base_desc[idx] + rng.normal(
        0, desc_noise, (len(idx), scene.base_desc.shape[1])
    ).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    if outlier_frac > 0 and len(idx) > 0:
        n_out = int(outlier_frac * len(idx))
        out_sel = rng.choice(len(idx), n_out, replace=False)
        kps[out_sel] = np.stack(
            [rng.uniform(0, W, n_out), rng.uniform(0, H, n_out)], axis=1
        )
    return pad_features(kps.astype(np.float32), desc, num_slots, device=device)


def gt_correspondence(
    scene: SyntheticScene,
    frame_a: int,
    frame_b: int,
    kps_a: np.ndarray,
    depth_a: np.ndarray,
):
    """Map pixel keypoints in frame A to their true locations in frame B.

    Unprojects each keypoint with frame A's rendered depth and projects
    the world point into frame B. Returns (uv_b (N, 2), valid (N,)): valid
    marks finite depth and in front of camera B.
    """
    W, H = scene.image_size
    Kmat = scene.K
    xi = np.clip(np.round(kps_a[:, 0]).astype(int), 0, W - 1)
    yi = np.clip(np.round(kps_a[:, 1]).astype(int), 0, H - 1)
    z = depth_a[yi, xi]
    ok = np.isfinite(z)
    z = np.where(ok, z, 0.0)  # NaN-free math for masked slots
    d_cam = np.stack(
        [
            (kps_a[:, 0] - Kmat[0, 2]) / Kmat[0, 0],
            (kps_a[:, 1] - Kmat[1, 2]) / Kmat[1, 1],
            np.ones(len(kps_a)),
        ],
        axis=1,
    )
    T_a = scene.poses_T_wc[frame_a]
    p_w = (d_cam * z[:, None]) @ T_a[:3, :3].T + T_a[:3, 3]
    T_b = scene.poses_T_wc[frame_b]
    R_cw = T_b[:3, :3].T
    p_c = (p_w - T_b[:3, 3]) @ R_cw.T
    ok &= p_c[:, 2] > 0.5
    uv = p_c[:, :2] / np.maximum(p_c[:, 2:], 1e-9)
    uv = uv * [Kmat[0, 0], Kmat[1, 1]] + [Kmat[0, 2], Kmat[1, 2]]
    return uv.astype(np.float32), ok


def render_image(
    scene: SyntheticScene,
    frame: int,
    max_depth: float = 80.0,
    dot_sigma: float = 2.2,
    subdots: int = 1,
) -> np.ndarray:
    """Render the frame as a grayscale image of Gaussian dots, (H, W)
    float32 in [0, 1].

    Each visible landmark becomes an anti-aliased blob of a stable
    per-landmark intensity. With `subdots > 1` each landmark is a rigid
    constellation of that many blobs, which makes its local pattern unique.
    """
    W, H = scene.image_size
    T_wc = scene.poses_T_wc[frame]
    R_cw = T_wc[:3, :3].T
    t_cw = -R_cw @ T_wc[:3, 3]
    p_cam = scene.landmarks @ R_cw.T + t_cw
    z = p_cam[:, 2]
    uv = p_cam[:, :2] / np.maximum(z[:, None], 1e-6)
    uv = uv * [scene.K[0, 0], scene.K[1, 1]] + [scene.K[0, 2], scene.K[1, 2]]
    m = 3 * dot_sigma
    vis = (
        (z > 1.0) & (z < max_depth) & (uv[:, 0] >= -m) & (uv[:, 0] < W + m)
        & (uv[:, 1] >= -m) & (uv[:, 1] < H + m)
    )
    idx = np.flatnonzero(vis)
    img = np.zeros((H, W), np.float32)
    L = len(scene.landmarks)
    # stable per-landmark appearance (fixed seed: identical across frames)
    rng_int = np.random.default_rng(12345)
    intensities = rng_int.uniform(0.35, 1.0, (L, subdots)).astype(np.float32)
    if subdots > 1:
        offs = rng_int.uniform(
            -2.5 * dot_sigma, 2.5 * dot_sigma, (L, subdots, 2)
        ).astype(np.float32)
        offs[:, 0] = 0.0  # the primary blob stays on the projection
        pad = 2.5 * dot_sigma
    else:
        offs = np.zeros((L, 1, 2), np.float32)
        pad = 0.0
    r = int(np.ceil(m + pad))
    ys = np.arange(-r, r + 1)
    xs = np.arange(-r, r + 1)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    inv2s2 = 1.0 / (2 * dot_sigma**2)
    for i in idx:
        cx, cy = uv[i]
        x0, y0 = int(round(cx)), int(round(cy))
        patch = np.zeros_like(gx, dtype=np.float32)
        for s in range(subdots):
            dx, dy = offs[i, s]
            patch = np.maximum(
                patch,
                intensities[i, s]
                * np.exp(-((gx + x0 - cx - dx) ** 2 + (gy + y0 - cy - dy) ** 2) * inv2s2),
            )
        ylo, yhi = y0 - r, y0 + r + 1
        xlo, xhi = x0 - r, x0 + r + 1
        py0, px0 = max(0, -ylo), max(0, -xlo)
        ylo, xlo = max(0, ylo), max(0, xlo)
        yhi, xhi = min(H, yhi), min(W, xhi)
        if yhi <= ylo or xhi <= xlo:
            continue
        img[ylo:yhi, xlo:xhi] = np.maximum(
            img[ylo:yhi, xlo:xhi],
            patch[py0 : py0 + yhi - ylo, px0 : px0 + xhi - xlo],
        )
    return img


def _value_noise(u: np.ndarray, v: np.ndarray, seed: int) -> np.ndarray:
    """Multi-octave value noise sampled at world coords (u, v) in [0,1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(u, dtype=np.float32)
    amp, total = 1.0, 0.0
    for octave in range(5):
        freq = 0.7 * (2.0**octave)
        grid = rng.uniform(0, 1, (64, 64)).astype(np.float32)
        x = (u * freq) % 64.0
        y = (v * freq) % 64.0
        x0 = np.floor(x).astype(int) % 64
        y0 = np.floor(y).astype(int) % 64
        x1 = (x0 + 1) % 64
        y1 = (y0 + 1) % 64
        fx = (x - np.floor(x)).astype(np.float32)
        fy = (y - np.floor(y)).astype(np.float32)
        val = (
            grid[y0, x0] * (1 - fx) * (1 - fy)
            + grid[y0, x1] * fx * (1 - fy)
            + grid[y1, x0] * (1 - fx) * fy
            + grid[y1, x1] * fx * fy
        )
        out += amp * val
        total += amp
        amp *= 0.55
    return out / total


@functools.lru_cache(maxsize=8)
def _photo_mosaic(seed: int = 0, tiles: int = 3):
    """Real-photograph texture mosaic (grayscale [0, 1], read-only), or None.

    Source: matplotlib's bundled sample photograph (the public-domain
    U.S. Navy portrait of Grace Hopper), read with PIL; None when either
    is missing. Square-cropped and tiled with seeded per-tile flips and
    rotations so lattice periodicity doesn't plant exact-repeat
    correspondences.
    """
    try:
        import matplotlib
        from PIL import Image
    except ImportError:
        return None
    p = Path(matplotlib.get_data_path()) / "sample_data" / "grace_hopper.jpg"
    try:
        with Image.open(p) as src:
            im = np.asarray(src.convert("L"), np.float32) / 255.0
    except OSError:
        return None
    s = min(im.shape)
    im = im[:s, :s]
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(tiles):
        row = []
        for _ in range(tiles):
            t = im
            if rng.random() < 0.5:
                t = t[:, ::-1]
            if rng.random() < 0.5:
                t = t[::-1, :]
            t = np.rot90(t, k=int(rng.integers(4)))
            row.append(t)
        rows.append(np.concatenate(row, 1))
    mosaic = np.ascontiguousarray(np.concatenate(rows, 0))
    mosaic.setflags(write=False)
    return mosaic


def _photo_texture(u: np.ndarray, v: np.ndarray, seed: int, scale: float = 32.0) -> np.ndarray:
    """Bilinear-sample the photo mosaic at world coords (wrap-around).

    `scale` = mosaic pixels per world unit. Value noise when the photo
    is unavailable.
    """
    m = _photo_mosaic(seed % 7)
    if m is None:
        return _value_noise(u, v, seed)
    H, W = m.shape
    x = (u * scale) % W  # numpy % maps negatives into [0, W)
    y = (v * scale) % H
    x0 = np.floor(x).astype(int) % W
    y0 = np.floor(y).astype(int) % H
    x1 = (x0 + 1) % W
    y1 = (y0 + 1) % H
    fx = (x - np.floor(x)).astype(np.float32)
    fy = (y - np.floor(y)).astype(np.float32)
    return (
        m[y0, x0] * (1 - fx) * (1 - fy)
        + m[y0, x1] * fx * (1 - fy)
        + m[y1, x0] * (1 - fx) * fy
        + m[y1, x1] * fx * fy
    )


def render_textured_image(
    scene: SyntheticScene,
    frame: int,
    with_depth: bool = False,
    ground_y: float = 2.0,
    wall_x: float = 14.0,
    texture: str = "noise",
):
    """Ray-cast a textured corridor world (ground plane + two side walls).

    `texture` "noise" is multi-octave value noise on real 3D surfaces
    under true perspective; "photo" samples a photograph mosaic there
    (value noise when the photo is unavailable). Returns (H, W) float32 in
    [0, 1]; with `with_depth`, also the (H, W) float32 depth (camera z;
    inf for sky).
    """
    if texture not in ("noise", "photo"):
        raise ValueError(f"render_textured_image: unknown texture {texture!r}")
    W, H = scene.image_size
    T_wc = scene.poses_T_wc[frame]
    R_wc = T_wc[:3, :3]
    origin = T_wc[:3, 3]
    fx, fy = scene.K[0, 0], scene.K[1, 1]
    cx, cy = scene.K[0, 2], scene.K[1, 2]
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float32)],
        axis=-1,
    ).astype(np.float32)
    d_w = d_cam @ R_wc.T  # (H, W, 3)

    img = np.zeros((H, W), np.float32)
    depth = np.full((H, W), np.inf, np.float32)
    best_t = np.full((H, W), np.inf, np.float32)

    tex_fn = _photo_texture if texture == "photo" else _value_noise

    def shade(t, valid, texture_uv, seed, shade_scale):
        hit = valid & (t > 0.5) & (t < best_t)
        if not hit.any():
            return
        tex = tex_fn(texture_uv[0][hit], texture_uv[1][hit], seed)
        img[hit] = (0.15 + 0.8 * tex) * shade_scale
        best_t[hit] = t[hit]
        depth[hit] = (t * d_cam[..., 2])[hit]

    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (ground_y - origin[1]) / d_w[..., 1]
        pg = origin + tg[..., None] * d_w
        shade(tg, d_w[..., 1] > 1e-6, (pg[..., 0], pg[..., 2]), 101, 1.0)
        for sx, seed in ((-wall_x, 202), (wall_x, 303)):
            tw = (sx - origin[0]) / d_w[..., 0]
            pw = origin + tw[..., None] * d_w
            wall_valid = np.abs(d_w[..., 0]) > 1e-6
            wall_valid &= pw[..., 1] > -6.0
            shade(tw, wall_valid, (pw[..., 2], pw[..., 1]), seed, 0.9)

    if with_depth:
        return img, depth
    return img


def render_fixture_u8(scene: SyntheticScene) -> np.ndarray:
    """Every frame of `scene` as uint8 (F, H, W), rounded as the bench does."""
    imgs = np.stack(
        [render_textured_image(scene, f) for f in range(scene.num_frames)]
    )
    return (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)


def _render_drive_u8(rng, num_frames, speed, image_size, rate, blanks):
    """A textured drive with yaw-rate profile `rate`, as uint8 frames,
    with near-featureless frames written over each `blanks` window."""
    scene = make_scene(
        rng,
        num_frames=num_frames,
        speed=speed,
        num_landmarks=2,  # the textured renderer ignores point landmarks
        image_size=image_size,
        turn_profile=rate,
    )
    W, H = image_size
    frames = np.empty((num_frames, H, W), np.uint8)
    for f in range(num_frames):
        img = render_textured_image(scene, f)
        frames[f] = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    for b0, b1 in blanks:
        flat = 90.0 + 2.0 * rng.standard_normal((b1 - b0, H, W))
        frames[b0:b1] = np.clip(flat, 0, 255).astype(np.uint8)
    return frames, scene


def make_marathon_fixture(
    num_frames: int = 1024,
    image_size: tuple[int, int] = (1226, 370),
    speed: float = 2.4,
    seed: int = 13,
    blanks: tuple = ((240, 243), (540, 544), (820, 822)),
):
    """Marathon-scale drive: KITTI-magnitude flows, S-curves, blackouts.

    The corridor recipe at double frame speed (median inter-frame flows in
    the tens of pixels, the regime of the KITTI gate set), a bounded
    S-curve yaw profile yaw(t) = A sin(2 pi t / P) with A = 0.08 rad and
    P = 96 frames starting after one period, and blackout windows that
    each force the reset / re-bootstrap path. Every window of `blanks`
    must lie inside `num_frames`.
    Returns (u8 frames (F, H, W), gt_positions (F, 3), K, blanks).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames, dtype=np.float64)
    period = 96.0
    A = 0.08  # peak x excursion 11.6 m < wall at 14
    # gated at a full period: a mid-cycle gate leaves a constant heading
    # bias that integrates to a lateral runaway
    rate = (
        A * (2.0 * np.pi / period) / speed
        * np.cos(2.0 * np.pi * t / period)
        * (t >= period)
    )
    frames, scene = _render_drive_u8(rng, num_frames, speed, image_size, rate, blanks)
    return frames, scene.gt_positions, scene.K, blanks


def make_long_corridor_fixture(
    num_frames: int = 256,
    image_size: tuple[int, int] = (1226, 370),
    speed: float = 1.2,
    seed: int = 7,
    blank: tuple[int, int] | None = (150, 153),
):
    """Long textured-corridor drive with two S-curves (peak ~0.8 deg/frame,
    above the engine's turn threshold) and one `blank` window of
    near-featureless frames that forces a reset and a re-bootstrap.

    Returns (u8 frames (F, H, W), gt_positions (F, 3), K, blank).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames, dtype=np.float64)
    rate = 0.012 * np.sin(2.0 * np.pi * t / 96.0) * (t > 32)
    frames, scene = _render_drive_u8(
        rng, num_frames, speed, image_size, rate, () if blank is None else (blank,)
    )
    return frames, scene.gt_positions, scene.K, blank


def segment_ate(
    est: np.ndarray,
    gt: np.ndarray,
    resets: np.ndarray,
    warmup: int = 8,
    min_len: int = 24,
):
    """Per-tracked-segment sim3 ATE around reset events.

    After a reset the engine re-initializes its trajectory at the origin,
    so a whole-sequence ATE across a reset is meaningless; each
    continuously tracked segment is sim3-aligned on its own. Returns a
    list of (start, end, ate) for segments at least `min_len` long,
    skipping `warmup` frames after each (re)start.
    """
    from visualodometry_tpu_torch.eval import ate_rmse

    cuts = [0] + [int(i) + 1 for i in np.nonzero(resets)[0]] + [len(est)]
    out = []
    for s, e in zip(cuts[:-1], cuts[1:]):
        s2 = s + warmup
        if e - s2 >= min_len:
            out.append((s, e, float(ate_rmse(est[s2:e], gt[s2:e], align="sim3"))))
    return out


def _rodrigues(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(theta) / theta * W + (1 - np.cos(theta)) / theta**2 * W @ W


def make_pnp_problem(n: int, outliers: float, seed: int, K: np.ndarray = K_DEFAULT):
    """A KITTI-shaped PnP problem for the pose polish (ops/pose_polish.py).

    n world points 4-60 m ahead, seen from a random camera-from-world pose
    with 0.5 px of pixel noise; a share `outliers` of them moved anywhere in
    the 1226x370 frame, a tenth invalid. The start pose is the true one
    moved by ~0.2 degrees and ~2 cm, as a RANSAC winner may be. Returns
    float32 arrays T_true (4, 4), T0 (4, 4), X (n, 3), uv (n, 2) and the
    bool valid (n,).
    """
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n), rng.uniform(4, 60, n)], 1)
    aa, t = rng.normal(0.0, 0.05, 3), rng.normal(0.0, 0.5, 3)
    T_true, T0 = np.eye(4), np.eye(4)
    T_true[:3, :3], T_true[:3, 3] = _rodrigues(aa), t
    p = X @ T_true[:3, :3].T + t
    uv = p[:, :2] / p[:, 2:] * np.diag(K)[:2] + K[:2, 2]
    uv += rng.normal(0.0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform([0.0, 0.0], [1226.0, 370.0], (int(bad.sum()), 2))
    valid = rng.random(n) >= 0.1
    T0[:3, :3] = _rodrigues(aa + rng.normal(0.0, 0.002, 3))
    T0[:3, 3] = t + rng.normal(0.0, 0.01, 3)
    f32 = np.float32
    return T_true.astype(f32), T0.astype(f32), X.astype(f32), uv.astype(f32), valid
