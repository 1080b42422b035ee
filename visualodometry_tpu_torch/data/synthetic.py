"""Synthetic drive and textured-corridor renderer (pure numpy).

The port's own copy of the parts of visualodometry_tpu/data/synthetic.py
that render the bench fixture: `make_scene` (a KITTI-like forward drive)
and `render_textured_image` with the value-noise texture (a ray-cast
corridor: ground plane and two side walls). Same code, same seeds, so the
frames are the same as the JAX package's. Also its long fixtures
(`make_marathon_fixture`, `make_long_corridor_fixture`: S-curves and
blackout windows that force resets) and `segment_ate`, their metric.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def render_textured_image(
    scene: SyntheticScene,
    frame: int,
    with_depth: bool = False,
    ground_y: float = 2.0,
    wall_x: float = 14.0,
    texture: str = "noise",
):
    """Ray-cast a textured corridor world (ground plane + two side walls).

    Multi-octave value noise on real 3D surfaces under true perspective.
    Returns (H, W) float32 in [0, 1]; with `with_depth`, also the (H, W)
    float32 depth (camera z; inf for sky). Only `texture="noise"` is
    ported.
    """
    if texture != "noise":
        raise NotImplementedError("render_textured_image: only texture='noise'")
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

    def shade(t, valid, texture_uv, seed, shade_scale):
        hit = valid & (t > 0.5) & (t < best_t)
        if not hit.any():
            return
        tex = _value_noise(texture_uv[0][hit], texture_uv[1][hit], seed)
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
