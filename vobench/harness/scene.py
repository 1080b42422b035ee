"""The corridor renderer: a frozen copy of the port's textured-drive code.

Copied from visualodometry_tpu_torch/data/synthetic.py (`_yaw_T_wc`,
`make_scene`, `_value_noise`, `render_textured_image` with the value-noise
texture, and the uint8 rounding of `render_fixture_u8`), so that later
changes to the program cannot change the benchmark's frames. One change:
the three texture seeds (ground, left wall, right wall), fixed at 101, 202
and 303 in the source, are arguments, so that a traffic seed can change
the frames; with those defaults the frames are the source's, bit for bit
(vobench/tests/test_vobench_copies.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

K_DEFAULT = np.array(
    [[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]],
    dtype=np.float32,
)
TEXTURE_SEEDS = (101, 202, 303)


@dataclass
class Scene:
    K: np.ndarray  # (3, 3)
    image_size: tuple[int, int]  # (W, H)
    poses_T_wc: np.ndarray  # (F, 4, 4) ground-truth world-from-camera

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
    depth_range: tuple[float, float] = (5.0, 60.0),
    lateral_range: float = 25.0,
) -> Scene:
    """KITTI-like forward drive with a gentle constant-rate curve.

    The source also draws point landmarks and their descriptors from
    `rng`; the textured frames do not read them, but they are drawn here
    too, so that `rng` is left as the source leaves it.
    """
    if image_size == (1226, 370):
        K = K_DEFAULT
    else:
        # the KITTI camera scaled to the viewport: same field of view,
        # principal point at the image center
        W, H = image_size
        f = 718.856 / 1226.0 * W
        K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]], dtype=np.float32)
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for _ in range(num_frames):
        poses.append(_yaw_T_wc(pos.copy(), yaw))
        heading = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + speed * heading
        yaw += turn_rate * speed
    poses = np.stack(poses)
    rng.integers(0, num_frames, num_landmarks)
    rng.uniform(-lateral_range, lateral_range, num_landmarks)
    rng.uniform(-4, 3, num_landmarks)
    rng.uniform(*depth_range, num_landmarks)
    rng.normal(size=(num_landmarks, desc_dim))
    return Scene(K=K.astype(np.float32), image_size=image_size,
                 poses_T_wc=poses.astype(np.float32))


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
    scene: Scene,
    frame: int,
    ground_y: float = 2.0,
    wall_x: float = 14.0,
    texture_seeds: tuple[int, int, int] = TEXTURE_SEEDS,
) -> np.ndarray:
    """Ray-cast the value-noise corridor (ground plane + two side walls):
    (H, W) float32 in [0, 1]."""
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
    best_t = np.full((H, W), np.inf, np.float32)

    def shade(t, valid, texture_uv, seed, shade_scale):
        hit = valid & (t > 0.5) & (t < best_t)
        if not hit.any():
            return
        tex = _value_noise(texture_uv[0][hit], texture_uv[1][hit], seed)
        img[hit] = (0.15 + 0.8 * tex) * shade_scale
        best_t[hit] = t[hit]

    ground, left, right = texture_seeds
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (ground_y - origin[1]) / d_w[..., 1]
        pg = origin + tg[..., None] * d_w
        shade(tg, d_w[..., 1] > 1e-6, (pg[..., 0], pg[..., 2]), ground, 1.0)
        for sx, seed in ((-wall_x, left), (wall_x, right)):
            tw = (sx - origin[0]) / d_w[..., 0]
            pw = origin + tw[..., None] * d_w
            wall_valid = np.abs(d_w[..., 0]) > 1e-6
            wall_valid &= pw[..., 1] > -6.0
            shade(tw, wall_valid, (pw[..., 2], pw[..., 1]), seed, 0.9)
    return img


def to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image as uint8, rounded as the bench fixture is."""
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
