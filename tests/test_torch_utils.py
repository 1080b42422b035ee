"""The port's host utilities against the JAX package's, on the CPU.

- `run_reference_pipeline` (the OpenCV re-execution of the reference
  loop) on 8 rendered frames: positions and stats other than fps equal,
  with cv2's RNG seeded the same before each run and cv2 on one thread.
- `calibrate_charuco` on the rendered board views of
  tests/test_calibrate.py, cv2 on one thread: the same K, error and view
  count.
- `video_to_frames` on a short video written with cv2.VideoWriter: the
  same frame count and frames.
- `StageTimer`'s summary.
"""

import contextlib
import dataclasses
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from visualodometry_tpu.config import VOConfig as JaxConfig  # noqa: E402
from visualodometry_tpu.eval.reference_cv2 import run_reference_pipeline as jref  # noqa: E402
from visualodometry_tpu.utils.calibrate_camera import calibrate_charuco as jcalib  # noqa: E402
from visualodometry_tpu.utils.calibrate_camera import generate_board_image  # noqa: E402
from visualodometry_tpu.utils.video2frame import video_to_frames as jvideo  # noqa: E402
from visualodometry_tpu_torch.config import config_from_dict  # noqa: E402
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8  # noqa: E402
from visualodometry_tpu_torch.eval.reference_cv2 import run_reference_pipeline  # noqa: E402
from visualodometry_tpu_torch.utils import calibrate_camera, profiling, video2frame  # noqa: E402


@contextlib.contextmanager
def _one_cv2_thread():
    """cv2 sums in threads, in an order that can vary from call to call
    (calibrateCamera's K moves by up to ~2e-9 relative): one thread makes
    two calls of the same code repeat."""
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        yield
    finally:
        cv2.setNumThreads(threads)


def test_reference_pipeline_equals_jax():
    scene = make_scene(np.random.default_rng(7), num_frames=8, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=(640, 192))
    u8 = render_fixture_u8(scene)
    jc = JaxConfig(extractor_type="sift", max_keypoints=512, sift_n_features=512,
                   sift_contrast_threshold=0.02, min_median_flow=3.0, max_reproj_err=2.0,
                   pnp_reproj_err=2.0, min_depth=1.0, lowe_ratio=0.75, global_scale=1.2)
    K = np.asarray(scene.K, np.float64)
    with _one_cv2_thread():
        cv2.setRNGSeed(0)
        pos, stats = run_reference_pipeline(u8, K, config_from_dict(dataclasses.asdict(jc)))
        cv2.setRNGSeed(0)
        pos_j, stats_j = jref(u8, K, jc)
    np.testing.assert_array_equal(pos, pos_j)
    stats.pop("fps"), stats_j.pop("fps")
    assert stats == stats_j
    assert stats["keyframes"] >= 1 and np.abs(pos[-1]).sum() > 0  # the loop tracked


def _board_views(tmp_path):
    """tests/test_calibrate.py's eight warped views of an 8 x 6 board."""
    board_path = tmp_path / "board.png"
    generate_board_image(board_path, squares_x=8, squares_y=6)
    flat = cv2.imread(str(board_path), cv2.IMREAD_GRAYSCALE)
    H0, W0 = flat.shape
    W, H = 640, 480
    K_true = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]])
    m_per_px = 0.025 / (W0 / 8.5)
    img_dir = tmp_path / "views"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        rvec = rng.uniform(-0.35, 0.35, 3)
        tvec = np.array([rng.uniform(-0.04, 0.04), rng.uniform(-0.03, 0.03),
                         rng.uniform(0.28, 0.42)])
        corners_px = np.array([[0, 0], [W0, 0], [W0, H0], [0, H0]], np.float64)
        plane = np.concatenate([(corners_px - [W0 / 2, H0 / 2]) * m_per_px,
                                np.zeros((4, 1))], axis=1)
        proj, _ = cv2.projectPoints(plane, rvec, tvec, K_true, None)
        Hmat, _ = cv2.findHomography(corners_px.astype(np.float32),
                                     proj.reshape(-1, 2).astype(np.float32))
        view = cv2.warpPerspective(flat, Hmat, (W, H), borderValue=180, flags=cv2.INTER_LINEAR)
        cv2.imwrite(str(img_dir / f"view_{i:02d}.png"), view)
    return img_dir


def test_calibration_equals_jax(tmp_path):
    img_dir = _board_views(tmp_path)
    kw = dict(squares_x=8, squares_y=6, square_len=0.025, marker_len=0.018, verbose=False)
    with _one_cv2_thread():
        K, err, n = calibrate_camera.calibrate_charuco(img_dir, **kw)
        K_j, err_j, n_j = jcalib(img_dir, **kw)
    np.testing.assert_array_equal(K, K_j)
    assert err == err_j and n == n_j >= 6
    np.testing.assert_allclose(K[0, 0], 600.0, rtol=0.05)  # and it is the camera's


def test_video_to_frames_equals_jax(tmp_path):
    video = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    assert writer.isOpened()
    rng = np.random.default_rng(1)
    for _ in range(9):
        writer.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    writer.release()
    assert video2frame.find_video(tmp_path) == video
    n = video2frame.video_to_frames(video, tmp_path / "port", stride=2)
    n_j = jvideo(video, tmp_path / "jax", stride=2)
    assert n == n_j == 5
    for i in range(n):
        a = cv2.imread(str(tmp_path / "port" / f"img_{i:05d}.jpg"))
        b = cv2.imread(str(tmp_path / "jax" / f"img_{i:05d}.jpg"))
        np.testing.assert_array_equal(a, b)


def test_stage_timer_summary():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("decode"):
            time.sleep(0.002)
    with t.stage("step"):
        pass
    s = t.summary()
    assert set(s) == {"decode", "step"}
    assert s["decode"]["count"] == 3 and s["step"]["count"] == 1
    assert s["decode"]["total_s"] >= 0.006 and s["decode"]["mean_ms"] >= 2.0
