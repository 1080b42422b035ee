"""The port's SIFT against cv2.SIFT on textured imagery, on the CPU.

tests/test_sift_vs_opencv.py's fixture and scoring with the port's
extractor in place of the JAX package's: a ray-cast textured corridor
pair (640x480, seed 3) whose rendered depth gives ground-truth pixel
correspondences, the port's renderer and `gt_correspondence`, and the
same bounds:

- repeatability@3px > 0.5 and >= 0.9 x cv2's;
- ratio-test (0.75, cv2.BFMatcher) precision@4px > 0.9 and >= cv2's -
  0.05, with more than 100 correct;
- more than 200 keypoints a frame.

Measured (scripts/sift_vs_opencv_cpu.py): the port 0.7479 / 0.9915 (232
correct), as the JAX package; cv2 0.6667 / 0.9865 (438 correct).
"""

import cv2
import numpy as np
import pytest
import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.data.synthetic import (
    gt_correspondence,
    make_scene,
    render_textured_image,
)
from visualodometry_tpu_torch.frontend.sift import extract_sift

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def textured_pair():
    rng = np.random.default_rng(3)
    scene = make_scene(rng, num_frames=4, speed=1.0, turn_rate=0.003, image_size=(640, 480))
    img0, depth0 = render_textured_image(scene, 0, with_depth=True)
    img1 = render_textured_image(scene, 1)
    return scene, img0, depth0, img1


@pytest.fixture(scope="module")
def cv2_feats(textured_pair):
    _, img0, _, img1 = textured_pair
    sift = cv2.SIFT_create(nfeatures=1000, contrastThreshold=0.02, edgeThreshold=10, sigma=1.6)
    out = []
    for img in (img0, img1):
        kp, des = sift.detectAndCompute((img * 255).astype(np.uint8), None)
        out.append((np.array([k.pt for k in kp], np.float32), des))
    return out


@pytest.fixture(scope="module")
def our_feats(textured_pair):
    _, img0, _, img1 = textured_pair
    cfg = VOConfig(extractor_type="sift", max_keypoints=1024, sift_n_features=1024,
                   sift_contrast_threshold=0.02)
    out = []
    for img in (img0, img1):
        f = extract_sift(torch.as_tensor(img), cfg, device="cpu")
        v = f.valid.numpy()
        out.append((f.kps.numpy()[v], f.desc.numpy()[v]))
    return out


def _repeatability(scene, depth0, kps_a, kps_b, tol=3.0):
    uvb, ok = gt_correspondence(scene, 0, 1, kps_a, depth0)
    a, b = uvb[ok], kps_b
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1).min(axis=1)
    return float((d < tol).mean())


def _match_precision(scene, depth0, k0, d0, k1, d1, ratio=0.75, tol=4.0):
    bf = cv2.BFMatcher(cv2.NORM_L2, crossCheck=False)
    knn = bf.knnMatch(d0.astype(np.float32), d1.astype(np.float32), k=2)
    pairs = [
        (mn[0].queryIdx, mn[0].trainIdx)
        for mn in knn
        if len(mn) == 2 and mn[0].distance < ratio * mn[1].distance
    ]
    q = np.array([p[0] for p in pairs])
    t = np.array([p[1] for p in pairs])
    uvb, ok = gt_correspondence(scene, 0, 1, k0[q], depth0)
    err = np.linalg.norm(uvb - k1[t], axis=1)
    good = (err < tol) & ok
    return float(good.sum() / max(ok.sum(), 1)), int(good.sum())


class TestTexturedFixture:
    def test_renders_texture_and_depth(self, textured_pair):
        _, img0, depth0, _ = textured_pair
        assert img0.shape == (480, 640)
        assert 0.2 < img0.std() / max(img0.mean(), 1e-6)  # real contrast
        assert 0.4 < np.isfinite(depth0).mean() < 1.0  # surfaces + sky

    def test_gt_correspondence_identity(self, textured_pair):
        scene, _, depth0, _ = textured_pair
        kps = np.array([[100.0, 400.0], [320.0, 460.0], [600.0, 420.0]], np.float32)
        uv, ok = gt_correspondence(scene, 0, 0, kps, depth0)
        np.testing.assert_allclose(uv[ok], kps[ok], atol=0.75)
        assert ok.any()


class TestSiftVsOpenCV:
    def test_finds_enough_keypoints(self, our_feats):
        assert len(our_feats[0][0]) > 200
        assert len(our_feats[1][0]) > 200

    def test_repeatability_at_least_opencv(self, textured_pair, cv2_feats, our_feats):
        scene, _, depth0, _ = textured_pair
        r_cv = _repeatability(scene, depth0, cv2_feats[0][0], cv2_feats[1][0])
        r_our = _repeatability(scene, depth0, our_feats[0][0], our_feats[1][0])
        assert r_our > 0.5
        assert r_our >= 0.9 * r_cv, (r_our, r_cv)

    def test_match_precision_at_least_opencv(self, textured_pair, cv2_feats, our_feats):
        scene, _, depth0, _ = textured_pair
        p_cv, _ = _match_precision(scene, depth0, *cv2_feats[0], *cv2_feats[1])
        p_our, n_our = _match_precision(scene, depth0, *our_feats[0], *our_feats[1])
        assert p_our > 0.9
        assert p_our >= p_cv - 0.05, (p_our, p_cv)
        assert n_our > 100

    def test_host_scoring_equals_the_tests(self, textured_pair, cv2_feats, our_feats):
        """chip_smoke.py scores the card's features with an exact numpy
        nearest-two search (the card has no cv2): on these features it
        must give this test's repeatability and precision."""
        import chip_smoke

        scene, _, depth0, _ = textured_pair
        for (k0, d0), (k1, d1) in (cv2_feats, our_feats):
            assert chip_smoke.repeatability(gt_correspondence, scene, depth0, k0, k1) == \
                _repeatability(scene, depth0, k0, k1)
            assert chip_smoke.match_precision(gt_correspondence, scene, depth0, k0, d0, k1, d1) \
                == _match_precision(scene, depth0, k0, d0, k1, d1)
