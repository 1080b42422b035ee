#!/usr/bin/env python3
"""OpenCV's SIFT on tests/test_sift_vs_opencv.py's pair, on the CPU: the bars
of chip_smoke.py's OpenCV phase (the card's machine has no cv2).

The pair (640 x 480, scene seed 3, frames 0 and 1, float images, frame 0's
depth for the ground-truth correspondences) is rendered by the JAX
package's renderer; cv2.SIFT_create with the test's settings, the JAX
package's extractor and the port's (on the CPU, `sift_sampling="auto"`,
the gather path there) are scored as the test scores them: repeatability
at 3 px, and the precision at 4 px of Lowe-ratio (0.75) matches, once with
OpenCV's brute-force matcher (the test's) and once with chip_smoke.py's
exact nearest-two search on the host (the card's stand-in for it).

Prints one JSON line: the pair's float32 CRC32s, and per extractor its
keypoint counts and the scores.

    JAX_PLATFORMS=cpu python scripts/sift_vs_opencv_cpu.py
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bf_matches(d0, d1, ratio=0.75):
    """tests/test_sift_vs_opencv.py's matcher: cv2.BFMatcher kNN, k = 2."""
    import cv2

    knn = cv2.BFMatcher(cv2.NORM_L2, crossCheck=False).knnMatch(
        d0.astype(np.float32), d1.astype(np.float32), k=2)
    pairs = [(m[0].queryIdx, m[0].trainIdx) for m in knn
             if len(m) == 2 and m[0].distance < ratio * m[1].distance]
    return np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])


def main() -> int:
    import cv2
    import jax.numpy as jnp
    import torch

    from chip_smoke import (SIFT_PAIR_CFG, SIFT_PAIR_SIZE, match_precision, ratio_matches,
                            repeatability)
    from visualodometry_tpu.config import VOConfig
    from visualodometry_tpu.data.synthetic import (gt_correspondence, make_scene,
                                                   render_textured_image)
    from visualodometry_tpu.frontend.sift import extract_sift as jax_extract
    from visualodometry_tpu_torch.config import config_from_dict
    from visualodometry_tpu_torch.frontend.sift import extract_sift as port_extract

    scene = make_scene(np.random.default_rng(3), num_frames=4, speed=1.0, turn_rate=0.003,
                       image_size=SIFT_PAIR_SIZE)
    img0, depth0 = render_textured_image(scene, 0, with_depth=True)
    img1 = render_textured_image(scene, 1)
    line = {
        "pair_crc32": zlib.crc32(np.ascontiguousarray(np.stack([img0, img1]).astype(np.float32))
                                 .tobytes()),
        "depth_crc32": zlib.crc32(np.ascontiguousarray(depth0.astype(np.float32)).tobytes()),
        "cv2_version": cv2.__version__,
    }
    sift = cv2.SIFT_create(nfeatures=1000, contrastThreshold=0.02, edgeThreshold=10, sigma=1.6)
    feats = {"cv2": []}
    for img in (img0, img1):
        kp, des = sift.detectAndCompute((img * 255).astype(np.uint8), None)
        feats["cv2"].append((np.array([k.pt for k in kp], np.float32), des))
    jcfg = VOConfig(**SIFT_PAIR_CFG)
    feats["jax"] = []
    feats["port_cpu"] = []
    for img in (img0, img1):
        f = jax_extract(jnp.asarray(img), jcfg)
        v = np.asarray(f.valid)
        feats["jax"].append((np.asarray(f.kps)[v], np.asarray(f.desc)[v]))
        f = port_extract(torch.as_tensor(img), config_from_dict(SIFT_PAIR_CFG), device="cpu")
        v = f.valid.numpy()
        feats["port_cpu"].append((f.kps.numpy()[v], f.desc.numpy()[v]))
    for name, ((k0, d0), (k1, d1)) in feats.items():
        p_bf, n_bf = match_precision(gt_correspondence, scene, depth0, k0, d0, k1, d1,
                                     matches=bf_matches)
        p_np, n_np = match_precision(gt_correspondence, scene, depth0, k0, d0, k1, d1,
                                     matches=ratio_matches)
        line[name] = dict(
            keypoints=[len(k0), len(k1)],
            repeatability=repeatability(gt_correspondence, scene, depth0, k0, k1),
            precision_bfmatcher=p_bf, correct_bfmatcher=n_bf,
            precision_exact_knn=p_np, correct_exact_knn=n_np,
        )
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
