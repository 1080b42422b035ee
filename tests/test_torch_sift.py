"""Port pyramid + SIFT extractor vs the JAX reference on the CPU.

The pyramid is the same band matmuls in float32 (JAX's Precision.HIGH is
exact float32 on the CPU); the summation order differs, so Gaussian
levels agree to ~1e-6 and a marginal DoG extremum can flip. Keypoint
sets are therefore held by overlap (a JAX keypoint is found if a port
keypoint lies within 0.05 px) and descriptors on the shared keypoints,
not bitwise. Within the port, the patch path (K2's plain version on the
CPU) must reproduce the gather path exactly, as in the JAX package.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.data.synthetic import make_scene, render_textured_image
from visualodometry_tpu.frontend import sift as jsift
from visualodometry_tpu.ops.pyramid import build_pyramid as jpyramid
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.frontend import sift as tsift
from visualodometry_tpu_torch.ops.pyramid import build_pyramid as tpyramid

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    scene = make_scene(
        np.random.default_rng(7), num_frames=2, speed=1.2, turn_rate=0.002,
        num_landmarks=2, image_size=(320, 192),
    )
    imgs = np.stack([render_textured_image(scene, f) for f in range(2)])
    return (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)


def _cfgs(**kw):
    jc = JaxConfig(
        extractor_type="sift", max_keypoints=512, sift_n_features=512,
        sift_contrast_threshold=0.02, sift_num_octaves=3, **kw,
    )
    return jc, config_from_dict(dataclasses.asdict(jc))


def test_pyramid_matches_jax(frames):
    img = frames[0].astype(np.float32) / 255.0
    g_j, d_j = jpyramid(jnp.asarray(img), 3, 3, sigma0=1.6)
    g_t, d_t = tpyramid(torch.as_tensor(img), 3, 3, sigma0=1.6)
    for a, b in zip(g_t + d_t, g_j + d_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, rtol=0)


def test_pyramid_batch_axis(frames):
    imgs = torch.as_tensor(frames.astype(np.float32) / 255.0)
    g_b, d_b = tpyramid(imgs, 2, 3)
    g_1, d_1 = tpyramid(imgs[1], 2, 3)
    for a, b in zip(g_b + d_b, g_1 + d_1):
        np.testing.assert_allclose(a[1].numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{"first_octave": -1}, {"impl": "pallas"}])
def test_unported_pyramid_options_raise(kw):
    """Both options are ported now (tests/test_torch_pyramid.py holds them
    against JAX): they return a pyramid, and what raises is a value that
    neither package knows."""
    gauss, dogs = tpyramid(torch.zeros(32, 32), 1, 3, **kw)
    side = 64 if kw.get("first_octave") == -1 else 32
    assert tuple(gauss[0].shape) == (6, side, side) and tuple(dogs[0].shape) == (5, side, side)
    bad = {"first_octave": -2} if "first_octave" in kw else {"impl": "conv"}
    with pytest.raises(ValueError):
        tpyramid(torch.zeros(32, 32), 1, 3, **bad)


def _overlap(f_j, f_t):
    """Fraction of JAX keypoints the port finds (a port keypoint within 0.05
    px), and the descriptor dot products on those: the best over the port
    keypoints found there (with two orientation peaks, a position carries
    two slots, one for each orientation)."""
    kj = np.asarray(f_j.kps)[np.asarray(f_j.valid)]
    dj = np.asarray(f_j.desc)[np.asarray(f_j.valid)]
    vt = f_t.valid.numpy()
    kt, dt = f_t.kps.numpy()[vt], f_t.desc.numpy()[vt]
    near = np.linalg.norm(kj[:, None] - kt[None], axis=-1) < 0.05
    found = near.any(axis=1)
    dots = np.where(near, dj @ dt.T, -np.inf).max(axis=1)[found]
    return found.mean(), dots, len(kj), len(kt)


# Bounds, just outside what was measured at these shapes (320 x 192, 512
# slots, both frames, both sampling modes, one and two orientation peaks):
# equal counts (138 and 137 keypoints with one peak, 161 and 158 with
# two), every JAX keypoint found, every shared descriptor's dot >= 0.99984.
# Two marginal DoG extrema may flip on another CPU's float order; a port
# that drops 4% of its keypoints (5 of 138) fails the count and the overlap.
MAX_COUNT_GAP = 2
MIN_OVERLAP = 0.985
MIN_DOT = 0.999


def _hold_extraction(frames, mode, peaks):
    jc, tc = _cfgs(sift_sampling=mode, sift_orientation_peaks=peaks)
    f_j = jax.tree.map(np.asarray, jsift.extract_sift(jnp.asarray(frames[0]), jc))
    f_t = tsift.extract_sift(torch.as_tensor(frames[0]), tc, device="cpu")
    frac, dots, n_j, n_t = _overlap(f_j, f_t)
    assert n_j > 100 and abs(n_j - n_t) <= MAX_COUNT_GAP, (n_j, n_t)
    assert frac >= MIN_OVERLAP, frac
    # a flipped orientation bin changes a descriptor wholesale
    assert dots.min() >= MIN_DOT, dots.min()
    return n_j


@pytest.mark.parametrize("mode", ["gather", "patch"])
def test_extraction_matches_jax(frames, mode):
    """mode="patch" runs the JAX K2 kernel in interpret mode (sift.py:826)
    and the port's K2 plain version."""
    _hold_extraction(frames, mode, peaks=1)


@pytest.mark.parametrize("mode", ["gather", "patch"])
def test_extraction_matches_jax_two_peaks(frames, mode):
    """sift_orientation_peaks=2 (the long-corridor configuration): each
    octave's keypoint budget halves, and a keypoint whose histogram has a
    second peak within 80% of the first fills a second slot with that
    orientation. More keypoints than with one peak, on the same budget."""
    n_two = _hold_extraction(frames, mode, peaks=2)
    _, tc = _cfgs(sift_sampling=mode)
    one = int(tsift.extract_sift(torch.as_tensor(frames[0]), tc, device="cpu").valid.sum())
    assert n_two > one


def test_patch_path_equals_gather_path(frames):
    _, tg = _cfgs(sift_sampling="gather")
    _, tpatch = _cfgs(sift_sampling="patch")
    img = torch.as_tensor(frames[1])
    f_g = tsift.extract_sift(img, tg, device="cpu")
    f_p = tsift.extract_sift(img, tpatch, device="cpu")
    v = f_g.valid
    assert bool(v.any())
    assert torch.equal(v, f_p.valid)
    assert torch.equal(f_g.kps, f_p.kps)
    torch.testing.assert_close(f_p.desc[v], f_g.desc[v], rtol=0, atol=1e-6)


def test_patch_path_equals_gather_path_two_peaks(frames):
    _, tg = _cfgs(sift_sampling="gather", sift_orientation_peaks=2)
    _, tpatch = _cfgs(sift_sampling="patch", sift_orientation_peaks=2)
    img = torch.as_tensor(frames[1])
    f_g = tsift.extract_sift(img, tg, device="cpu")
    f_p = tsift.extract_sift(img, tpatch, device="cpu")
    v = f_g.valid
    assert torch.equal(v, f_p.valid) and torch.equal(f_g.kps, f_p.kps)
    torch.testing.assert_close(f_p.desc[v], f_g.desc[v], rtol=0, atol=1e-6)


def test_batched_extract_equals_single(frames):
    _, tc = _cfgs()
    batch = tsift.make_batched_extract_fn(tc, device="cpu")(torch.as_tensor(frames))
    assert len(batch) == 2
    single = tsift.extract_sift(torch.as_tensor(frames[1]), tc, device="cpu")
    assert torch.equal(batch[1].valid, single.valid)
    v = single.valid
    torch.testing.assert_close(batch[1].kps[v], single.kps[v], rtol=0, atol=1e-4)


def test_cuda_entry_point_raises_without_cuda(frames):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the entry point would run")
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.extract_sift(torch.as_tensor(frames[0]), tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.make_batched_extract_fn(tc)
