"""The port's KLT mode (ops/klt.py, core/klt_step.py) vs the JAX package on
the CPU.

Each sampling path of the port is held against its own JAX path: the
port's "gather" against JAX's "gather", the port's "patch" (K2's plain
version on the CPU) against JAX's "patch_interpret" (its Pallas kernel in
interpret mode). `sampling="auto"` is "gather" on the CPU in both packages
(the port picks "patch" for CUDA tensors, JAX for the TPU backend), so the
KLT step on the CPU runs the gather path on both sides.

Tolerances: positions of jointly tracked slots within 1e-3 px (float32
operation order in the bilinear taps and the hat contractions; measured
~3e-5), tracked sets equal on >= 98% of the slots (a residual at the
0.04 gate can flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as ndshift

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.core.klt_step import init_klt_state as jinit_klt
from visualodometry_tpu.core.klt_step import make_klt_step_fn as jmake_klt
from visualodometry_tpu.data.synthetic import make_scene as jmake_scene
from visualodometry_tpu.data.synthetic import gt_correspondence as jgt_correspondence
from visualodometry_tpu.data.synthetic import render_features as jrender_features
from visualodometry_tpu.data.synthetic import render_image as jrender_image
from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
from visualodometry_tpu.eval import ate_rmse as jate
from visualodometry_tpu.frontend.sift import extract_sift as jextract
from visualodometry_tpu.ops import klt as jklt
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core.klt_step import (
    init_klt_state,
    klt_state_from_numpy,
    make_klt_step_fn,
)
from visualodometry_tpu_torch.data.synthetic import (
    gt_correspondence,
    make_scene,
    render_features,
    render_image,
    render_textured_image,
)
from visualodometry_tpu_torch.eval import ate_rmse
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.frontend.sift import extract_sift
from visualodometry_tpu_torch.ops import klt as tklt

torch.set_num_threads(2)

# the port's sampling path and the JAX path it is held against
PATHS = {"gather": "gather", "patch": "patch_interpret"}


def _texture(rng, H=240, W=320, n=120):
    """Gaussian dots, as tests/test_klt.py draws them."""
    img = np.zeros((H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    pts = np.stack([rng.uniform(15, W - 15, n), rng.uniform(15, H - 15, n)], axis=1)
    for x, y in pts:
        s = rng.uniform(1.5, 3.0)
        a = rng.uniform(0.4, 1.0)
        img = np.maximum(img, a * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s)))
    return img.astype(np.float32), pts


def _phase_shift(img, dx, dy):
    f = np.fft.fft2(img)
    ky = np.fft.fftfreq(img.shape[0])[:, None]
    kx = np.fft.fftfreq(img.shape[1])[None, :]
    return np.real(np.fft.ifft2(f * np.exp(-2j * np.pi * (kx * dx + ky * dy)))).astype(np.float32)


def _both(img0, img1, kps, valid, path, **kw):
    """(JAX (new_kps, tracked), port (new_kps, tracked)) as numpy."""
    nk_j, tr_j = jklt.klt_track(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(kps), jnp.asarray(valid),
        sampling=PATHS[path], **kw,
    )
    nk_t, tr_t = tklt.klt_track(
        torch.as_tensor(img0), torch.as_tensor(img1), torch.as_tensor(kps),
        torch.as_tensor(valid), sampling=path, **kw,
    )
    return (np.asarray(nk_j), np.asarray(tr_j)), (nk_t.numpy(), tr_t.numpy())


def _agree(jax_out, port_out, min_joint):
    (nk_j, tr_j), (nk_t, tr_t) = jax_out, port_out
    assert (tr_j == tr_t).mean() >= 0.98, (tr_j.sum(), tr_t.sum())
    both = tr_j & tr_t
    assert both.sum() >= min_joint
    assert np.abs(nk_j[both] - nk_t[both]).max() < 1e-3
    return both


def _shift_case(rng, case):
    img, pts = _texture(rng)
    if case == "integer":
        dx, dy, kw = 5.0, 3.0, {}
        nxt = np.roll(np.roll(img, 3, 0), 5, 1)
    elif case == "subpixel":
        dx, dy, kw = 2.3, -1.7, {}
        nxt = _phase_shift(img, dx, dy)
    else:  # 14 px needs the pyramid: too far for single-level radius-4 LK
        dx, dy, kw = 14.0, 0.0, {"num_levels": 4}
        nxt = np.roll(img, 14, 1)
    return img, nxt, pts[:64].astype(np.float32), (dx, dy), kw


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", ["integer", "subpixel", "pyramid"])
def test_klt_track_matches_jax(rng, case, path):
    """Shifts of 5/3 px (integer), 2.3/-1.7 px (subpixel, a Fourier phase
    shift) and 14 px over 4 levels: the port agrees with JAX's path, and
    both recover the shift on >= 60% of the slots to a median 0.3 px."""
    img, nxt, kps, (dx, dy), kw = _shift_case(rng, case)
    jax_out, port_out = _both(img, nxt, kps, np.ones(len(kps), bool), path, **kw)
    both = _agree(jax_out, port_out, min_joint=36)
    err = np.abs(port_out[0][both] - (kps[both] + [dx, dy]))
    assert np.median(err) < (0.3 if case == "pyramid" else 0.2)


@pytest.mark.parametrize("path", list(PATHS))
def test_flat_regions_not_tracked(path):
    img = np.zeros((120, 160), np.float32)
    kps = np.array([[40.0, 40.0], [80.0, 60.0]], np.float32)
    (_, tr_j), (_, tr_t) = _both(img, img, kps, np.ones(2, bool), path)
    assert not tr_j.any() and not tr_t.any()


def test_patch_path_matches_gather_in_the_port(rng):
    """The port's two paths on a 3.4/-2.1 px cubic shift (the JAX test's
    case): near-identical tracked sets, positions within 0.05 px."""
    img, pts = _texture(rng)
    nxt = ndshift(img, (-2.1, 3.4), order=3, mode="nearest").astype(np.float32)
    args = (torch.as_tensor(img), torch.as_tensor(nxt), torch.as_tensor(pts[:60].astype(np.float32)),
            torch.ones(60, dtype=torch.bool))
    nk_g, tr_g = (x.numpy() for x in tklt.klt_track(*args, sampling="gather"))
    nk_p, tr_p = (x.numpy() for x in tklt.klt_track(*args, sampling="patch"))
    assert (tr_g == tr_p).mean() > 0.95
    both = tr_g & tr_p
    assert both.sum() >= 40 and np.abs(nk_g[both] - nk_p[both]).max() < 0.05


def test_auto_is_gather_on_the_cpu(rng):
    """`sampling="auto"` on CPU tensors is the gather path, exactly (on
    CUDA tensors it is the patch path: chip_smoke.py counts its K2
    launches)."""
    img, nxt, kps, _, _ = _shift_case(rng, "integer")
    args = (torch.as_tensor(img), torch.as_tensor(nxt), torch.as_tensor(kps),
            torch.ones(len(kps), dtype=torch.bool))
    auto = tklt.klt_track(*args)
    gather = tklt.klt_track(*args, sampling="gather")
    assert all(torch.equal(a, b) for a, b in zip(auto, gather))
    with pytest.raises(ValueError, match="sampling"):
        tklt.klt_track(*args, sampling="patch_interpret")


def test_patch_path_nondivisible_slots(rng):
    """45 slots: padded to 48 inside, 45 returned; agrees with JAX's
    patch path, which pads the same way."""
    img, pts = _texture(rng)
    nxt = np.roll(img, 2, 1)
    kps = pts[:45].astype(np.float32)
    jax_out, port_out = _both(img, nxt, kps, np.ones(45, bool), "patch")
    assert port_out[0].shape == (45, 2) and port_out[1].shape == (45,)
    both = _agree(jax_out, port_out, min_joint=36)
    assert np.median(np.abs(port_out[0][both] - (kps[both] + [2, 0]))) < 0.1


def test_over_drift_shift_gather_tracks_patch_rejects():
    """24 px over 3 levels is 6 px at the coarsest level, above the patch
    path's in-level budget of drift - 1 = 5 px: on a smooth texture the
    gather path still recovers the shift on many slots, the patch path
    recovers it on none, in both packages alike (the documented
    divergence of the two paths at large flows)."""
    rng = np.random.default_rng(42)
    img = gaussian_filter(rng.normal(size=(240, 320)), 8)
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    kps = np.stack([rng.uniform(40, 240, 64), rng.uniform(40, 200, 64)], 1).astype(np.float32)
    nxt = np.roll(img, 24, 1)
    for path, lo, hi in (("gather", 25, 64), ("patch", 0, 0)):
        jax_out, port_out = _both(img, nxt, kps, np.ones(64, bool), path)
        _agree(jax_out, port_out, min_joint=0)
        for nk, tr in (jax_out, port_out):
            right = tr & (np.abs(nk - (kps + [24.0, 0.0])).max(axis=1) < 0.1)
            assert lo <= right.sum() <= hi, (path, right.sum())


def test_building_blocks_match_jax(rng):
    """The pyramid, the K2 field, the hats and both separable samplers."""
    img, _ = _texture(rng, H=90, W=130)
    for a, b in zip(jklt.build_klt_pyramid(jnp.asarray(img), 3),
                    tklt.build_klt_pyramid(torch.as_tensor(img), 3)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    f_j = np.asarray(jklt._patch_field(jnp.asarray(img)))
    f_t = tklt._patch_field(torch.as_tensor(img)).numpy()
    assert f_t.shape == f_j.shape == (1, 96, 256) and np.array_equal(f_t, f_j)
    u = rng.uniform(-2, 20, (7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tklt._hats(torch.as_tensor(u), 16).numpy(),
                                  np.asarray(jklt._hats(jnp.asarray(u), 16)))
    win = rng.random((7, 24, 16)).astype(np.float32)
    ux = rng.uniform(0, 15, (7, 9)).astype(np.float32)
    uy = rng.uniform(0, 23, (7, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tklt._sample_sep(*(torch.as_tensor(x) for x in (win, ux, uy))).numpy(),
        np.asarray(jklt._sample_sep(*(jnp.asarray(x) for x in (win, ux, uy)))), atol=1e-6)
    np.testing.assert_allclose(
        tklt._sample_sep_shared(*(torch.as_tensor(x) for x in (img, ux, uy))).numpy(),
        np.asarray(jklt._sample_sep_shared(*(jnp.asarray(x) for x in (img, ux, uy)))),
        atol=1e-6)


# ---- the KLT step ---------------------------------------------------------

N_SLOTS = 256
IMG = (320, 192)  # (W, H)
FRAMES = 12


def _cfgs():
    jc = JaxConfig(
        extractor_type="sift", max_keypoints=N_SLOTS, sift_n_features=N_SLOTS,
        sift_contrast_threshold=0.015, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=4.0, pnp_reproj_err=2.0, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096, klt_min_parallax_deg=0.6,
    )
    return jc, config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def klt_ref():
    """The JAX KLT step frame by frame over a 12-frame dot-rendered drive
    (tests/test_klt_step.py's recipe cut for the CPU: 320x192, 256 slots,
    128 + 128 hypotheses): its states, SIFT features and outputs."""
    jc, tc = _cfgs()
    scene = jmake_scene(np.random.default_rng(3), num_frames=FRAMES, speed=1.0,
                        turn_rate=0.002, num_landmarks=1000, image_size=IMG)
    imgs = [jrender_image(scene, f, dot_sigma=2.0) for f in range(FRAMES)]
    step = jax.jit(jmake_klt(jc, scene.K, (IMG[1], IMG[0])))
    state = jinit_klt(jc, (IMG[1], IMG[0]))
    states, feats, outs = [state], [], []
    for img in imgs:
        f = jextract(jnp.asarray(img), jc)
        state, out = step(state, jnp.asarray(img), f)
        states.append(state)
        feats.append(jax.tree.map(np.asarray, f))
        outs.append(jax.tree.map(np.asarray, out))
    return dict(scene=scene, imgs=imgs, tc=tc, states=states, feats=feats, outs=outs)


def test_synthetic_renderers_match_jax():
    """The port's copies of render_image, render_features and
    gt_correspondence give the JAX renderer's pixels, features and
    correspondences on the same scene and seeds."""
    args = dict(num_frames=3, speed=0.6, num_landmarks=900, image_size=(320, 180))
    s_t = make_scene(np.random.default_rng(3), **args)
    s_j = jmake_scene(np.random.default_rng(3), **args)
    for kw in ({"dot_sigma": 2.0}, {"subdots": 3}):
        np.testing.assert_array_equal(render_image(s_t, 1, **kw), jrender_image(s_j, 1, **kw))
    f_t = render_features(s_t, 2, 256, np.random.default_rng(5), outlier_frac=0.1, device="cpu")
    f_j = jrender_features(s_j, 2, 256, np.random.default_rng(5), outlier_frac=0.1)
    assert int(f_t.valid.sum()) > 100
    for a, b in zip(f_t, f_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    _, depth = render_textured_image(s_t, 0, with_depth=True)
    kps = np.stack([np.linspace(5, 315, 64), np.linspace(5, 175, 64)], 1).astype(np.float32)
    for a, b in zip(gt_correspondence(s_t, 0, 2, kps, depth),
                    jgt_correspondence(s_j, 0, 2, kps, depth)):
        np.testing.assert_array_equal(a, b)


def test_klt_step_tracks_like_jax(klt_ref):
    """The port's own run (its SIFT, its torch.Generator draws): the same
    initialisation frame and no reset; tracked slots per frame within 10%
    of JAX's; promoted landmarks in total within 25%; sim3 ATE from the
    initialisation on within 0.1 m of the JAX run's (0.27 m over 11 m;
    the draws differ, and with them every landmark)."""
    scene, tc = klt_ref["scene"], klt_ref["tc"]
    step = make_klt_step_fn(tc, scene.K, (IMG[1], IMG[0]), device="cpu")
    state = init_klt_state(tc, (IMG[1], IMG[0]), device="cpu")
    outs = []
    for img in klt_ref["imgs"]:
        img = torch.as_tensor(img)
        state, out = step(state, img, extract_sift(img, tc, device="cpu"))
        outs.append(out)
    outs_j = klt_ref["outs"]
    init_t = [bool(o.initialized) for o in outs]
    init_j = [bool(o.initialized) for o in outs_j]
    assert init_t == init_j and init_j.index(True) <= 3
    assert not any(bool(o.did_reset) for o in outs + outs_j)
    tr_t = np.array([int(o.num_tracked) for o in outs])
    tr_j = np.array([int(o.num_tracked) for o in outs_j])
    assert tr_j[1:].min() > 50 and (np.abs(tr_t - tr_j) <= 0.1 * tr_j).all(), (tr_t, tr_j)
    prom_t = sum(int(o.num_promoted) for o in outs)
    prom_j = sum(int(o.num_promoted) for o in outs_j)
    assert prom_j > 150 and abs(prom_t - prom_j) <= 0.25 * prom_j, (prom_t, prom_j)
    assert int(state.map.next_id) == prom_t
    i0 = init_j.index(True)
    gt = scene.gt_positions[i0:]
    ate_t = ate_rmse(np.stack([o.T_wc[:3, 3].numpy() for o in outs])[i0:], gt, align="sim3")
    ate_j = jate(np.stack([o.T_wc[:3, 3] for o in outs_j])[i0:], gt, align="sim3")
    assert ate_j < 0.5 and abs(ate_t - ate_j) <= 0.1, (ate_t, ate_j)


def test_klt_step_from_carried_state_on_jax_draws(klt_ref):
    """Frames 6-8 stepped by the port from the JAX state after frame 5, on
    the JAX features and the JAX engine's own RANSAC draws: tracked,
    landmark and promoted counts equal, and the pose within 1e-3 (float32
    operation order through KLT, PnP and its refinement)."""
    key = klt_ref["states"][6].rng_key
    state_j = jax.tree.map(np.asarray, klt_ref["states"][6]._replace(rng_key=None))
    assert bool(state_j.initialized)
    draws = {}

    def sampler(valid, num_hypotheses, sample_size):
        k = draws["ess"] if sample_size == 5 else draws["pnp"]
        return torch.as_tensor(np.array(
            jsample(k, jnp.asarray(valid.numpy()), num_hypotheses, sample_size))).long()

    scene, tc = klt_ref["scene"], klt_ref["tc"]
    step = make_klt_step_fn(tc, scene.K, (IMG[1], IMG[0]), device="cpu", sampler=sampler)
    state = klt_state_from_numpy(state_j, device="cpu")
    for frame in (6, 7, 8):
        key, draws["ess"], draws["pnp"] = jax.random.split(key, 3)
        f = klt_ref["feats"][frame]
        state, out = step(state, torch.as_tensor(klt_ref["imgs"][frame]),
                          Features(*(torch.as_tensor(np.array(x)) for x in f)))
        o_j = klt_ref["outs"][frame]
        for name in ("num_tracked", "num_landmarks", "num_promoted", "did_reset"):
            assert int(getattr(out, name)) == int(getattr(o_j, name)), (frame, name)
        np.testing.assert_allclose(out.T_wc.numpy(), o_j.T_wc, atol=1e-3)
    np.testing.assert_array_equal(state.ids.numpy(), np.asarray(klt_ref["states"][9].ids))


def test_klt_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the entry points would run")
    _, tc = _cfgs()
    K = np.eye(3, dtype=np.float32)
    for call in (
        lambda: init_klt_state(tc, (IMG[1], IMG[0])),
        lambda: make_klt_step_fn(tc, K, (IMG[1], IMG[0])),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
