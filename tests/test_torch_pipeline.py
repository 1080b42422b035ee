"""The port's slice as a whole vs the JAX engine on the CPU.

One module-scoped JAX run of the chunked SIFT pipeline over a small
textured-corridor fixture (640x192, 512 slots, 128 + 128 hypotheses, 12
frames in chunks of 4) supplies the reference: its per-chunk states, the
features it extracted and its per-frame outputs.

- A JAX state carried into the port by `state_from_numpy`, stepped on the
  JAX features with the JAX engine's own RANSAC draws, gives the same
  pose (1e-4: float32 operation order through match, PnP and IRLS).
- The port's own run (its own extractor and torch.Generator draws) tracks
  like the JAX run: same resets and init frame, keyframe flags equal on
  all but at most one frame, sim3 ATE within 0.01 m of the JAX run's
  (the samples differ, so poses differ at the millimetre level).
- The KITTI-gates path (`get_config("kitti", "sift")`: P3P, strict gates,
  the upsampled -1 octave) on a short marathon-recipe fixture with one
  blackout window: the port, with either pyramid route, resets and
  re-initializes on the frames the JAX engine does.
- `VOEngine` steps frame by frame, clears its trajectory on a reset, and
  resumes from a checkpoint bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.config import get_config as jget_config
from visualodometry_tpu.core import init_state as jinit
from visualodometry_tpu.core.runner import make_chunked_pipeline_fn as jpipeline
from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
from visualodometry_tpu.eval import ate_rmse as jate
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core import (
    VOEngine,
    init_state,
    load_state,
    make_chunked_pipeline_fn,
    make_step_fn,
    save_state,
    state_from_numpy,
    state_to_numpy,
)
from visualodometry_tpu_torch.data.synthetic import (
    make_marathon_fixture,
    make_scene,
    render_fixture_u8,
    segment_ate,
)
from visualodometry_tpu_torch.eval import ate_rmse
from visualodometry_tpu_torch.frontend.interface import Features

torch.set_num_threads(2)

SIZE = (640, 192)
CHUNK = 4
FRAMES = 12


def _cfgs():
    jc = JaxConfig(
        extractor_type="sift", max_keypoints=512, sift_n_features=512,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0,
        min_parallax_deg=0.35, lowe_ratio=0.8, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096,
    )
    return jc, config_from_dict(dataclasses.asdict(jc))


def _np_state(state):
    return jax.tree.map(np.asarray, state._replace(rng_key=None))


@pytest.fixture(scope="module")
def ref():
    scene = make_scene(
        np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
        turn_rate=0.002, num_landmarks=2, image_size=SIZE,
    )
    u8 = render_fixture_u8(scene)
    jc, tc = _cfgs()
    vextract, scan_step = jpipeline(jc, scene.K).jitted_programs
    state = jinit(jc, desc_dim=128)
    states, feats, outs = [state], [], []
    for i in range(0, FRAMES, CHUNK):
        f = vextract(jnp.asarray(u8[i : i + CHUNK]))
        state, out = scan_step(state, f)
        states.append(state)
        feats.append(jax.tree.map(np.asarray, f))
        outs.append(jax.tree.map(np.asarray, out))
    out = jax.tree.map(lambda *xs: np.concatenate(xs), *outs)
    return dict(scene=scene, u8=u8, jc=jc, tc=tc, states=states, feats=feats, out=out)


def test_state_roundtrip(ref):
    d = _np_state(ref["states"][1])
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for name in ("frame_id", "initialized", "T_wc", "last_pos", "baseline_speed"):
        np.testing.assert_array_equal(back[name], getattr(d, name))
    for name in ("kps", "desc", "kp_valid", "ids", "T_wc"):
        np.testing.assert_array_equal(back["keyframe"][name], getattr(d.keyframe, name))
    for name in ("points", "ids", "next_id"):
        np.testing.assert_array_equal(back["map"][name], getattr(d.map, name))


def test_tracking_step_from_carried_state(ref):
    """Frames 4-7 stepped by the port from the JAX state after frame 3."""
    state_j = ref["states"][1]
    assert bool(state_j.initialized), "fixture must be tracking by frame 3"
    key = state_j.rng_key
    draws = {}

    def sampler(valid, num_hypotheses, sample_size):
        k = draws["ess"] if sample_size == 5 else draws["pnp"]
        idx = jsample(k, jnp.asarray(valid.numpy()), num_hypotheses, sample_size)
        return torch.as_tensor(np.array(idx)).long()

    step = make_step_fn(ref["tc"], ref["scene"].K, device="cpu", sampler=sampler)
    state = state_from_numpy(_np_state(state_j), device="cpu")
    f = ref["feats"][1]
    out_j = ref["out"]
    for j in range(CHUNK):
        key, draws["ess"], draws["pnp"] = jax.random.split(key, 3)
        feats = Features(*(torch.as_tensor(np.array(x[j])) for x in (f.kps, f.desc, f.valid)))
        state, out = step(state, feats)
        frame = CHUNK + j
        assert bool(out.did_reset) == bool(out_j.did_reset[frame])
        assert bool(out.is_keyframe) == bool(out_j.is_keyframe[frame])
        tol = 1e-4 if j == 0 else 1e-3  # later frames inherit earlier round-off
        np.testing.assert_allclose(out.T_wc.numpy(), out_j.T_wc[frame], atol=tol)


def test_slice_tracks_like_jax(ref):
    run = make_chunked_pipeline_fn(ref["tc"], ref["scene"].K, device="cpu")
    state = init_state(ref["tc"], desc_dim=128, device="cpu")
    outs = []
    for i in range(0, FRAMES, CHUNK):
        state, out = run(state, ref["u8"][i : i + CHUNK])
        outs.append(out)
    T = torch.cat([o.T_wc for o in outs]).numpy()
    kf = torch.cat([o.is_keyframe for o in outs]).numpy()
    resets = torch.cat([o.did_reset for o in outs]).numpy()
    init = torch.cat([o.initialized for o in outs]).numpy()
    out_j = ref["out"]
    gt = ref["scene"].gt_positions
    assert T.shape == (FRAMES, 4, 4) and np.isfinite(T).all()
    assert resets.sum() == out_j.did_reset.sum() == 0
    assert np.argmax(init) == np.argmax(out_j.initialized)
    assert (kf != out_j.is_keyframe).sum() <= 1
    ate_t = ate_rmse(T[8:, :3, 3], gt[8:], align="sim3")
    ate_j = jate(out_j.T_wc[8:, :3, 3], gt[8:], align="sim3")
    assert ate_j < 0.05 and abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)


# ---- the KITTI-gates path -------------------------------------------------

GATES_SIZE = (400, 120)
GATES_FRAMES = 32
GATES_BLANK = (12, 14)


@pytest.fixture(scope="module")
def gates():
    """The JAX engine at the KITTI gate set on a 32-frame marathon-recipe
    drive (speed 2.4, one blackout window). The gates are the config's own
    except `min_median_flow`, which is in pixels and so is scaled by the
    width ratio 400 / 1226; slots, hypotheses and map are cut for the CPU."""
    u8, gt, K, _ = make_marathon_fixture(
        num_frames=GATES_FRAMES, image_size=GATES_SIZE, blanks=(GATES_BLANK,)
    )
    jc = jget_config("kitti", extractor="sift").replace(
        sift_edge_threshold=10.0, global_scale=2.4, sift_first_octave=-1,
        sift_n_features=512, max_keypoints=512, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096,
        min_median_flow=40.0 * GATES_SIZE[0] / 1226.0,
    )
    assert jc.pnp_solver == "p3p" and jc.pnp_reproj_err == 1.0
    run = jpipeline(jc, K)
    state = jinit(jc, desc_dim=128)
    outs = []
    for i in range(0, GATES_FRAMES, CHUNK):
        state, out = run(state, jnp.asarray(u8[i : i + CHUNK]))
        outs.append(jax.tree.map(np.asarray, out))
    out = jax.tree.map(lambda *xs: np.concatenate(xs), *outs)
    return dict(u8=u8, gt=gt, K=K, tc=config_from_dict(dataclasses.asdict(jc)), out=out)


def _init_frames(initialized):
    return np.flatnonzero(np.diff(initialized.astype(int)) > 0) + 1


def _segments(T_wc, gt, resets):
    return segment_ate(T_wc[:, :3, 3], gt, resets, warmup=4, min_len=8)


@pytest.mark.parametrize("pyramid_impl", ["auto", "pallas"])
def test_kitti_gates_path_tracks_like_jax(gates, pyramid_impl):
    """Reset frames and (re-)init frames equal; keyframe flags equal on all
    but at most 3 frames (the draws differ, and at this size flows sit at
    the gate); each segment's sim3 ATE within 0.1 m of the JAX run's
    (sub-metre segments of 13-19 frames at a 400-px width)."""
    run = make_chunked_pipeline_fn(
        gates["tc"], gates["K"], device="cpu", pyramid_impl=pyramid_impl
    )
    state = init_state(gates["tc"], desc_dim=128, device="cpu")
    outs = []
    for i in range(0, GATES_FRAMES, CHUNK):
        state, out = run(state, gates["u8"][i : i + CHUNK])
        outs.append(out)
    T, kf, resets, init = (
        torch.cat([getattr(o, k) for o in outs]).numpy()
        for k in ("T_wc", "is_keyframe", "did_reset", "initialized")
    )
    out_j = gates["out"]
    assert np.isfinite(T).all()
    assert np.array_equal(np.flatnonzero(resets), np.flatnonzero(out_j.did_reset))
    assert resets.sum() == 1 and GATES_BLANK[0] <= np.flatnonzero(resets)[0] < GATES_BLANK[1] + 4
    assert np.array_equal(_init_frames(init), _init_frames(out_j.initialized))
    assert len(_init_frames(init)) == 2 and bool(init[-1])
    assert (kf != out_j.is_keyframe).sum() <= 3
    seg_t = _segments(T, gates["gt"], resets)
    seg_j = _segments(out_j.T_wc, gates["gt"], out_j.did_reset)
    assert len(seg_t) == len(seg_j) == 2
    for (s_t, e_t, a_t), (s_j, e_j, a_j) in zip(seg_t, seg_j):
        assert (s_t, e_t) == (s_j, e_j) and abs(a_t - a_j) <= 0.1, (seg_t, seg_j)


# ---- the per-frame engine and checkpoints --------------------------------


def test_engine_clears_trajectory_on_reset(gates):
    engine = VOEngine(gates["K"], gates["tc"], device="cpu")
    outs = [engine.process_frame(img) for img in gates["u8"][:24]]
    resets = np.flatnonzero([o.did_reset for o in outs])
    assert np.array_equal(resets, np.flatnonzero(gates["out"].did_reset))
    pos = engine.positions()
    assert pos.shape == (24 - resets[-1], 3) and engine.frame_id == 24
    np.testing.assert_array_equal(pos[-1], outs[-1].T_wc[:3, 3])
    assert len(engine._kf_log) == sum(bool(o.is_keyframe) for o in outs[resets[-1]:])
    assert bool(outs[-1].initialized)


def test_engine_resumes_from_checkpoint_bit_for_bit(ref, tmp_path):
    """Saved after frame 5 and loaded into a fresh engine, frames 6-11 give
    the uninterrupted run's outputs exactly (CPU): the VO state and the
    RANSAC generator's state are both in the file."""
    tc, K, u8 = ref["tc"], ref["scene"].K, ref["u8"]
    whole = VOEngine(K, tc, device="cpu")
    outs = [whole.process_frame(img) for img in u8]
    assert bool(outs[-1].initialized) and sum(bool(o.is_keyframe) for o in outs) >= 8

    first = VOEngine(K, tc, device="cpu")
    for img in u8[:6]:
        first.process_frame(img)
    first.save_state(tmp_path / "state.npz")
    resumed = VOEngine(K, tc, device="cpu")
    resumed.load_state(tmp_path / "state.npz")
    for j, img in enumerate(u8[6:], start=6):
        out = resumed.process_frame(img)
        for a, b in zip(out, outs[j]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.positions(), whole.positions()[6:])

    # the functions under the engine: shapes are checked, and a checkpoint
    # without generator state cannot feed a generator
    save_state(first.state, tmp_path / "bare.npz")
    back = load_state(tmp_path / "bare.npz", first.state)
    for a, b in zip(back[:7], first.state[:7]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        load_state(tmp_path / "bare.npz", first.state, generator=torch.Generator())
    small = init_state(tc.replace(map_capacity=128), desc_dim=128, device="cpu")
    with pytest.raises(ValueError, match="map.points"):
        load_state(tmp_path / "bare.npz", small)


def test_engine_refuses_what_is_not_ported(ref):
    tc, K = ref["tc"], ref["scene"].K
    with pytest.raises(NotImplementedError, match="bundle-adjustment"):
        VOEngine(K, tc, enable_ba=True, device="cpu")
    with pytest.raises(ValueError, match="matcher_type"):
        VOEngine(K, tc.replace(matcher_type="lightglue"), device="cpu")
    with pytest.raises(NotImplementedError, match="Rerun"):
        VOEngine(K, tc, viz=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="pose-graph"):
        VOEngine(K, tc, device="cpu").positions(smoothed=True)


def test_entry_points_need_cuda_unless_cpu_is_asked(ref):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the entry points would run")
    tc, K = ref["tc"], ref["scene"].K
    for call in (
        lambda: init_state(tc, desc_dim=128),
        lambda: make_step_fn(tc, K),
        lambda: make_chunked_pipeline_fn(tc, K),
        lambda: VOEngine(K, tc),
        lambda: state_from_numpy(_np_state(ref["states"][0])),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
