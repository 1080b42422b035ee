"""The port's bundle adjustment (ba/) vs the JAX package on the CPU.

The solver on the fixtures of tests/test_ba.py cut to small P and L; the
window assembly and write-back, the in-loop window's push and rollover,
the write-back guard, `apply_pose_delta`, pose-graph smoothing on
tests/test_pose_graph.py's chain; then the chunked runner with in-loop BA
on a 640x192, 12-frame textured corridor with a 3-keyframe window, so that
BA runs (`VOEngine(enable_ba=True)` on the same frames:
tests/test_torch_ba_engine.py).

Tolerances: the solver's poses within 1e-4 and landmarks within 5e-3 m
(1e-4 of their 10-50 m depth; float32 sums in another order through an
ill-conditioned Schur system; measured 2e-6 and 2e-3), costs within 1e-4
relative; exact equality where no arithmetic differs (assembly,
write-back, push, acceptance decisions).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.ba import BAProblem as JProblem
from visualodometry_tpu.ba import ba_solve as jba_solve
from visualodometry_tpu.ba import inloop as jinloop
from visualodometry_tpu.ba import pose_graph as jpg
from visualodometry_tpu.ba.solver import ba_cost as jba_cost
from visualodometry_tpu.ba.window import assemble_window as jassemble
from visualodometry_tpu.ba.window import write_back as jwrite_back
from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.core import init_state as jinit_state
from visualodometry_tpu.core.runner import apply_pose_delta as japply_delta
from visualodometry_tpu.core.runner import make_chunked_pipeline_fn as jpipeline
from visualodometry_tpu.core.state import MapState as JMap
from visualodometry_tpu.core.state import StepOutput as JStepOutput
from visualodometry_tpu.eval import ate_rmse as jate
from visualodometry_tpu.geometry.se3 import se3_exp as jse3_exp
from visualodometry_tpu_torch.ba import inloop, pose_graph
from visualodometry_tpu_torch.ba.solver import BAProblem, ba_cost, ba_solve
from visualodometry_tpu_torch.ba.window import assemble_window, write_back
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
from visualodometry_tpu_torch.core.runner import apply_pose_delta
from visualodometry_tpu_torch.core.state import MapState, StepOutput
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
from visualodometry_tpu_torch.eval import ate_rmse

torch.set_num_threads(2)

K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], dtype=np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _window_scene(rng, P=5, L=60, noise=0.2):
    """tests/test_ba.py's window: P cameras moving forward, L landmarks."""
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 3, L), rng.uniform(10, 50, L)], 1)
    T_cw, uv, mask = [], np.zeros((L, P, 2)), np.ones((L, P), dtype=bool)
    for p in range(P):
        w = np.array([0.0, 0.002 * p, 0.0])
        t = np.array([0.05 * p, 0.0, -1.2 * p])
        T = np.eye(4)
        T[:3, :3] = cv2.Rodrigues(w)[0]
        T[:3, 3] = t
        T_cw.append(T)
        uv[:, p] = cv2.projectPoints(X, w, t, K.astype(np.float64), None)[0].reshape(-1, 2)
        mask[:, p] = (X @ T[:3, :3].T + t)[:, 2] > 1.0
    uv += rng.normal(0, noise, uv.shape)
    return np.stack(T_cw).astype(np.float32), X.astype(np.float32), uv.astype(np.float32), mask


def _perturbed(rng, P, L, noise):
    T_cw, X, uv, mask = _window_scene(rng, P=P, L=L, noise=noise)
    for p in range(2, P):
        dT = np.eye(4)
        dT[:3, :3] = cv2.Rodrigues(rng.normal(0, 0.01, 3))[0]
        dT[:3, 3] = rng.normal(0, 0.15, 3)
        T_cw[p] = (dT @ T_cw[p]).astype(np.float32)
    return T_cw, (X + rng.normal(0, 0.3, X.shape)).astype(np.float32), uv, mask


@pytest.mark.parametrize("P, L, noise, prior", [
    (5, 60, 0.0, 0.0),  # converges from a perturbation (tests/test_ba.py)
    (5, 60, 0.3, 0.0),  # the noise floor
    (8, 120, 0.2, 0.0),
    (5, 60, 0.1, 0.02),  # the radial scale prior
])
def test_ba_solve_matches_jax(rng, P, L, noise, prior):
    T_cw, X, uv, mask = _perturbed(rng, P, L, noise)
    mask[10:15] = False  # five landmarks unobserved: left as they are
    kw = dict(iters=10, damping=1e-4, scale_prior_rel=prior)
    s_j = jax.jit(lambda p: jba_solve(p, **kw))(JProblem(*(jnp.asarray(a) for a in (T_cw, X, uv, mask, K))))
    prob = BAProblem(*(_t(a) for a in (T_cw, X, uv, mask, K)))
    s_t = ba_solve(prob, **kw)
    np.testing.assert_allclose(s_t.T_cw.numpy(), np.asarray(s_j.T_cw), atol=1e-4)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), atol=5e-3)
    np.testing.assert_array_equal(s_t.X.numpy()[10:15], X[10:15])
    c0, c_t, c_j = float(ba_cost(prob)), float(ba_cost(s_t)), float(jba_cost(s_j))
    assert abs(c_t - c_j) <= 1e-4 * c_j + 1e-9 and c_t < c0
    if noise == 0.0:
        assert c_t < 1e-2 < 1.0 < c0


def _map_and_window(rng, P_kf=3, N=64, n_lm=40, M=256):
    pts = rng.normal(size=(n_lm, 3)).astype(np.float32)
    points = np.zeros((M, 3), np.float32)
    points[:n_lm] = pts
    ids = np.full((M,), -1, np.int32)
    ids[:n_lm] = np.arange(n_lm)
    kf_ids = np.full((P_kf, N), -1, np.int32)
    kf_valid = np.zeros((P_kf, N), bool)
    for p in range(P_kf):
        kf_ids[p, :30] = rng.choice(n_lm, 30, replace=False)
        kf_valid[p, :30] = True
    kf_valid[-1, 3] = False  # an invalid slot of the newest keyframe
    ids[kf_ids[-1, 5]] = -1  # a landmark evicted from the map
    kf_kps = rng.uniform(0, 500, (P_kf, N, 2)).astype(np.float32)
    kf_T_wc = np.stack([np.asarray(jse3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
                        for _ in range(P_kf)])
    return (points, ids, np.int32(n_lm)), (kf_T_wc, kf_kps, kf_ids, kf_valid)


def test_assemble_window_and_write_back_match_jax(rng):
    (points, ids, next_id), kf = _map_and_window(rng)
    prob_j, chosen_j = jassemble(*(jnp.asarray(a) for a in kf), JMap(
        jnp.asarray(points), jnp.asarray(ids), jnp.asarray(next_id)), jnp.asarray(K), 32)
    prob_t, chosen_t = assemble_window(*(_t(a) for a in kf), MapState(
        _t(points), _t(ids), _t(next_id)), _t(K), 32)
    np.testing.assert_array_equal(chosen_t.numpy(), np.asarray(chosen_j))
    assert (chosen_t >= 0).sum() == 28  # 30 observed, one invalid, one evicted
    np.testing.assert_array_equal(prob_t.mask.numpy(), np.asarray(prob_j.mask))
    m = prob_t.mask.numpy()
    np.testing.assert_array_equal(prob_t.uv.numpy()[m], np.asarray(prob_j.uv)[m])
    np.testing.assert_array_equal(prob_t.X.numpy(), np.asarray(prob_j.X))
    np.testing.assert_allclose(prob_t.T_cw.numpy(), np.asarray(prob_j.T_cw), atol=1e-6)
    X_new = prob_t.X.numpy() + 1.0
    # a chosen landmark evicted meanwhile keeps the slot's new occupant
    ids2 = ids.copy()
    ids2[chosen_t[0]] = 300 + int(chosen_t[0])
    map_j = jwrite_back(JMap(jnp.asarray(points), jnp.asarray(ids2), jnp.asarray(next_id)),
                        jnp.asarray(chosen_j), jnp.asarray(X_new))
    map_t = write_back(MapState(_t(points), _t(ids2), _t(next_id)), chosen_t, _t(X_new))
    np.testing.assert_array_equal(map_t.points.numpy(), np.asarray(map_j.points))
    assert not np.array_equal(map_t.points.numpy(), points)


def test_push_frame_rollover_matches_jax():
    """tests/test_ba_inloop.py's sequence: a non-keyframe leaves the window,
    three pushes fill it, a fourth evicts the oldest, a reset empties it
    (a reset-and-keyframe frame counts 1)."""
    cfg_j = JaxConfig(max_keypoints=8, ba_window=3)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    n = cfg_t.padded_keypoints
    win_j, win_t = jinloop.init_window(cfg_j), inloop.init_window(cfg_t, device="cpu")
    seq = [(1, 0, 0), (1, 1, 0), (2, 1, 0), (3, 1, 0), (4, 1, 0), (5, 1, 1), (6, 0, 1)]
    counts = []
    for v, kf, reset in seq:
        args = (np.full((n, 2), float(v), np.float32), np.full((n,), v, np.int32),
                np.ones((n,), bool), np.eye(4, dtype=np.float32) * v)
        win_j = jinloop.push_frame(win_j, *(jnp.asarray(a) for a in args),
                                   jnp.asarray(bool(kf)), jnp.asarray(bool(reset)))
        win_t = inloop.push_frame(win_t, *(_t(a) for a in args),
                                  torch.tensor(bool(kf)), torch.tensor(bool(reset)))
        for a, b in zip(win_t, win_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        counts.append(int(win_t.count))
    assert counts == [0, 1, 2, 3, 3, 1, 0]
    back = inloop.window_from_numpy(jax.tree.map(np.asarray, win_j), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, win_t))


def _outs(C, is_kf):
    z, zi, zb = np.zeros(C, np.float32), np.zeros(C, np.int32), np.zeros(C, bool)
    fields = dict(
        T_wc=np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)).copy(), speed=z,
        baseline_speed=z, initialized=np.ones(C, bool), is_keyframe=np.asarray(is_kf),
        kf_reason=zi, did_reset=zb, median_flow=z, num_tracked=zi, num_matches=zi,
        curr_ids=np.zeros((C, 4), np.int32), match_idx=np.zeros((C, 4), np.int32),
        match_valid=np.zeros((C, 4), bool),
    )
    return (JStepOutput(**{k: jnp.asarray(v) for k, v in fields.items()}),
            StepOutput(**{k: _t(v) for k, v in fields.items()}))


@pytest.mark.parametrize("is_kf, want", [
    ([False, False, False, False], [2.5, 2.5, 2.5, 2.5]),  # no keyframe: the whole chunk
    ([False, True, False, False], [0.0, 2.5, 2.5, 2.5]),  # from the last keyframe on
    ([True, False, True, False], [0.0, 0.0, 2.5, 2.5]),
])
def test_apply_pose_delta_matches_jax(is_kf, want):
    delta = np.eye(4, dtype=np.float32)
    delta[0, 3] = 2.5
    outs_j, outs_t = _outs(4, is_kf)
    fixed_j = japply_delta(outs_j, jnp.asarray(delta))
    fixed_t = apply_pose_delta(outs_t, _t(delta))
    np.testing.assert_array_equal(fixed_t.T_wc.numpy(), np.asarray(fixed_j.T_wc))
    np.testing.assert_allclose(fixed_t.T_wc[:, 0, 3].numpy(), want, atol=1e-6)


def test_accept_refined_landmarks_matches_jax():
    """tests/test_ba_inloop.py's cases: a NaN entry, a blown-up one and one
    pushed behind every camera are rejected; a mild refinement and an
    in-front-but-off entry within 4x the cost are kept."""
    rng = np.random.default_rng(0)
    P, L = 4, 32
    Kw = np.array([[500.0, 0, 320], [0, 500.0, 180], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-5, 5, L), rng.uniform(-2, 2, L), rng.uniform(8, 30, L)], 1)
    X = X.astype(np.float32)
    T_cw = np.broadcast_to(np.eye(4, dtype=np.float32), (P, 4, 4)).copy()
    T_cw[:, 2, 3] = -1.0 * np.arange(P)
    pc = np.einsum("pij,lj->lpi", T_cw[:, :3, :3], X) + T_cw[:, :3, 3]
    uv = (pc[..., :2] / pc[..., 2:] * 500.0 + [320, 180]).astype(np.float32)
    mask = pc[..., 2] > 1.0
    X_new = X.copy()
    X_new[0] = np.nan
    X_new[1] += np.float32([8.0, 0, 0])
    X_new[2] += np.float32([0.01, 0, 0])
    X_new[3] = np.float32([0.0, 0.0, -50.0])
    X_new[5] = np.float32([2.0, 0.0, 9.0])
    out_j = np.asarray(jinloop.accept_refined_landmarks(
        JProblem(*(jnp.asarray(a) for a in (T_cw, X, uv, mask, Kw))), jnp.asarray(X_new)))
    out_t = inloop.accept_refined_landmarks(
        BAProblem(*(_t(a) for a in (T_cw, X, uv, mask, Kw))), _t(X_new)).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t[[0, 1, 3]], X[[0, 1, 3]])
    np.testing.assert_array_equal(out_t[[2, 4]], X_new[[2, 4]])


def _chain(rng, P=12):
    """tests/test_pose_graph.py's chain: noisy absolute poses, exact
    consecutive and skip-2 relative measurements."""
    T_gt = [np.eye(4, dtype=np.float32)]
    d = np.eye(4, dtype=np.float32)
    d[:3, :3] = cv2.Rodrigues(np.array([0.0, 0.02, 0.0]))[0]
    d[:3, 3] = [0.05, 0.0, 1.0]
    for _ in range(1, P):
        T_gt.append((T_gt[-1] @ d).astype(np.float32))
    T_gt = np.stack(T_gt)
    T_noisy = T_gt.copy()
    for p in range(1, P):
        xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        T_noisy[p] = T_gt[p] @ np.asarray(jse3_exp(jnp.asarray(xi)))
    pairs = [(p, p + 1) for p in range(P - 1)] + [(p, p + 2) for p in range(P - 2)]
    Z = np.stack([np.linalg.solve(T_gt[i], T_gt[j]) for i, j in pairs]).astype(np.float32)
    return T_gt, T_noisy, np.array([i for i, _ in pairs]), np.array([j for _, j in pairs]), Z


def test_se3_log_matches_jax(rng):
    xi = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    xi[:4] *= 1e-3  # the series branch
    T = np.asarray(jse3_exp(jnp.asarray(xi)))
    log_t = pose_graph.se3_log(_t(T)).numpy()
    np.testing.assert_allclose(log_t, np.asarray(jpg.se3_log(jnp.asarray(T))), atol=1e-5)
    np.testing.assert_allclose(log_t, xi, atol=1e-4)


@pytest.mark.parametrize("corrupt", [False, True])
def test_pose_graph_smoothing_matches_jax(rng, corrupt):
    """The chain is recovered to 1e-2 (a corrupted edge of weight 0 is
    ignored), and the port's poses agree with JAX's within 1e-4."""
    T_gt, T_noisy, ei, ej, Z = _chain(rng)
    w = np.ones(len(ei), np.float32)
    if corrupt:
        Z[2, :3, 3] += 5.0
        w[2] = 0.0
    g_j = jpg.PoseGraph(*(jnp.asarray(a) for a in (T_noisy, ei.astype(np.int32),
                                                    ej.astype(np.int32), Z, w)))
    g_t = pose_graph.PoseGraph(*(_t(a) for a in (T_noisy, ei, ej, Z, w)))
    T_j = np.asarray(jpg.smooth_pose_graph(g_j, iters=10))
    T_t = pose_graph.smooth_pose_graph(g_t, iters=10)
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-4)
    assert np.linalg.norm(T_t.numpy()[:, :3, 3] - T_gt[:, :3, 3], axis=1).max() < 1e-2
    cost0 = float(pose_graph.pose_graph_cost(g_t))
    cost1 = float(pose_graph.pose_graph_cost(g_t._replace(T_wc=T_t)))
    assert abs(cost0 - float(jpg.pose_graph_cost(g_j))) <= 1e-4 * cost0
    assert cost1 < 1e-4 * cost0


# ---- the chunked runner and the engine with BA ----------------------------

SIZE = (640, 192)
CHUNK = 4
FRAMES = 12


def _cfgs():
    """tests/test_torch_pipeline.py's fixture configuration with a
    3-keyframe BA window."""
    jc = JaxConfig(
        extractor_type="sift", max_keypoints=512, sift_n_features=512,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0,
        min_parallax_deg=0.35, lowe_ratio=0.8, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096, ba_window=3,
    )
    return jc, config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def ba_ref():
    scene = make_scene(np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    u8 = render_fixture_u8(scene)
    jc, tc = _cfgs()
    run = jpipeline(jc, scene.K, enable_ba=True)
    carry = (jinit_state(jc, desc_dim=128), jinloop.init_window(jc))
    outs, counts = [], []
    for i in range(0, FRAMES, CHUNK):
        carry, out = run(carry, jnp.asarray(u8[i : i + CHUNK]))
        outs.append(jax.tree.map(np.asarray, out))
        counts.append(int(carry[1].count))
    out = jax.tree.map(lambda *xs: np.concatenate(xs), *outs)
    return dict(scene=scene, u8=u8, jc=jc, tc=tc, out=out, counts=counts)


def test_chunked_runner_with_ba_tracks_like_jax(ba_ref):
    """The same resets (none) and init frame, keyframe flags equal on all
    but at most one frame, the window full and BA run on the same chunks,
    sim3 ATE within 0.01 m of the JAX run's (the draws differ)."""
    run = make_chunked_pipeline_fn(ba_ref["tc"], ba_ref["scene"].K, device="cpu", enable_ba=True)
    carry = (init_state(ba_ref["tc"], desc_dim=128, device="cpu"),
             inloop.init_window(ba_ref["tc"], device="cpu"))
    outs, counts = [], []
    for i in range(0, FRAMES, CHUNK):
        carry, out = run(carry, ba_ref["u8"][i : i + CHUNK])
        outs.append(out)
        counts.append(int(carry[1].count))
    T = torch.cat([o.T_wc for o in outs]).numpy()
    kf = torch.cat([o.is_keyframe for o in outs]).numpy()
    init = torch.cat([o.initialized for o in outs]).numpy()
    out_j = ba_ref["out"]
    assert np.isfinite(T).all()
    assert not torch.cat([o.did_reset for o in outs]).any() and not out_j.did_reset.any()
    assert np.argmax(init) == np.argmax(out_j.initialized)
    assert (kf != out_j.is_keyframe).sum() <= 1
    assert counts == ba_ref["counts"] and run.ba.solves == sum(c == 3 for c in counts) >= 2
    gt = ba_ref["scene"].gt_positions
    ate_t = ate_rmse(T[8:, :3, 3], gt[8:], align="sim3")
    ate_j = jate(out_j.T_wc[8:, :3, 3], gt[8:], align="sim3")
    assert ate_j < 0.05 and abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)


def test_ba_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the entry points would run")
    _, tc = _cfgs()
    for call in (lambda: inloop.init_window(tc), lambda: inloop.make_ba_chunk_fn(tc, K),
                 lambda: make_chunked_pipeline_fn(tc, K, enable_ba=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
