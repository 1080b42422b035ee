"""KLT-tracking VO mode: continuous tracking with candidate keypoints.

Port of visualodometry_tpu/core/klt_step.py. Every slot is tracked frame
to frame by pyramidal KLT (ops/klt.py) from the stored previous frame, no
descriptors in the loop. A candidate slot stores its first observation
(pixel and camera pose) and is triangulated into a landmark once the
bearing parallax since then clears a threshold; slots with live landmarks
feed PnP. Dead slots are refilled from fresh detections away from live
tracks.

The JAX step is a nest of `lax.cond`s; here the branch scalars are read
back to the host and the branch is a Python `if`:

- has_tracks and initialized are known on the host for a state this step
  returned (it chose them), so they cost no read; a state from elsewhere
  (a checkpoint, `klt_state_from_numpy`) costs one;
- after tracking, one read: the median-flow gate (not initialized) or the
  usable-landmark gate (initialized);
- after the solver, one read: ess.ok or pnp.ok.

So a tracking frame costs two host synchronisations and a bootstrap frame
none. On CUDA, tracking runs the patch path through K2 (six launches a
frame at three levels); the JAX step runs its gather path on the CPU.

The JAX state's `rng_key` has no counterpart: the step draws RANSAC samples
from a `torch.Generator` it owns, or from a `sampler` (tests pass the JAX
engine's draws).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.state import (
    _MAP_DTYPES,
    MapState,
    _as_dict,
    _scalar,
    _tensors,
    init_map,
    landmark_lookup,
    register_landmarks,
    scatter_drop,
)
from visualodometry_tpu_torch.core.step import Sampler, masked_median, smoothed_pose
from visualodometry_tpu_torch.estimation.essential import (
    estimate_essential_ransac,
    recover_pose,
)
from visualodometry_tpu_torch.estimation.pnp import pnp_sample_size, solve_pnp_ransac
from visualodometry_tpu_torch.estimation.ransac import sample_valid_indices
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.geometry.camera import pixels_to_normalized, project_points_T
from visualodometry_tpu_torch.geometry.linalg import smallest_eigvec
from visualodometry_tpu_torch.geometry.se3 import make_T, se3_inverse
from visualodometry_tpu_torch.ops.klt import klt_track


class KLTState(NamedTuple):
    frame_id: torch.Tensor  # () int32
    initialized: torch.Tensor  # () bool
    has_tracks: torch.Tensor  # () bool
    T_wc: torch.Tensor  # (4, 4)
    last_pos: torch.Tensor  # (3,)
    baseline_speed: torch.Tensor  # ()
    is_turning: torch.Tensor  # () bool
    image: torch.Tensor  # (H, W) float32 previous frame
    kps: torch.Tensor  # (N, 2) current track positions
    ids: torch.Tensor  # (N,) int32 landmark id, -1 = candidate
    valid: torch.Tensor  # (N,) bool
    first_uv: torch.Tensor  # (N, 2) candidate first observation
    first_T_cw: torch.Tensor  # (N, 4, 4) pose at first observation
    map: MapState


class KLTStepOutput(NamedTuple):
    T_wc: torch.Tensor
    speed: torch.Tensor
    initialized: torch.Tensor
    did_reset: torch.Tensor
    num_tracked: torch.Tensor  # slots tracked by KLT this frame
    num_landmarks: torch.Tensor  # tracked slots with live landmarks (PnP inliers)
    num_promoted: torch.Tensor  # candidates promoted to landmarks
    kps: torch.Tensor  # (N, 2)
    ids: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,)


def init_klt_state(cfg: VOConfig, image_hw: tuple[int, int], device=None) -> KLTState:
    """Fresh KLT state on `device` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    n = cfg.padded_keypoints
    h, w = image_hw
    return KLTState(
        frame_id=_scalar(0, torch.int32, dev),
        initialized=_scalar(False, torch.bool, dev),
        has_tracks=_scalar(False, torch.bool, dev),
        T_wc=torch.eye(4, dtype=torch.float32, device=dev),
        last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
        baseline_speed=_scalar(1.0, torch.float32, dev),
        is_turning=_scalar(False, torch.bool, dev),
        image=torch.zeros((h, w), dtype=torch.float32, device=dev),
        kps=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        ids=torch.full((n,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        first_uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        first_T_cw=torch.eye(4, dtype=torch.float32, device=dev).expand(n, 4, 4).clone(),
        map=init_map(cfg, dev),
    )


_KLT_DTYPES = {
    "frame_id": torch.int32, "initialized": torch.bool, "has_tracks": torch.bool,
    "T_wc": torch.float32, "last_pos": torch.float32, "baseline_speed": torch.float32,
    "is_turning": torch.bool, "image": torch.float32, "kps": torch.float32,
    "ids": torch.int32, "valid": torch.bool, "first_uv": torch.float32,
    "first_T_cw": torch.float32,
}


def klt_state_from_numpy(d, device=None) -> KLTState:
    """Carry a JAX `KLTState` into the port: `d` is the JAX state with numpy
    leaves, as a NamedTuple or a dict (nested `map` likewise); its `rng_key`
    is ignored."""
    dev = resolve_device(device)
    d = _as_dict(d)
    return KLTState(
        **_tensors(d, _KLT_DTYPES, dev),
        map=MapState(**_tensors(_as_dict(d["map"]), _MAP_DTYPES, dev)),
    )


def _bearings_world(uv: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unit bearing rays in world coordinates. uv: (N, 2); T_cw: (N, 4, 4)."""
    xy = pixels_to_normalized(uv, K)
    d_cam = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    d_w = torch.einsum("nji,nj->ni", T_cw[:, :3, :3], d_cam)  # R_wc d = R_cw^T d
    return d_w / torch.clamp(torch.linalg.vector_norm(d_w, dim=-1, keepdim=True), min=1e-12)


def _triangulate_per_view(T_cw1, T_cw2, uv1, uv2, K, cfg: VOConfig):
    """Two-view DLT with a first view per correspondence.

    T_cw1: (N, 4, 4); T_cw2: (4, 4) the shared current pose; uv: (N, 2).
    Returns (pts3d (N, 3), valid (N,)).
    """
    P1 = torch.einsum("ij,njk->nik", K, T_cw1[:, :3, :])  # (N, 3, 4)
    P2 = K @ T_cw2[:3, :]  # (3, 4)
    a0 = uv1[:, 0:1] * P1[:, 2] - P1[:, 0]
    a1 = uv1[:, 1:2] * P1[:, 2] - P1[:, 1]
    a2 = uv2[:, 0:1] * P2[2] - P2[0]
    a3 = uv2[:, 1:2] * P2[2] - P2[1]
    A = torch.stack([a0, a1, a2, a3], dim=1)  # (N, 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=2, keepdim=True), min=1e-12)
    X = smallest_eigvec(A.transpose(1, 2) @ A)
    w = X[:, 3]
    pts = X[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)[:, None]
    proj2, z2 = project_points_T(pts, T_cw2, K)
    err2 = torch.linalg.vector_norm(proj2 - uv2, dim=-1)
    return pts, (z2 > cfg.min_depth) & (err2 < cfg.max_reproj_err)


def make_klt_step_fn(
    cfg: VOConfig, K, image_hw: tuple[int, int], device=None, sampler: Sampler | None = None
) -> Callable[[KLTState, torch.Tensor, Features], tuple[KLTState, KLTStepOutput]]:
    """Build the KLT-mode step `(state, image, fresh_feats) -> (state, out)`
    on `device` (CUDA unless "cpu" is asked for).

    `image` is the frame, (H, W) uint8 or float in [0, 1]; `fresh_feats`
    are its detections (SIFT), which refill dead slots. `sampler(valid, H,
    k) -> (H, k)` draws the RANSAC minimal samples; by default from a
    `torch.Generator` on the device seeded with cfg.seed, which the step
    carries as `step.generator` (None with a custom sampler).
    """
    dev = resolve_device(device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    n = cfg.padded_keypoints
    parallax_min = math.radians(cfg.klt_min_parallax_deg)
    suppress_r2 = float(cfg.klt_suppress_radius**2)
    ess_k = 5 if cfg.essential_solver == "5point" else 8
    pnp_k = pnp_sample_size(cfg)
    gen = None
    if sampler is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)

        def sampler(valid, num_hypotheses, sample_size):
            return sample_valid_indices(gen, valid, num_hypotheses, sample_size)

    # (has_tracks, initialized) tensors of the state the step last returned,
    # and their values, which the step chose on the host
    known: list = [None, None, False, False]

    def full(value, dtype):
        return _scalar(value, dtype, dev)

    def _output(state, **kw) -> KLTStepOutput:
        fields = dict(
            T_wc=state.T_wc, speed=full(0.0, torch.float32), initialized=state.initialized,
            did_reset=full(False, torch.bool), num_tracked=full(0, torch.int32),
            num_landmarks=full(0, torch.int32), num_promoted=full(0, torch.int32),
            kps=state.kps, ids=state.ids, valid=state.valid,
        )
        fields.update(kw)
        return KLTStepOutput(**fields)

    def _replenish(state: KLTState, fresh: Features) -> KLTState:
        """Fill dead slots with fresh detections away from live tracks."""
        live = state.valid
        d2 = torch.sum((fresh.kps[:, None, :] - state.kps[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(live[None, :], d2, math.inf)
        eligible = fresh.valid & (torch.amin(d2, dim=1) > suppress_r2)
        # the j-th eligible detection goes to the j-th free slot (or is dropped)
        elig_rank = torch.cumsum(eligible.to(torch.int64), dim=0) - 1
        num_free = torch.sum(~live)
        free_slots = torch.sort(live.to(torch.int8), stable=True).indices  # free first
        dest = torch.where(
            eligible & (elig_rank < num_free), free_slots[elig_rank % n], n
        )
        T_cw_now = se3_inverse(state.T_wc)
        return state._replace(
            kps=scatter_drop(state.kps, dest, fresh.kps),
            first_uv=scatter_drop(state.first_uv, dest, fresh.kps),
            ids=scatter_drop(state.ids, dest, torch.full_like(state.ids, -1)),
            valid=scatter_drop(state.valid, dest, torch.ones_like(state.valid)),
            first_T_cw=scatter_drop(state.first_T_cw, dest, T_cw_now.expand(n, 4, 4)),
        )

    def _promote(state: KLTState) -> tuple[KLTState, torch.Tensor]:
        """Triangulate candidates whose parallax clears the threshold."""
        T_cw_now = se3_inverse(state.T_wc)
        cand = state.valid & (state.ids == -1)
        b1 = _bearings_world(state.first_uv, state.first_T_cw, K)
        b2 = _bearings_world(state.kps, T_cw_now.expand(n, 4, 4), K)
        cosang = torch.clamp(torch.sum(b1 * b2, dim=-1), -1.0, 1.0)
        try_tri = cand & (torch.arccos(cosang) > parallax_min)
        pts, tri_ok = _triangulate_per_view(
            state.first_T_cw, T_cw_now, state.first_uv, state.kps, K, cfg
        )
        promote = try_tri & tri_ok
        new_map, new_ids = register_landmarks(state.map, pts, promote)
        state = state._replace(
            map=new_map,
            ids=torch.where(promote, new_ids, state.ids),
            # candidates that had parallax but failed the gates are dropped
            valid=state.valid & ~(try_tri & ~tri_ok),
        )
        return state, torch.sum(promote.to(torch.int32))

    def _lost(state: KLTState, num_tracked):
        st = state._replace(
            initialized=full(False, torch.bool),
            has_tracks=full(False, torch.bool),
            valid=torch.zeros_like(state.valid),
            ids=torch.full_like(state.ids, -1),
            map=init_map(cfg, dev)._replace(next_id=state.map.next_id),
            last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
            baseline_speed=full(1.0, torch.float32),
        )
        out = _output(st, did_reset=full(True, torch.bool), num_tracked=num_tracked)
        return st, out, False

    def initialize(state: KLTState, num_tracked):
        # flow from each candidate's first observation
        flow = torch.linalg.vector_norm(state.kps - state.first_uv, dim=-1)
        med = masked_median(flow, state.valid)
        if bool(med < cfg.min_median_flow):  # host read 1
            return state, _output(state, num_tracked=num_tracked), False
        idx = sampler(state.valid, cfg.essential_hypotheses, ess_k)
        ess = estimate_essential_ransac(state.first_uv, state.kps, state.valid, K, cfg, idx)
        if not bool(ess.ok):  # host read 2
            return state, _output(state, num_tracked=num_tracked), False
        R, t = recover_pose(ess.E, state.first_uv, state.kps, ess.inliers, K)
        T_wc = se3_inverse(make_T(R, t * cfg.global_scale))
        state = state._replace(
            T_wc=T_wc,
            last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
            baseline_speed=torch.linalg.vector_norm(T_wc[:3, 3]),
            initialized=full(True, torch.bool),
        )
        state, n_prom = _promote(state)
        out = _output(
            state, num_tracked=num_tracked, num_promoted=n_prom, speed=state.baseline_speed
        )
        return state, out, True

    def track(state: KLTState, num_tracked):
        lm_pts, lm_live = landmark_lookup(state.map, state.ids)
        usable_mask = state.valid & lm_live
        if not bool(torch.sum(usable_mask.to(torch.int32)) > cfg.min_inliers):  # read 1
            return _lost(state, num_tracked)
        idx = sampler(usable_mask, cfg.pnp_hypotheses, pnp_k)
        pnp = solve_pnp_ransac(lm_pts, state.kps, usable_mask, K, cfg, idx)
        # the pnp_ok branch's device work is queued before the host read
        moved = smoothed_pose(cfg, state, pnp.T_cw)
        if not bool(pnp.ok):  # read 2
            return _lost(state, num_tracked)
        state = state._replace(**moved.state_fields)
        # landmarks whose reprojection failed PnP are cut
        state = state._replace(valid=state.valid & ~(usable_mask & ~pnp.inliers))
        state, n_prom = _promote(state)
        out = _output(
            state, num_tracked=num_tracked,
            num_landmarks=torch.sum((usable_mask & pnp.inliers).to(torch.int32)),
            num_promoted=n_prom, speed=moved.speed,
        )
        return state, out, True

    def step(state: KLTState, img, fresh: Features) -> tuple[KLTState, KLTStepOutput]:
        img = torch.as_tensor(img).to(dev)
        # the carry stores the normalised float32 frame
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) * (1.0 / 255.0)
        img = img.to(torch.float32)
        if known[0] is state.has_tracks and known[1] is state.initialized:
            has_tracks, initialized = known[2], known[3]
        else:
            has_tracks, initialized = torch.stack([state.has_tracks, state.initialized]).tolist()

        if not has_tracks:  # bootstrap: adopt fresh detections as candidates
            state = state._replace(
                kps=torch.zeros_like(state.kps),
                ids=torch.full_like(state.ids, -1),
                valid=torch.zeros_like(state.valid),
            )
            state = _replenish(state, fresh)
            state = state._replace(image=img, has_tracks=full(True, torch.bool))
            out = _output(state)
            has_tracks = True
        else:
            new_kps, tracked = klt_track(
                state.image, img, state.kps, state.valid, num_levels=cfg.klt_levels,
                radius=cfg.klt_radius, iters=cfg.klt_iters,
            )
            state = state._replace(kps=new_kps, valid=tracked)
            num_tracked = torch.sum(tracked.to(torch.int32))
            # the branches return the flags they leave: tracking keeps both
            # set unless it resets, initialization sets initialized or not
            if initialized:
                state, out, has_tracks = track(state, num_tracked)
                initialized = has_tracks
            else:
                state, out, initialized = initialize(state, num_tracked)
            # replenish dead slots with fresh detections, store the frame
            state = _replenish(state, fresh)
            state = state._replace(image=img)
        state = state._replace(frame_id=state.frame_id + 1)
        known[:] = [state.has_tracks, state.initialized, has_tracks, initialized]
        return state, out

    step.generator = gen
    return step
