"""The per-frame VO step, with its branches taken on the host.

Port of visualodometry_tpu/core/step.py (ratio-matcher branch). The JAX
step is a nest of `lax.cond`s; here the handful of scalars that pick a
branch are read back to the host and the branch is a Python `if`:

- one read per frame, right after matching: has_keyframe, initialized,
  the match-count and median-flow gates, and the usable-landmark gate;
- tracking: one more, [pnp.ok, is_keyframe], read together;
- initialization: one more for ess.ok, and one for the landmark count
  when cfg.min_init_landmarks > 0.

So a tracking frame costs two host synchronisations. Everything else
(matching, RANSAC, refinement, map updates) is queued without waiting.

Branch map (reference line numbers, src/modules/vo.py): bootstrap 56-61,
init flow gate 75-85, init E + recoverPose 87-110, track lookup +
min_inliers gate 121-130, PnP 135-149, speed smoothing 150-204, id
propagation 206-210, keyframe decision 212-238, reset 240-245 / 290-299,
keyframe creation 252-288.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.state import (
    Keyframe,
    StepOutput,
    VOState,
    features_as_keyframe,
    init_map,
    landmark_lookup,
    register_landmarks,
    scatter_drop,
)
from visualodometry_tpu_torch.estimation.essential import (
    estimate_essential_ransac,
    recover_pose,
)
from visualodometry_tpu_torch.estimation.pnp import pnp_sample_size, solve_pnp_ransac
from visualodometry_tpu_torch.estimation.ransac import sample_valid_indices
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.frontend.matcher import match_descriptors
from visualodometry_tpu_torch.geometry.se3 import make_T, se3_inverse
from visualodometry_tpu_torch.geometry.so3 import rotation_angle
from visualodometry_tpu_torch.geometry.triangulation import triangulate_points

Sampler = Callable[[torch.Tensor, int, int], torch.Tensor]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries, matching np.median's even-count average."""
    vals = torch.sort(torch.where(mask, x, 1e30)).values
    n = torch.sum(mask.to(torch.int64))
    lo_hi = torch.stack([torch.clamp((n - 1) // 2, min=0), torch.clamp(n // 2, min=0)])
    med = 0.5 * torch.sum(vals.index_select(0, lo_hi))  # no host read
    return torch.where(n > 0, med, 0.0)


def make_step_fn(
    cfg: VOConfig, K, device=None, sampler: Sampler | None = None
) -> Callable[[VOState, Features], tuple[VOState, StepOutput]]:
    """Build the step closure for a config + intrinsics on `device`.

    `sampler(valid, H, k) -> (H, k)` draws the RANSAC minimal samples; by
    default `sample_valid_indices` from a `torch.Generator` on the device
    seeded with cfg.seed. Tests pass the JAX engine's draws instead. The
    returned step carries that generator as `step.generator` (None with a
    custom sampler), so a checkpoint can hold its state.
    """
    if cfg.matcher_type != "ratio":
        raise NotImplementedError("make_step_fn: only the ratio matcher is ported")
    dev = resolve_device(device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    gen = None
    if sampler is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)

        def sampler(valid, num_hypotheses, sample_size):
            return sample_valid_indices(gen, valid, num_hypotheses, sample_size)

    ess_k = 5 if cfg.essential_solver == "5point" else 8
    pnp_k = pnp_sample_size(cfg)
    min_pool = max(cfg.min_inliers, cfg.min_init_landmarks)

    def full(value, dtype):
        return torch.full((), value, dtype=dtype, device=dev)

    def _output(
        state, n, *, speed=None, is_keyframe=False, kf_reason=0,
        did_reset=False, median_flow=None, num_tracked=None,
        num_matches=None, curr_ids=None, match_idx=None, match_valid=None,
    ) -> StepOutput:
        return StepOutput(
            T_wc=state.T_wc,
            speed=full(0.0, torch.float32) if speed is None else speed.to(torch.float32),
            baseline_speed=state.baseline_speed,
            initialized=state.initialized,
            is_keyframe=full(is_keyframe, torch.bool),
            kf_reason=(
                kf_reason.to(torch.int32) if torch.is_tensor(kf_reason)
                else full(kf_reason, torch.int32)
            ),
            did_reset=full(did_reset, torch.bool),
            median_flow=full(0.0, torch.float32) if median_flow is None else median_flow,
            num_tracked=full(0, torch.int32) if num_tracked is None else num_tracked,
            num_matches=full(0, torch.int32) if num_matches is None else num_matches,
            curr_ids=(
                torch.full((n,), -1, dtype=torch.int32, device=dev)
                if curr_ids is None else curr_ids
            ),
            match_idx=(
                torch.zeros((n,), dtype=torch.int32, device=dev)
                if match_idx is None else match_idx
            ),
            match_valid=(
                torch.zeros((n,), dtype=torch.bool, device=dev)
                if match_valid is None else match_valid
            ),
        )

    def _create_keyframe(state, feats, curr_ids, match_idx, match_valid):
        """Triangulate unmatched-to-map matches, register, swap keyframe."""
        kf = state.keyframe
        T_cw_ref = se3_inverse(kf.T_wc)
        T_cw_curr = se3_inverse(state.T_wc)
        mi = match_idx.long()
        matched_curr_ids = torch.where(match_valid, curr_ids[mi], 0)
        no_id = match_valid & (matched_curr_ids == -1)
        pts3d, tri_valid = triangulate_points(
            T_cw_ref, T_cw_curr, kf.kps, feats.kps[mi], K, cfg, valid_in=no_id
        )
        new_map, new_ids = register_landmarks(state.map, pts3d, tri_valid)
        n = curr_ids.shape[0]
        curr_ids = scatter_drop(curr_ids, torch.where(tri_valid, mi, n), new_ids)
        new_kf = features_as_keyframe(feats, curr_ids, state.T_wc)
        n_new = torch.sum((new_ids >= 0).to(torch.int32))
        state = state._replace(
            map=new_map, keyframe=new_kf, has_keyframe=full(True, torch.bool)
        )
        return state, curr_ids, n_new

    def _reset(state: VOState) -> VOState:
        """Failure reset (reference: src/modules/vo.py:290-299)."""
        kf = state.keyframe
        cleared_kf = Keyframe(
            kps=torch.zeros_like(kf.kps),
            desc=torch.zeros_like(kf.desc),
            kp_valid=torch.zeros_like(kf.kp_valid),
            ids=torch.full_like(kf.ids, -1),
            T_wc=torch.eye(4, dtype=torch.float32, device=dev),
        )
        return state._replace(
            initialized=full(False, torch.bool),
            has_keyframe=full(False, torch.bool),
            keyframe=cleared_kf,
            map=init_map(cfg, dev)._replace(next_id=state.map.next_id),
            last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
            baseline_speed=full(1.0, torch.float32),
        )

    def step(state: VOState, feats: Features) -> tuple[VOState, StepOutput]:
        n = feats.num_slots
        kf = state.keyframe

        match = match_descriptors(
            kf.desc, kf.kp_valid, feats.desc, feats.valid,
            ratio=cfg.lowe_ratio, mutual=cfg.mutual_check,
        )
        match_idx, match_valid = match.idx, match.valid
        num_matches = torch.sum(match_valid.to(torch.int32))
        uv_ref = kf.kps
        uv_curr = feats.kps[match_idx.long()]
        flow = torch.linalg.vector_norm(uv_ref - uv_curr, dim=-1)
        median_flow = masked_median(flow, match_valid)
        curr_ids0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
        lm_pts, lm_live = landmark_lookup(state.map, kf.ids)
        pnp_valid = match_valid & lm_live
        usable = torch.sum(pnp_valid.to(torch.int32))
        matched = dict(
            match_idx=match_idx, match_valid=match_valid,
            median_flow=median_flow, num_matches=num_matches,
        )

        # the one host read that picks the frame's branch
        has_kf, initialized, few_matches, low_flow, enough_usable = torch.stack([
            state.has_keyframe, state.initialized, num_matches < min_pool,
            median_flow < cfg.min_median_flow, usable > cfg.min_inliers,
        ]).tolist()

        if not has_kf:  # bootstrap: adopt the first keyframe
            new_kf = features_as_keyframe(
                feats, curr_ids0, torch.eye(4, dtype=torch.float32, device=dev)
            )
            state = state._replace(keyframe=new_kf, has_keyframe=full(True, torch.bool))
            out = _output(state, n, curr_ids=curr_ids0)
        elif not initialized:
            state, out = initialize(
                state, feats, curr_ids0, few_matches, low_flow, uv_ref, uv_curr, matched
            )
        elif not enough_usable:  # lost (reference: vo.py:243-245)
            state = _reset(state)
            out = _output(state, n, did_reset=True, **matched)
        else:
            state, out = track(state, feats, curr_ids0, lm_pts, pnp_valid, uv_curr, matched)
        state = state._replace(frame_id=state.frame_id + 1)
        return state, out

    def initialize(state, feats, curr_ids0, few_matches, low_flow, uv_ref, uv_curr, matched):
        n = feats.num_slots
        match_idx, match_valid = matched["match_idx"], matched["match_valid"]
        if few_matches:
            # the adopted keyframe yields (almost) no matches: replace it
            new_kf = features_as_keyframe(
                feats, curr_ids0, torch.eye(4, dtype=torch.float32, device=dev)
            )
            state = state._replace(keyframe=new_kf)
            return state, _output(state, n, curr_ids=curr_ids0)
        if low_flow:
            return state, _output(state, n, curr_ids=curr_ids0, **matched)
        idx = sampler(match_valid, cfg.essential_hypotheses, ess_k)
        ess = estimate_essential_ransac(uv_ref, uv_curr, match_valid, K, cfg, idx)
        if not bool(ess.ok):
            return state, _output(state, n, curr_ids=curr_ids0, **matched)
        R, t = recover_pose(ess.E, uv_ref, uv_curr, ess.inliers, K)
        T_cw = make_T(R, t * cfg.global_scale)
        T_wc = se3_inverse(T_cw)
        init_dist = torch.linalg.vector_norm(T_wc[:3, 3])
        state1 = state._replace(
            T_wc=T_wc,
            last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
            baseline_speed=init_dist,
            initialized=full(True, torch.bool),
        )
        state1, curr_ids, n_new = _create_keyframe(
            state1, feats, curr_ids0, match_idx, match_valid
        )
        if cfg.min_init_landmarks > 0 and int(n_new) < cfg.min_init_landmarks:
            # init-quality gate: too few landmarks, wait for a better pair
            return state, _output(state, n, curr_ids=curr_ids0, **matched)
        return state1, _output(
            state1, n, curr_ids=curr_ids, speed=init_dist, is_keyframe=True, **matched
        )

    def track(state, feats, curr_ids0, lm_pts, pnp_valid, uv_curr, matched):
        n = feats.num_slots
        kf_ids = state.keyframe.ids
        median_flow = matched["median_flow"]
        idx = sampler(pnp_valid, cfg.pnp_hypotheses, pnp_k)
        pnp = solve_pnp_ransac(
            lm_pts, uv_curr, pnp_valid, K, cfg, idx, T_init=se3_inverse(state.T_wc)
        )
        # the pnp_ok branch's device work is queued before the host read
        T_cw = pnp.T_cw
        T_wc_raw = se3_inverse(T_cw)
        raw_pos = T_wc_raw[:3, 3]
        delta = raw_pos - state.last_pos
        raw_speed = torch.linalg.vector_norm(delta)
        R_rel = T_cw[:3, :3] @ state.T_wc[:3, :3]
        rot_magnitude = rotation_angle(R_rel)
        is_turning = rot_magnitude > cfg.turn_thresh
        is_moving = raw_speed > cfg.move_thresh
        smoothing = torch.where(is_turning, cfg.turn_smoothing, cfg.trans_smoothing)
        target_speed = smoothing * state.baseline_speed + (1.0 - smoothing) * raw_speed
        scale_factor = torch.clamp(
            target_speed / torch.clamp(raw_speed, min=1e-12),
            cfg.scale_clamp_min, cfg.scale_clamp_max,
        )
        new_baseline = torch.where(
            is_moving & ~is_turning,
            (1.0 - cfg.baseline_lr) * state.baseline_speed + cfg.baseline_lr * raw_speed,
            state.baseline_speed,
        )
        corrected_delta = delta * scale_factor
        T_wc_moving = T_wc_raw.clone()
        T_wc_moving[:3, 3] = state.last_pos + corrected_delta
        T_wc_new = torch.where(is_moving, T_wc_moving, T_wc_raw)
        speed_plot = torch.where(
            is_moving, torch.linalg.vector_norm(corrected_delta), 0.0
        )
        # landmark-id propagation (vo.py:206-210)
        prop = pnp.inliers
        mi = matched["match_idx"].long()
        curr_ids = scatter_drop(
            curr_ids0, torch.where(prop, mi, n), torch.where(prop, kf_ids, -1)
        )
        num_tracked = torch.sum((curr_ids != -1).to(torch.int32))
        kf_flow = median_flow > cfg.min_median_flow
        kf_low = num_tracked < cfg.kf_min_tracked
        is_kf_t = kf_flow | kf_low
        reason = torch.where(kf_flow, 1, torch.where(kf_low, 2, 0))

        pnp_ok, is_kf = torch.stack([pnp.ok, is_kf_t]).tolist()
        if not pnp_ok:  # (reference: vo.py:240-242)
            state = _reset(state)
            return state, _output(state, n, did_reset=True, **matched)
        state = state._replace(
            T_wc=T_wc_new,
            last_pos=T_wc_new[:3, 3],
            baseline_speed=new_baseline,
            is_turning=torch.where(is_moving, is_turning, state.is_turning),
        )
        if is_kf:
            state, curr_ids, _ = _create_keyframe(
                state, feats, curr_ids, matched["match_idx"], matched["match_valid"]
            )
        return state, _output(
            state, n, curr_ids=curr_ids, num_tracked=num_tracked,
            speed=speed_plot, is_keyframe=bool(is_kf), kf_reason=reason, **matched,
        )

    step.generator = gen
    return step
