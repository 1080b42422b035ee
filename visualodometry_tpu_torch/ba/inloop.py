"""Windowed BA for the chunk runner.

Port of visualodometry_tpu/ba/inloop.py. A fixed-shape window of the last
P keyframes (keypoints, landmark ids, poses) rides in the chunk runner's
carry. After each chunk the chunk's frames are pushed (keyframes enter,
a reset empties it); once the window is full, one damped-GN/Schur solve
refines it, the accepted landmarks are written back into the map, and with
`cfg.ba_pose_correction` the newest keyframe's pose correction moves the
live tracking pose.

The JAX chunk decides whether to solve with a `lax.cond` on the window's
count; here that is one host read per chunk. Pushing the frames is
device-side selection (no read), as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.ba.solver import BAProblem, ba_solve
from visualodometry_tpu_torch.ba.window import assemble_window, write_back
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.state import StepOutput, VOState, _as_dict, _tensors
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.geometry.se3 import se3_inverse


class KFWindow(NamedTuple):
    """Last-P-keyframes ring (newest at index P-1), fixed shape."""

    kps: torch.Tensor  # (P, N, 2) float32
    ids: torch.Tensor  # (P, N) int32 landmark ids, -1 = none
    valid: torch.Tensor  # (P, N) bool
    T_wc: torch.Tensor  # (P, 4, 4) float32 world-from-camera
    count: torch.Tensor  # () int32 number of live entries (<= P)


def init_window(cfg: VOConfig, device=None) -> KFWindow:
    """Empty window on `device` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    P, n = cfg.ba_window, cfg.padded_keypoints
    return KFWindow(
        kps=torch.zeros((P, n, 2), dtype=torch.float32, device=dev),
        ids=torch.full((P, n), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((P, n), dtype=torch.bool, device=dev),
        T_wc=torch.eye(4, dtype=torch.float32, device=dev).expand(P, 4, 4).clone(),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


_WINDOW_DTYPES = {
    "kps": torch.float32, "ids": torch.int32, "valid": torch.bool,
    "T_wc": torch.float32, "count": torch.int32,
}


def window_from_numpy(d, device=None) -> KFWindow:
    """Carry a JAX `KFWindow` (numpy leaves, NamedTuple or dict) into the port."""
    return KFWindow(**_tensors(_as_dict(d), _WINDOW_DTYPES, resolve_device(device)))


def push_frame(win: KFWindow, kps, ids, valid, T_wc, is_keyframe, did_reset) -> KFWindow:
    """Advance the window by one frame: a reset clears it, a keyframe is
    pushed (a reset and keyframe frame, a re-bootstrap, counts 1).
    `is_keyframe` and `did_reset` are () bool tensors; nothing is read back."""
    count0 = torch.where(did_reset, 0, win.count)
    P = win.kps.shape[0]

    def pushed(a, x):
        return torch.cat([a[1:], x[None].to(a.dtype)])

    kf = is_keyframe.reshape(())
    return KFWindow(
        kps=torch.where(kf, pushed(win.kps, kps), win.kps),
        ids=torch.where(kf, pushed(win.ids, ids), win.ids),
        valid=torch.where(kf, pushed(win.valid, valid), win.valid),
        T_wc=torch.where(kf, pushed(win.T_wc, T_wc), win.T_wc),
        count=torch.where(kf, torch.clamp(count0 + 1, max=P), count0).to(torch.int32),
    )


def accept_refined_landmarks(prob: BAProblem, X_new: torch.Tensor) -> torch.Tensor:
    """Per-landmark divergence guard for the BA write-back.

    A refined landmark is kept only if it is finite, its masked window
    reprojection cost against the tracked poses is at most 4x the old one
    plus 2 px^2, and it is in front of no fewer window cameras (a solve
    that pushes a landmark behind every camera would otherwise score cost
    0). Else the old position stays. The JAX function explains the loose
    bound: the solve refines poses and structure together, so a strict
    criterion against the tracked poses rejects the refinements that help.
    """
    K = prob.K
    R = prob.T_cw[:, :3, :3]
    t = prob.T_cw[:, :3, 3]
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])

    def lm_cost(X):
        pc = torch.einsum("pij,lj->lpi", R, X) + t[None]
        z = torch.clamp(pc[..., 2], min=1e-6)
        err = torch.sum((pc[..., :2] / z[..., None] * f + c - prob.uv) ** 2, dim=-1)
        ok = prob.mask & (pc[..., 2] > 1e-6)
        return torch.sum(torch.where(ok, err, 0.0), dim=1), torch.sum(ok, dim=1)

    finite = torch.isfinite(X_new).all(dim=-1)
    c_new, n_new = lm_cost(torch.where(finite[:, None], X_new, prob.X))
    c_old, n_old = lm_cost(prob.X)
    ok = finite & (c_new <= 4.0 * c_old + 2.0) & (n_new >= n_old)
    return torch.where(ok[:, None], X_new, prob.X)


def make_ba_chunk_fn(cfg: VOConfig, K, device=None):
    """`ba_chunk(state, window, feats, outs) -> (state, window, delta (4, 4))`.

    `feats` is the chunk's per-frame `Features` (a sequence), `outs` its
    stacked `StepOutput`. Pushes the chunk's keyframes into the window; if
    the window is then full (one host read), refines it with cfg.ba_iters
    GN iterations and writes the landmarks (and, with
    cfg.ba_pose_correction, the pose correction) back into the state.
    `delta` is the rigid correction of the newest window keyframe, identity
    when BA did not run or pose correction is off; the chunk runner
    retro-corrects the chunk's poses with it (`core.runner.apply_pose_delta`).
    `ba_chunk.solves` counts the solves run.
    """
    dev = resolve_device(device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    P = cfg.ba_window
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    def ba_chunk(state: VOState, win: KFWindow, feats: Sequence[Features],
                 outs: StepOutput) -> tuple[VOState, KFWindow, torch.Tensor]:
        for i, f in enumerate(feats):
            win = push_frame(win, f.kps, outs.curr_ids[i], f.valid, outs.T_wc[i],
                             outs.is_keyframe[i], outs.did_reset[i])
        if int(win.count) < P:  # the one host read per chunk
            return state, win, eye
        ba_chunk.solves += 1
        prob, chosen = assemble_window(
            win.T_wc, win.kps, win.ids, win.valid, state.map, K,
            num_landmarks=cfg.ba_max_landmarks,
        )
        solved = ba_solve(
            prob, iters=cfg.ba_iters, damping=cfg.ba_damping,
            # the radial scale-gauge prior is needed for pose correction
            scale_prior_rel=cfg.ba_scale_prior_rel if cfg.ba_pose_correction else 0.0,
        )
        # refined landmarks feed the next chunks' PnP
        state = state._replace(
            map=write_back(state.map, chosen, accept_refined_landmarks(prob, solved.X))
        )
        if not cfg.ba_pose_correction:
            # structure only: poses keep coming from the tracker
            return state, win, eye
        # the two oldest window poses are fixed, so the newest keyframe's
        # refined pose is a correction relative to the window's anchor;
        # a non-finite solve must not reach the live pose chain
        pose_ok = torch.isfinite(solved.T_cw).all()
        T_wc_ref = torch.where(pose_ok, se3_inverse(solved.T_cw), win.T_wc)
        delta = T_wc_ref[-1] @ se3_inverse(win.T_wc[-1])
        state = state._replace(
            T_wc=delta @ state.T_wc,
            last_pos=delta[:3, :3] @ state.last_pos + delta[:3, 3],
            keyframe=state.keyframe._replace(T_wc=delta @ state.keyframe.T_wc),
        )
        return state, win._replace(T_wc=T_wc_ref), delta

    ba_chunk.solves = 0
    return ba_chunk
