"""Assemble a fixed-shape BA problem from a window of keyframes.

Port of visualodometry_tpu/ba/window.py. From stacked keyframe arrays
(poses, keypoints, landmark ids per keypoint) build the dense (L, P)
observation grid: the landmarks are those (up to L) observed in the newest
keyframe, and each cell is found by an id-equality match against every
keyframe's ids, one batched comparison.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.ba.solver import BAProblem
from visualodometry_tpu_torch.core.state import MapState, landmark_lookup, scatter_drop
from visualodometry_tpu_torch.geometry.se3 import se3_inverse


def assemble_window(
    kf_T_wc: torch.Tensor,  # (P, 4, 4) world-from-camera per keyframe
    kf_kps: torch.Tensor,  # (P, N, 2)
    kf_ids: torch.Tensor,  # (P, N) landmark ids, -1 = none
    kf_valid: torch.Tensor,  # (P, N)
    map_state: MapState,
    K: torch.Tensor,
    num_landmarks: int,
) -> tuple[BAProblem, torch.Tensor]:
    """Returns (problem, chosen_ids (L,) with -1 padding); the problem's
    poses are camera-from-world."""
    newest_ids = kf_ids[-1]
    sel = (newest_ids >= 0) & kf_valid[-1]
    order = torch.sort((~sel).to(torch.int8), stable=True).indices  # selected first
    chosen = torch.where(sel[order], newest_ids[order], -1)[:num_landmarks]
    pts, live = landmark_lookup(map_state, chosen)
    chosen = torch.where(live, chosen, -1)
    # each chosen id's slot in each keyframe (ids are unique within a frame)
    eq = (chosen[:, None, None] == kf_ids[None]) & kf_valid[None]  # (L, P, N)
    slot = torch.argmax(eq.to(torch.int8), dim=2)  # first hit
    found = torch.any(eq, dim=2)
    P = kf_kps.shape[0]
    uv = kf_kps[torch.arange(P, device=kf_kps.device)[None, :], slot]  # (L, P, 2)
    mask = found & (chosen >= 0)[:, None]
    return BAProblem(T_cw=se3_inverse(kf_T_wc), X=pts, uv=uv, mask=mask, K=K), chosen


def write_back(map_state: MapState, chosen_ids: torch.Tensor, X_refined: torch.Tensor) -> MapState:
    """Scatter refined landmark positions back into the ring-buffer map,
    into the slots that still hold the same id (not evicted meanwhile)."""
    m = map_state.ids.shape[0]
    ok = chosen_ids >= 0
    slot = torch.where(ok, chosen_ids.long() % m, 0)
    still = ok & (map_state.ids[slot] == chosen_ids)
    points = scatter_drop(map_state.points, torch.where(still, slot, m), X_refined)
    return map_state._replace(points=points)
