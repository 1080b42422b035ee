"""Fixed-shape VO state and the ring-buffer landmark map.

Port of visualodometry_tpu/core/state.py: `NamedTuple`s of tensors. The
landmark map is a fixed-capacity ring buffer: id `pid` lives in slot
`pid % capacity`, so slots recycle in FIFO order. The JAX state's
`rng_key` has no counterpart here: the step draws RANSAC samples from a
`torch.Generator` it owns (core/step.py).

`state_from_numpy` / `state_to_numpy` carry a JAX `VOState` (leaves as
numpy arrays) into the port and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.frontend.interface import Features


class MapState(NamedTuple):
    points: torch.Tensor  # (M, 3) float32 landmark positions
    ids: torch.Tensor  # (M,) int32 landmark id per slot; -1 = empty
    next_id: torch.Tensor  # () int32 monotonically increasing


class Keyframe(NamedTuple):
    kps: torch.Tensor  # (N, 2) float32
    desc: torch.Tensor  # (N, D) float32
    kp_valid: torch.Tensor  # (N,) bool
    ids: torch.Tensor  # (N,) int32 landmark id per keypoint; -1 = none
    T_wc: torch.Tensor  # (4, 4) float32 world-from-camera


class VOState(NamedTuple):
    frame_id: torch.Tensor  # () int32
    initialized: torch.Tensor  # () bool
    has_keyframe: torch.Tensor  # () bool
    T_wc: torch.Tensor  # (4, 4) float32 current world-from-camera
    last_pos: torch.Tensor  # (3,) float32
    baseline_speed: torch.Tensor  # () float32
    is_turning: torch.Tensor  # () bool
    keyframe: Keyframe
    map: MapState


class StepOutput(NamedTuple):
    """Small per-frame outputs for the host (viz / eval / logging)."""

    T_wc: torch.Tensor  # (4, 4)
    speed: torch.Tensor  # () float32
    baseline_speed: torch.Tensor  # ()
    initialized: torch.Tensor  # () bool
    is_keyframe: torch.Tensor  # () bool
    kf_reason: torch.Tensor  # () int32: 0 none, 1 median-flow, 2 low-tracking
    did_reset: torch.Tensor  # () bool
    median_flow: torch.Tensor  # () float32
    num_tracked: torch.Tensor  # () int32
    num_matches: torch.Tensor  # () int32
    curr_ids: torch.Tensor  # (N,) int32 landmark ids on current keypoints
    match_idx: torch.Tensor  # (N,) int32 kf->curr match per kf keypoint
    match_valid: torch.Tensor  # (N,) bool


def _scalar(value, dtype, device) -> torch.Tensor:
    # a fill on the device: torch.tensor would copy from the host and wait
    return torch.full((), value, dtype=dtype, device=device)


def scatter_drop(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`dst.at[index].set(src, mode="drop")` for index in [0, len(dst)].

    Torch has no dropping scatter: entries whose index is len(dst) go to a
    spare row that is cut off again. No host synchronisation (a
    `nonzero` on the mask would need one). Returns a new tensor.
    """
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext[index.long()] = src.to(dst.dtype)
    return ext[:-1]


def init_map(cfg: VOConfig, device) -> MapState:
    m = cfg.map_capacity
    return MapState(
        points=torch.zeros((m, 3), dtype=torch.float32, device=device),
        ids=torch.full((m,), -1, dtype=torch.int32, device=device),
        next_id=_scalar(0, torch.int32, device),
    )


def empty_keyframe(cfg: VOConfig, desc_dim: int, device) -> Keyframe:
    n = cfg.padded_keypoints
    return Keyframe(
        kps=torch.zeros((n, 2), dtype=torch.float32, device=device),
        desc=torch.zeros((n, desc_dim), dtype=torch.float32, device=device),
        kp_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        ids=torch.full((n,), -1, dtype=torch.int32, device=device),
        T_wc=torch.eye(4, dtype=torch.float32, device=device),
    )


def init_state(cfg: VOConfig, desc_dim: int, device=None) -> VOState:
    """Fresh state on `device` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    return VOState(
        frame_id=_scalar(0, torch.int32, dev),
        initialized=_scalar(False, torch.bool, dev),
        has_keyframe=_scalar(False, torch.bool, dev),
        T_wc=torch.eye(4, dtype=torch.float32, device=dev),
        last_pos=torch.zeros(3, dtype=torch.float32, device=dev),
        baseline_speed=_scalar(1.0, torch.float32, dev),
        is_turning=_scalar(False, torch.bool, dev),
        keyframe=empty_keyframe(cfg, desc_dim, dev),
        map=init_map(cfg, dev),
    )


def landmark_lookup(map_state: MapState, pids: torch.Tensor):
    """Landmark positions for ids -> (points (..., 3), live (...,) bool).

    A landmark id is live iff its ring slot still holds it.
    """
    m = map_state.ids.shape[0]
    pids = pids.long()
    slots = torch.where(pids >= 0, pids % m, 0)
    live = (pids >= 0) & (map_state.ids[slots].long() == pids)
    return map_state.points[slots], live


def register_landmarks(map_state: MapState, pts3d: torch.Tensor, valid: torch.Tensor):
    """Append masked new landmarks, recycling the oldest slots (FIFO).

    pts3d: (K, 3); valid: (K,). Returns (new map, assigned ids (K,) int32,
    -1 where invalid). Ids follow entry order.
    """
    m = map_state.ids.shape[0]
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    new_ids = torch.where(valid, map_state.next_id.long() + rank, -1)
    slots = torch.where(valid, new_ids % m, m)
    points = scatter_drop(map_state.points, slots, pts3d)
    ids = scatter_drop(map_state.ids, slots, new_ids.to(torch.int32))
    count = torch.sum(valid).to(torch.int32)  # torch.sum widens to int64
    return (
        MapState(points=points, ids=ids, next_id=map_state.next_id + count),
        new_ids.to(torch.int32),
    )


def features_as_keyframe(feats: Features, ids: torch.Tensor, T_wc: torch.Tensor) -> Keyframe:
    return Keyframe(kps=feats.kps, desc=feats.desc, kp_valid=feats.valid, ids=ids, T_wc=T_wc)


def _as_dict(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


_DTYPES = {
    "frame_id": torch.int32, "initialized": torch.bool,
    "has_keyframe": torch.bool, "T_wc": torch.float32,
    "last_pos": torch.float32, "baseline_speed": torch.float32,
    "is_turning": torch.bool,
}
_KF_DTYPES = {
    "kps": torch.float32, "desc": torch.float32, "kp_valid": torch.bool,
    "ids": torch.int32, "T_wc": torch.float32,
}
_MAP_DTYPES = {"points": torch.float32, "ids": torch.int32, "next_id": torch.int32}


def _tensors(d: dict, dtypes: dict, device) -> dict:
    return {
        k: torch.tensor(np.asarray(d[k]), dtype=dt, device=device)
        for k, dt in dtypes.items()
    }


def state_from_numpy(d, device=None) -> VOState:
    """Carry a JAX `VOState` into the port.

    `d` is the JAX state with numpy leaves, as a NamedTuple or a dict
    (nested `keyframe` / `map` likewise); its `rng_key` is ignored.
    """
    dev = resolve_device(device)
    d = _as_dict(d)
    return VOState(
        **_tensors(d, _DTYPES, dev),
        keyframe=Keyframe(**_tensors(_as_dict(d["keyframe"]), _KF_DTYPES, dev)),
        map=MapState(**_tensors(_as_dict(d["map"]), _MAP_DTYPES, dev)),
    )


def state_to_numpy(state: VOState) -> dict:
    """The port's state as a nested dict of numpy arrays (JAX field names)."""

    def np_dict(nt):
        return {k: v.detach().cpu().numpy() for k, v in nt._asdict().items()}

    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()
           if k not in ("keyframe", "map")}
    out["keyframe"] = np_dict(state.keyframe)
    out["map"] = np_dict(state.map)
    return out
