"""Host-side VO engine: frontend + step, one frame per call.

Port of `VOEngine` from visualodometry_tpu/core/pipeline.py, without
windowed BA: extraction and the VO step run on the device; this class owns
the thin host state around them: the trajectory log (cleared on a reset,
as the reference does), the keyframe pose log, and checkpointing of the
state together with the step's RANSAC generator. `enable_ba`,
`positions(smoothed=True)`, the SuperPoint extractor and a `viz` sink are
not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core import checkpoint
from visualodometry_tpu_torch.core.state import StepOutput, VOState, init_state
from visualodometry_tpu_torch.core.step import make_step_fn
from visualodometry_tpu_torch.frontend.interface import Features


@dataclass
class VOEngine:
    """Single-sequence engine on `device` (CUDA unless "cpu" is asked for)."""

    K: np.ndarray
    cfg: VOConfig
    enable_ba: bool = False
    viz: Any = None
    desc_dim: int = 128
    device: Any = None

    state: VOState = field(init=False)
    trajectory: list = field(init=False, default_factory=list)
    frame_id: int = field(init=False, default=0)
    _kf_log: list = field(init=False, default_factory=list)  # 4x4 poses
    _traj_kf: list = field(init=False, default_factory=list)  # frame -> kf index

    def __post_init__(self):
        if self.enable_ba:
            raise NotImplementedError(
                "VOEngine: enable_ba waits for the bundle-adjustment slice"
            )
        if self.viz is not None:
            raise NotImplementedError("VOEngine: viz waits for the Rerun-sink slice")
        self.K = np.asarray(self.K, np.float32)
        self.device = resolve_device(self.device)
        if self.cfg.extractor_type == "sift":
            from visualodometry_tpu_torch.frontend.sift import extract_sift

            self._extract = lambda img: extract_sift(img, self.cfg, device=self.device)
        elif self.cfg.extractor_type == "superpoint":
            raise NotImplementedError(
                "VOEngine: the SuperPoint extractor waits for the learned-frontend slice"
            )
        else:  # "synthetic" / precomputed features
            self._extract = None
        self._step = make_step_fn(self.cfg, self.K, device=self.device)
        self.state = init_state(self.cfg, desc_dim=self.desc_dim, device=self.device)

    # ---- per-frame API (image in, pose out) ----
    def process_frame(self, img, feats: Features | None = None) -> StepOutput:
        """Advance one frame from an image (uint8 or float (H, W), numpy or
        tensor) or from `Features`. Returns the step's outputs as numpy."""
        if feats is None:
            if self._extract is None:
                raise ValueError("VOEngine: no extractor for raw images")
            feats = self._extract(torch.as_tensor(img))
        else:
            feats = Features(*(torch.as_tensor(x).to(self.device) for x in feats))
        self.state, out = self._step(self.state, feats)
        out_host = StepOutput(*(x.cpu().numpy() for x in out))

        if bool(out_host.did_reset):
            # the reference resets the trajectory on failure
            self.trajectory = []
            self._kf_log = []
            self._traj_kf = []
        self.trajectory.append(out_host.T_wc[:3, 3].copy())
        if bool(out_host.is_keyframe):
            self._kf_log.append(out_host.T_wc.copy())
        self._traj_kf.append(len(self._kf_log) - 1)
        self.frame_id += 1
        return out_host

    # ---- evaluation ----
    def positions(self, smoothed: bool = False) -> np.ndarray:
        """Per-frame positions since the last reset, (F, 3)."""
        if smoothed:
            raise NotImplementedError(
                "VOEngine: positions(smoothed=True) waits for the pose-graph slice"
            )
        if not self.trajectory:
            return np.zeros((0, 3), np.float32)
        return np.stack(self.trajectory)

    # ---- checkpoint ----
    def save_state(self, path: str | Path) -> None:
        """The VO state and the RANSAC generator's state, to one .npz."""
        checkpoint.save_state(self.state, path, generator=self._step.generator)

    def load_state(self, path: str | Path) -> None:
        """Resume from `save_state`'s file: the frames that follow give the
        outputs of the uninterrupted run. The host logs are not restored."""
        self.state = checkpoint.load_state(
            path, self.state, generator=self._step.generator
        )
