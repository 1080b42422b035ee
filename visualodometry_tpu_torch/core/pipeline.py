"""Host-side VO engine: frontend + step, one frame per call.

Port of `VOEngine` from visualodometry_tpu/core/pipeline.py: extraction,
the VO step and the BA solve run on the device; this class owns the thin
host state around them: the trajectory log (cleared on a reset, as the
reference does), the keyframe pose log, the sliding keyframe window for
BA and its refined edges, and checkpointing of the state together with
the step's RANSAC generator, and the optional visualization sink. Both
frontends (SIFT, SuperPoint with 256-D descriptors) and both matchers are
ported.
"""

from __future__ import annotations

from collections import deque
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
from visualodometry_tpu_torch.geometry.se3 import se3_inverse
from visualodometry_tpu_torch.utils.profiling import count, span


@dataclass
class _KeyframeRecord:
    kps: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor
    T_wc: np.ndarray
    kf_index: int = -1  # position in the engine's keyframe log


@dataclass
class VOEngine:
    """Single-sequence engine on `device` (CUDA unless "cpu" is asked for).

    With `enable_ba`, every keyframe that fills the window of the last
    cfg.ba_window keyframes triggers a BA solve (`_run_window_ba`): refined
    landmarks go back into the map, refined poses into the window, the
    keyframe log, the live state and the last trajectory entry, and the
    refined relative poses become pose-graph edges for
    `positions(smoothed=True)`.
    """

    K: np.ndarray
    cfg: VOConfig
    enable_ba: bool = False
    viz: Any = None  # optional sink with .log_frame(engine, out, img, feats)
    desc_dim: int = 128
    device: Any = None

    state: VOState = field(init=False)
    trajectory: list = field(init=False, default_factory=list)
    frame_id: int = field(init=False, default=0)
    _kf_log: list = field(init=False, default_factory=list)  # 4x4 poses
    _traj_kf: list = field(init=False, default_factory=list)  # frame -> kf index
    _kf_window: deque = field(init=False)
    _ba_edges: dict = field(init=False, default_factory=dict)  # (i, j) -> Z

    def __post_init__(self):
        self.K = np.asarray(self.K, np.float32)
        self.device = resolve_device(self.device)
        if self.cfg.extractor_type == "sift":
            from visualodometry_tpu_torch.frontend.sift import extract_sift

            self._extract = lambda img: extract_sift(img, self.cfg, device=self.device)
        elif self.cfg.extractor_type == "superpoint":
            from visualodometry_tpu_torch.frontend.superpoint import make_superpoint_extractor

            self._extract = make_superpoint_extractor(self.cfg, device=self.device)
            self.desc_dim = 256
        else:  # "synthetic" / precomputed features
            self._extract = None
        self._step = make_step_fn(self.cfg, self.K, device=self.device)
        self.state = init_state(self.cfg, desc_dim=self.desc_dim, device=self.device)
        self._kf_window = deque(maxlen=self.cfg.ba_window)
        self._K = torch.as_tensor(self.K, device=self.device)

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
        with span("readback"):  # one copy, and so one wait, a field
            out_host = StepOutput(*(x.cpu().numpy() for x in out))
        count("sync.readback", len(out))

        if bool(out_host.did_reset):
            # the reference resets the trajectory on failure
            self.trajectory = []
            self._kf_window.clear()
            self._kf_log = []
            self._traj_kf = []
            self._ba_edges = {}
        self.trajectory.append(out_host.T_wc[:3, 3].copy())
        if bool(out_host.is_keyframe):
            self._kf_log.append(out_host.T_wc.copy())
            self._kf_window.append(_KeyframeRecord(
                kps=feats.kps, ids=out.curr_ids, valid=feats.valid,
                T_wc=out_host.T_wc.copy(), kf_index=len(self._kf_log) - 1,
            ))
            if self.enable_ba and len(self._kf_window) == self.cfg.ba_window:
                self._run_window_ba()
        self._traj_kf.append(len(self._kf_log) - 1)

        if self.viz is not None:
            self.viz.log_frame(self, out_host, img, feats)
        self.frame_id += 1
        return out_host

    # ---- sliding-window BA ----
    def _run_window_ba(self):
        from visualodometry_tpu_torch.ba.solver import ba_solve
        from visualodometry_tpu_torch.ba.window import assemble_window, write_back

        recs = list(self._kf_window)
        dev = self.device
        prob, chosen = assemble_window(
            torch.as_tensor(np.stack([r.T_wc for r in recs]), device=dev),
            torch.stack([r.kps for r in recs]),
            torch.stack([r.ids for r in recs]),
            torch.stack([r.valid for r in recs]),
            self.state.map, self._K, num_landmarks=self.cfg.ba_max_landmarks,
        )
        solved = ba_solve(prob, iters=self.cfg.ba_iters, damping=self.cfg.ba_damping)
        new_map = write_back(self.state.map, chosen, solved.X)
        T_wc_dev = se3_inverse(solved.T_cw)
        T_wc_new = T_wc_dev.cpu().numpy()  # (P, 4, 4)
        # refresh the window records and the keyframe log with refined poses
        for r, T in zip(recs, T_wc_new):
            r.T_wc = T.copy()
            if 0 <= r.kf_index < len(self._kf_log):
                self._kf_log[r.kf_index] = T.copy()
        # refined relative poses of consecutive window keyframes become
        # pose-graph edges (the latest refinement wins)
        for ra, rb, Ta, Tb in zip(recs, recs[1:], T_wc_new, T_wc_new[1:]):
            if ra.kf_index >= 0 and rb.kf_index >= 0:
                self._ba_edges[(ra.kf_index, rb.kf_index)] = np.linalg.solve(Ta, Tb)
        self.state = self.state._replace(
            map=new_map,
            keyframe=self.state.keyframe._replace(T_wc=T_wc_dev[-1]),
            T_wc=T_wc_dev[-1],
            last_pos=T_wc_dev[-1, :3, 3],
        )
        if self.trajectory:
            self.trajectory[-1] = T_wc_new[-1][:3, 3].copy()

    # ---- evaluation ----
    def positions(self, smoothed: bool = False) -> np.ndarray:
        """Per-frame positions since the last reset, (F, 3).

        `smoothed=True` runs loop-free pose-graph smoothing over the
        keyframe chain (ba/pose_graph.py), fusing the chain's relative
        poses with the BA-refined window edges (weight 4), and carries each
        keyframe's correction to the frames tracked from it.
        """
        if not self.trajectory:
            return np.zeros((0, 3), np.float32)
        est = np.stack(self.trajectory)
        if not smoothed or len(self._kf_log) < 3:
            return est

        from visualodometry_tpu_torch.ba.pose_graph import PoseGraph, smooth_pose_graph

        T_kf = np.stack(self._kf_log)  # (P, 4, 4)
        P = len(T_kf)
        ei, ej = list(range(P - 1)), list(range(1, P))
        Z = [np.linalg.solve(T_kf[i], T_kf[j]) for i, j in zip(ei, ej)]
        w = [1.0] * len(ei)
        for (i, j), Zij in self._ba_edges.items():
            ei.append(i)
            ej.append(j)
            Z.append(Zij)
            w.append(4.0)
        dev = self.device
        g = PoseGraph(
            T_wc=torch.as_tensor(T_kf, dtype=torch.float32, device=dev),
            edges_i=torch.as_tensor(ei, device=dev),
            edges_j=torch.as_tensor(ej, device=dev),
            Z=torch.as_tensor(np.stack(Z), dtype=torch.float32, device=dev),
            weight=torch.as_tensor(w, dtype=torch.float32, device=dev),
        )
        T_sm = smooth_pose_graph(g, iters=10).cpu().numpy()
        out = est.copy()
        for f, k in enumerate(self._traj_kf[: len(est)]):
            if k < 0:
                continue
            delta = T_sm[k] @ np.linalg.inv(T_kf[k])
            out[f] = delta[:3, :3] @ est[f] + delta[:3, 3]
        return out

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
