"""Rerun visualization sink, mirroring the reference's channel layout.

Port of visualodometry_tpu/viz/rerun_sink.py: the same channels, entity
paths, colours and flow arrows, read from the port's tensors on the host.
Visualization is an optional sink object behind an interface, so the
compute path carries no viz coupling and runs headless; without the
rerun-sdk the sink warns and does nothing.

Channels reproduced (reference line refs):
  frame timeline                     vo.py:311
  world/camera/image                 vo.py:312
  metrics/speed, metrics/baseline    vo.py:315-318
  world/camera Transform3D           vo.py:321-324
  world/traj LineStrips3D (yellow)   vo.py:330
  landmarks (green) / candidates (red) Points2D   vo.py:335-343
  world/map Points3D (green=tracked, gray=idle)   vo.py:345-358
  flow Arrows2D every 10th match     vo.py:360-368
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RerunSink:
    def __init__(self, app_name: str = "VO") -> None:
        try:
            import rerun as rr  # type: ignore

            self.rr = rr
            rr.init(app_name, spawn=True)
            rr.log("world", rr.ViewCoordinates.RIGHT_HAND_Y_DOWN, static=True)
            self.enabled = True
        except Exception as e:  # a missing or broken viewer disables the sink
            import warnings

            warnings.warn(f"rerun unavailable ({e}); visualization disabled")
            self.enabled = False

    def log_frame(self, engine, out, img, feats) -> None:
        """Log one frame: `engine` a VOEngine after the frame, `out` its
        StepOutput on the host, `img` the frame, `feats` its Features."""
        if not self.enabled:
            return
        rr = self.rr
        rr.set_time("frame", sequence=engine.frame_id)
        if img is not None:
            rr.log("world/camera/image", rr.Image(_host(img)))
        rr.log("metrics/speed", rr.Scalars(float(out.speed)))
        rr.log("metrics/baseline", rr.Scalars(float(out.baseline_speed)))
        T = _host(out.T_wc)
        rr.log("world/camera", rr.Transform3D(translation=T[:3, 3], mat3x3=T[:3, :3]))
        if engine.trajectory:
            rr.log(
                "world/traj",
                rr.LineStrips3D([np.stack(engine.trajectory)], colors=[[255, 255, 0]]),
            )
        kps = _host(feats.kps)
        fvalid = _host(feats.valid)
        ids = _host(out.curr_ids)
        tracked = fvalid & (ids != -1)
        cand = fvalid & (ids == -1)
        if tracked.any():
            rr.log(
                "world/camera/image/landmarks",
                rr.Points2D(kps[tracked], colors=[0, 255, 0], radii=2),
            )
        if cand.any():
            rr.log(
                "world/camera/image/candidates",
                rr.Points2D(kps[cand], colors=[255, 0, 0], radii=2),
            )
        # 3D map: tracked landmarks green, rest gray
        map_ids = _host(engine.state.map.ids)
        map_pts = _host(engine.state.map.points)
        live = map_ids >= 0
        if live.any():
            active = np.isin(map_ids[live], ids[ids != -1])
            colors = np.where(active[:, None], [[0, 255, 0]], [[200, 200, 200]]).astype(np.uint8)
            rr.log("world/map", rr.Points3D(map_pts[live], colors=colors, radii=0.05))
        # optical flow arrows, every 10th match
        midx = _host(out.match_idx)
        mval = _host(out.match_valid)
        if mval.any():
            origins = _host(engine.state.keyframe.kps)[mval]
            vectors = kps[midx[mval]] - origins
            rr.log(
                "world/camera/image/flow",
                rr.Arrows2D(origins=origins[::10], vectors=vectors[::10], colors=[0, 255, 255]),
            )
