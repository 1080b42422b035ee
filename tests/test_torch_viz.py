"""The port's Rerun sink against the JAX package's, with a fake `rerun`.

- For the same frame's host values (tensors for the port, numpy for JAX),
  both sinks log the same entity paths in the same order with equal
  arrays and arguments.
- `VOEngine(viz=sink, device="cpu")` calls the sink once a frame, after
  the frame, and the real sink logs every channel from the engine's own
  tensors.
- Without `rerun`, each sink warns and is disabled.
"""

import sys
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

from visualodometry_tpu.viz.rerun_sink import RerunSink as JaxSink
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core import VOEngine
from visualodometry_tpu_torch.data.synthetic import make_scene, render_features
from visualodometry_tpu_torch.viz.rerun_sink import RerunSink

torch.set_num_threads(2)


def fake_rerun():
    """A module that records every call: (name, args, kwargs) tuples in
    `calls`; each archetype returns its own record."""
    calls = []
    rr = types.ModuleType("rerun")
    rr.calls = calls

    def recorder(name):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return (name, args, kwargs)

        return call

    for name in ("init", "log", "set_time", "Image", "Scalars", "Transform3D",
                 "LineStrips3D", "Points2D", "Points3D", "Arrows2D"):
        setattr(rr, name, recorder(name))
    rr.ViewCoordinates = types.SimpleNamespace(RIGHT_HAND_Y_DOWN="RIGHT_HAND_Y_DOWN")
    return rr


def _same(a, b):
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


class _Out(NamedTuple):
    T_wc: object
    speed: object
    baseline_speed: object
    curr_ids: object
    match_idx: object
    match_valid: object


def _frame(rng, as_tensor):
    """One frame's host values: engine, out, img, feats."""
    n, cap = 40, 64
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(size=3)
    ids = np.where(rng.random(n) < 0.5, rng.integers(0, 30, n), -1).astype(np.int32)
    map_ids = np.where(rng.random(cap) < 0.6, np.arange(cap), -1).astype(np.int32)
    vals = dict(
        out=_Out(T, np.float32(1.5), np.float32(1.2), ids,
                 rng.integers(0, n, n).astype(np.int32), rng.random(n) < 0.7),
        kps=(rng.random((n, 2)) * 100).astype(np.float32),
        valid=rng.random(n) < 0.9,
        kf_kps=(rng.random((n, 2)) * 100).astype(np.float32),
        map_ids=map_ids,
        map_pts=rng.normal(size=(cap, 3)).astype(np.float32),
        img=rng.random((12, 16)).astype(np.float32),
        traj=[rng.normal(size=3) for _ in range(3)],
    )
    wrap = torch.as_tensor if as_tensor else (lambda x: x)
    ns = types.SimpleNamespace
    engine = ns(
        frame_id=7, trajectory=vals["traj"],
        state=ns(map=ns(ids=wrap(vals["map_ids"]), points=wrap(vals["map_pts"])),
                 keyframe=ns(kps=wrap(vals["kf_kps"]))),
    )
    feats = ns(kps=wrap(vals["kps"]), valid=wrap(vals["valid"]))
    return engine, vals["out"], wrap(vals["img"]), feats


def test_sinks_log_the_same_channels_and_arrays(monkeypatch):
    logs = []
    for sink_cls, as_tensor in ((RerunSink, True), (JaxSink, False)):
        rr = fake_rerun()
        monkeypatch.setitem(sys.modules, "rerun", rr)
        sink = sink_cls()
        assert sink.enabled
        engine, out, img, feats = _frame(np.random.default_rng(0), as_tensor)
        sink.log_frame(engine, out, img, feats)
        logs.append([c for c in rr.calls if c[0] in ("log", "set_time")])
    port, ref = logs
    paths = [c[1][0] for c in ref if c[0] == "log"]
    assert paths == ["world", "world/camera/image", "metrics/speed", "metrics/baseline",
                     "world/camera", "world/traj", "world/camera/image/landmarks",
                     "world/camera/image/candidates", "world/map", "world/camera/image/flow"]
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert _same(a, b), (a, b)


class _CountingSink:
    def __init__(self):
        self.frames = []

    def log_frame(self, engine, out, img, feats):
        # the engine after the frame: its trajectory ends at this frame's pose
        self.frames.append((engine.frame_id, np.array_equal(engine.trajectory[-1], out.T_wc[:3, 3])))


def test_engine_calls_the_sink_once_a_frame(monkeypatch):
    rng = np.random.default_rng(5)
    scene = make_scene(rng, num_frames=6, num_landmarks=1500, image_size=(640, 192))
    cfg = VOConfig(extractor_type="synthetic", max_keypoints=256, essential_hypotheses=64,
                   pnp_hypotheses=64, map_capacity=2048, min_median_flow=2.0)
    frames = [render_features(scene, f, cfg.padded_keypoints, rng=rng, device="cpu")
              for f in range(6)]

    counting = _CountingSink()
    engine = VOEngine(scene.K, cfg, viz=counting, device="cpu")
    for f in frames:
        engine.process_frame(None, feats=f)
    assert counting.frames == [(i, True) for i in range(6)]

    rr = fake_rerun()
    monkeypatch.setitem(sys.modules, "rerun", rr)
    engine = VOEngine(scene.K, cfg, viz=RerunSink(), device="cpu")
    for f in frames:
        engine.process_frame(None, feats=f)
    logged = [c[1][0] for c in rr.calls if c[0] == "log"]
    assert logged.count("metrics/speed") == 6
    for path in ("world/camera", "world/traj", "world/map", "world/camera/image/landmarks",
                 "world/camera/image/flow"):
        assert path in logged, path


def test_sink_without_rerun_warns_and_is_disabled(monkeypatch):
    monkeypatch.setitem(sys.modules, "rerun", None)
    for sink_cls in (RerunSink, JaxSink):
        with pytest.warns(UserWarning, match="rerun unavailable"):
            sink = sink_cls()
        assert not sink.enabled
        sink.log_frame(None, None, None, None)  # a no-op
