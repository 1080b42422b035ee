"""The program's recorder (utils/profiling.py) and its spans in the port.

- Off (the default): a whole drive records nothing and never reaches
  `torch.profiler`.
- On, over a small rendered drive stepped frame by frame: each tracking
  frame records one call each of `step.match`, `step.read_gates`,
  `step.solve`, `step.read_flags` and `step.finish` under `step`, and one
  `sync.gates` and one `sync.flags`; the bootstrap and initialisation
  frames read as core/step.py's docstring says; self time never exceeds
  total time; `VOEngine.process_frame` adds 13 `sync.readback` a frame.
- On and off give bit-equal trajectories and outputs, through the chunked
  runner and the engine, with SIFT and with SuperPoint (float32 network).
- Under a CPU `torch.profiler` run, the `vo.*` ranges are host events.
"""

import time

import numpy as np
import pytest
import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core import (
    VOEngine,
    init_state,
    make_chunked_pipeline_fn,
    make_step_fn,
    runner,
)
from visualodometry_tpu_torch.core.step import StepParts
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
from visualodometry_tpu_torch.frontend import superpoint as tfront
from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
from visualodometry_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE = (192, 112)
FRAMES = 8
CHUNK = 4
STEP_PHASES = ("step.match", "step.read_gates", "step.solve", "step.read_flags", "step.finish")


@pytest.fixture(autouse=True)
def recorder_off():
    """The recorder is process-wide: every test starts and leaves it off
    and empty, so that no other test file sees it on."""
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _cfg(extractor="sift"):
    return VOConfig(
        extractor_type=extractor, image_size=SIZE, max_keypoints=256, sift_n_features=256,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0, min_parallax_deg=0.35,
        lowe_ratio=0.8 if extractor == "sift" else 0.92, essential_hypotheses=64,
        pnp_hypotheses=64, map_capacity=2048, seed=3,
    )


@pytest.fixture(scope="module")
def drive():
    scene = make_scene(np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    return scene.K, render_fixture_u8(scene)


def _float32_superpoint(monkeypatch):
    """SuperPoint's network in float32 wherever the port builds it."""
    batched = tfront.make_batched_superpoint_extract_fn

    def fp32_batched(cfg, *a, **k):
        return batched(cfg, *a, **dict(k, compute_dtype=torch.float32))

    monkeypatch.setattr(runner, "make_batched_superpoint_extract_fn", fp32_batched)
    monkeypatch.setattr(tfront, "make_superpoint_extractor", lambda cfg, device=None:
                        tfront.make_superpoint_extract_fn(cfg, device=device,
                                                          compute_dtype=torch.float32))


def _chunked(cfg, K, u8):
    run = make_chunked_pipeline_fn(cfg, K, device="cpu")
    state = init_state(cfg, desc_dim=256 if cfg.extractor_type == "superpoint" else 128,
                       device="cpu")
    outs = []
    for i in range(0, FRAMES, CHUNK):
        state, out = run(state, u8[i:i + CHUNK])
        outs.append([x.numpy() for x in out])
    return outs, [x.numpy() for x in state.map]


def _engine(cfg, K, u8):
    eng = VOEngine(K, cfg, device="cpu")
    outs = [list(eng.process_frame(u8[i])) for i in range(FRAMES)]
    return outs, eng.positions()


def _assert_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_off_records_nothing_and_never_reaches_the_profiler(drive, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.profiler.record_function called with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")  # one shared no-op context
    K, u8 = drive
    outs, _ = _chunked(_cfg(), K, u8)
    _engine(_cfg(), K, u8)
    profiling.count("sync.gates")
    assert profiling.summary() == {}
    assert any(o[3].any() for o in outs)  # the drive initialised


def test_nested_spans_self_time_parents_frames_and_counters():
    profiling.enable(True)
    for _ in range(3):
        with profiling.span("frame", frame=True):
            with profiling.span("inner"):
                time.sleep(0.002)
            with profiling.span("inner"):
                pass
            profiling.count("reads", 2)
    with profiling.span("after"):
        pass
    s = profiling.summary()
    assert set(s) == {"frame", "inner", "after", "reads"}
    assert s["frame"]["count"] == 3 and s["frame"]["frames"] == 3 and s["frame"]["parent"] is None
    assert s["inner"]["count"] == 6 and s["inner"]["frames"] == 3
    assert s["inner"]["parent"] == "frame" and s["after"]["frames"] == 1
    assert s["inner"]["self_s"] == s["inner"]["total_s"] >= 0.006
    assert 0 <= s["frame"]["self_s"] <= s["frame"]["total_s"] - s["inner"]["total_s"] + 1e-9
    assert s["reads"] == {"count": 6}
    profiling.enable(False)
    with profiling.span("off"):
        profiling.count("reads")
    assert profiling.summary() == s  # off keeps what was recorded, adds nothing
    profiling.reset()
    assert profiling.summary() == {}


def _flag_reads(gates):
    """Solver flag reads of a frame, by core/step.py's docstring, from its
    branch gates: bootstrap, an initialisation frame with few matches or
    low flow, and a lost frame read none; the five-point frame and a
    tracking frame read one (min_init_landmarks is 0)."""
    has_kf, initialized, few_matches, low_flow, enough_usable = gates
    if not has_kf:
        return 0
    if not initialized:
        return int(not (few_matches or low_flow))
    return int(enough_usable)


def test_step_spans_and_reads_frame_by_frame(drive):
    K, u8 = drive
    cfg = _cfg()
    extract = make_batched_extract_fn(cfg, device="cpu")
    step = make_step_fn(cfg, K, device="cpu")
    parts = StepParts(cfg, torch.as_tensor(K, dtype=torch.float32), torch.device("cpu"))
    state = init_state(cfg, desc_dim=128, device="cpu")
    feats = extract(torch.as_tensor(u8))
    profiling.enable(True)
    tracked = 0
    for f in feats:
        gates = parts.front(state, f, step.match(state.keyframe, f)).gates.tolist()
        flags = _flag_reads(gates)
        profiling.reset()
        state, out = step(state, f)
        s = profiling.summary()
        assert s["sync.gates"]["count"] == 1
        assert s.get("sync.flags", {"count": 0})["count"] == flags
        assert s["step"]["count"] == 1 and s["step"]["parent"] is None
        for name in STEP_PHASES:
            calls = flags if name in ("step.read_flags", "step.finish") else 1
            assert s.get(name, {"count": 0})["count"] == calls, name
            if calls:
                assert s[name]["parent"] == "step"
        for v in s.values():
            if "total_s" in v:
                assert 0 <= v["self_s"] <= v["total_s"]
        children = sum(s[n]["total_s"] for n in STEP_PHASES if n in s)
        assert s["step"]["self_s"] == pytest.approx(s["step"]["total_s"] - children, abs=1e-9)
        tracked += gates[1] and gates[4]
    assert tracked >= 2, "the drive must track on some frames"


def test_engine_counts_one_readback_a_field(drive):
    K, u8 = drive
    profiling.enable(True)
    eng = VOEngine(K, _cfg(), device="cpu")
    for i in range(FRAMES):
        eng.process_frame(u8[i])
    s = profiling.summary()
    assert s["sync.readback"]["count"] == 13 * FRAMES
    assert s["readback"]["count"] == FRAMES and s["readback"]["parent"] is None
    assert s["extract"]["count"] == FRAMES and s["step"]["count"] == FRAMES
    assert s["step"]["frames"] == FRAMES and s["sync.gates"]["count"] == FRAMES


@pytest.mark.parametrize("extractor", ["sift", "superpoint"])
@pytest.mark.parametrize("entry", ["chunked", "engine"])
def test_recorder_on_and_off_give_bit_equal_results(drive, monkeypatch, extractor, entry):
    if extractor == "superpoint":
        _float32_superpoint(monkeypatch)
    K, u8 = drive
    cfg = _cfg(extractor)
    run = _chunked if entry == "chunked" else _engine
    off = run(cfg, K, u8)
    profiling.enable(True)
    on = run(cfg, K, u8)
    s = profiling.summary()
    assert s["step"]["count"] == FRAMES
    assert s["extract"]["count"] == (FRAMES // CHUNK if entry == "chunked" else FRAMES)
    _assert_equal(on, off)


def test_vo_ranges_appear_under_the_cpu_profiler(drive):
    K, u8 = drive
    cfg = _cfg()
    profiling.enable(True)
    run = make_chunked_pipeline_fn(cfg, K, device="cpu")
    state = init_state(cfg, desc_dim=128, device="cpu")
    state, _ = run(state, u8[:CHUNK])  # bootstrap and initialisation
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state, u8[CHUNK:])
    names = {e.name for e in prof.events()}
    assert {"vo.extract", "vo.step", "vo.step.match", "vo.step.solve",
            "vo.step.read_gates"} <= names
