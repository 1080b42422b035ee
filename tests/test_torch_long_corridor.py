"""The long-corridor slice against the JAX package, on the CPU.

- `make_long_corridor_fixture` bit-equal to JAX's at a reduced size (24
  frames at 160 x 90, blackout 10-13): frames, ground truth, K, `blank`;
  `segment_ate` equal to JAX's on the same arrays and reset masks.
- The landmark ring: `register_landmarks` and `landmark_lookup` through
  insertions that carry `next_id` past a 64-slot capacity (one straddles
  the wrap, one has more valid entries than slots), bit for bit against
  JAX's functions, including the liveness of every id ever issued.
- The port's chunked runner with in-loop BA at the long-corridor
  configuration (chip_smoke.LONG_CFG, held equal to the JAX test's
  `_cfg`) cut to 24 frames at 320 x 180 and 256 slots with a 256-slot
  map: the ring wraps and its invariants hold on the final map.
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LONG_CFG
from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.core import state as jstate
from visualodometry_tpu.data import synthetic as jsyn
from visualodometry_tpu_torch.ba.inloop import init_window
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
from visualodometry_tpu_torch.core import state as tstate
from visualodometry_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(4)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_long_sequence_cfg() -> JaxConfig:
    """tests/test_long_sequence.py's `_cfg()`, loaded from that file."""
    spec = importlib.util.spec_from_file_location(
        "_jax_long_sequence", ROOT / "tests" / "test_long_sequence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._cfg()


def test_card_config_is_the_jax_contracts():
    want = dataclasses.asdict(_jax_long_sequence_cfg())
    got = dataclasses.asdict(config_from_dict(LONG_CFG))
    assert got == want


@pytest.fixture(scope="module")
def fixtures():
    kw = dict(num_frames=24, image_size=(160, 90), blank=(10, 13))
    return tsyn.make_long_corridor_fixture(**kw), jsyn.make_long_corridor_fixture(**kw)


def test_fixture_bit_equal_to_jax(fixtures):
    (u8_t, gt_t, K_t, b_t), (u8_j, gt_j, K_j, b_j) = fixtures
    assert u8_t.dtype == np.uint8 and u8_t.shape == (24, 90, 160)
    np.testing.assert_array_equal(u8_t, u8_j)
    np.testing.assert_array_equal(gt_t, gt_j)
    np.testing.assert_array_equal(K_t, K_j)
    assert tuple(b_t) == tuple(b_j) == (10, 13)
    assert u8_t[10:13].std() < 5 and u8_t[:10].std() > 20  # the blackout


@pytest.mark.parametrize("reset_at", [(), (11,), (11, 12), (45,), (0, 79)])
def test_segment_ate_equals_jax(reset_at):
    rng = np.random.default_rng(5)
    gt = np.cumsum(rng.normal(0, 1, (80, 3)), axis=0)
    est = 0.7 * gt + rng.normal(0, 0.2, (80, 3))
    resets = np.zeros(80, bool)
    resets[list(reset_at)] = True
    got = tsyn.segment_ate(est, gt, resets)
    want = jsyn.segment_ate(est, gt, resets)
    assert len(got) == len(want) >= 1
    for (s0, e0, a0), (s1, e1, a1) in zip(got, want):
        assert (s0, e0) == (s1, e1)
        assert a0 == pytest.approx(a1, rel=1e-6, abs=1e-9)


def _insertions():
    """(K, valid) per insertion into a 64-slot ring: below capacity, up to
    it, across the wrap, more valid entries than slots, sparse ones."""
    rng = np.random.default_rng(11)
    sizes_and_density = [(40, 0.9), (48, 0.5), (30, 1.0), (100, 0.95), (16, 0.0),
                         (64, 1.0), (9, 0.7), (128, 0.6), (3, 1.0)]
    for k, p in sizes_and_density:
        yield (rng.normal(0, 10, (k, 3)).astype(np.float32), rng.random(k) < p)


def test_ring_wrap_bit_equal_to_jax():
    m = 64
    t_map = tstate.MapState(points=torch.zeros((m, 3)), ids=torch.full((m,), -1, dtype=torch.int32),
                            next_id=torch.tensor(0, dtype=torch.int32))
    j_map = jstate.MapState(points=jnp.zeros((m, 3)), ids=jnp.full((m,), -1, jnp.int32),
                            next_id=jnp.asarray(0, jnp.int32))
    issued, straddled, overfull = [], False, False
    for pts, valid in _insertions():
        before = int(t_map.next_id)
        t_map, t_ids = tstate.register_landmarks(t_map, torch.as_tensor(pts), torch.as_tensor(valid))
        j_map, j_ids = jstate.register_landmarks(j_map, jnp.asarray(pts), jnp.asarray(valid))
        after = int(t_map.next_id)
        straddled |= before // m != (after - 1) // m and before % m != 0
        overfull |= int(valid.sum()) > m
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_map.points.numpy(), np.asarray(j_map.points))
        np.testing.assert_array_equal(t_map.ids.numpy(), np.asarray(j_map.ids))
        assert after == int(j_map.next_id) == before + int(valid.sum())
        issued += t_ids.numpy()[valid].tolist()
        # every id ever issued, and -1: live exactly where JAX says
        pids = np.asarray(issued + [-1], np.int32)
        t_pts, t_live = tstate.landmark_lookup(t_map, torch.as_tensor(pids))
        j_pts, j_live = jstate.landmark_lookup(j_map, jnp.asarray(pids))
        np.testing.assert_array_equal(t_live.numpy(), np.asarray(j_live))
        np.testing.assert_array_equal(t_pts.numpy(), np.asarray(j_pts))
        _check_ring(t_map.ids.numpy(), after, m)
    assert int(t_map.next_id) > 4 * m and straddled and overfull


def _check_ring(ids: np.ndarray, next_id: int, m: int):
    """Every live id sits in slot id % m, and none is older than next_id - m."""
    live = ids >= 0
    slots = np.flatnonzero(live)
    assert np.array_equal(ids[live] % m, slots), "a live id sits outside its slot"
    assert (ids[live] >= next_id - m).all(), "a live id is older than the ring"
    assert (ids[live] < next_id).all()


def test_chunked_runner_wraps_the_ring():
    """The port's chunked runner with in-loop BA at the long-corridor
    configuration cut in size (24 frames at 320 x 180; 256 keypoint and
    256 map slots): `next_id` passes the capacity and the final map keeps
    the ring's invariants."""
    u8, _, K, _ = tsyn.make_long_corridor_fixture(num_frames=24, image_size=(320, 180),
                                                  blank=None)
    cfg = config_from_dict(LONG_CFG).replace(
        max_keypoints=256, sift_n_features=256, map_capacity=256, ba_max_landmarks=256)
    run = make_chunked_pipeline_fn(cfg, K, device="cpu", enable_ba=True)
    carry = (init_state(cfg, desc_dim=128, device="cpu"), init_window(cfg, device="cpu"))
    resets = 0
    for i in range(0, len(u8), 8):
        carry, out = run(carry, torch.as_tensor(u8[i : i + 8]))
        resets += int(out.did_reset.sum())
        assert bool(torch.isfinite(out.T_wc).all())
    m = carry[0].map
    next_id = int(m.next_id)
    assert bool(out.initialized[-1]) and resets == 0
    assert next_id > cfg.map_capacity, next_id
    _check_ring(m.ids.numpy(), next_id, cfg.map_capacity)
    assert int((m.ids >= 0).sum()) == cfg.map_capacity  # a wrapped ring is full
    assert run.ba.solves >= 1
